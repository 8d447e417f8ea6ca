#!/usr/bin/env python3
"""Where K4's path past 8192 groups and K1's path past 2**13 bins spend
their device time, launch by launch, on one GPU.

    python3 tools_k1_k4_profile.py               # the tree beside this file
    python3 tools_k1_k4_profile.py --tree DIR    # another unpacked tree
    python3 tools_k1_k4_profile.py k1 k4v        # some parts only

``DIR`` holds a ``tpu_radix_join_torch`` package (an unpacked ``git
archive`` of another commit, in a git-ignored directory), so two designs
are compared in one call on one card.  Each part runs in a process of its
own with a time limit, so a kernel that hangs is stopped.

  k4   ``partition_scatter`` at 20,000,000 ids moving two lanes (the inputs
       of ``chip_smoke.py`` phase (t1): a sixteenth of the ids invalid;
       the blocked shape with one hot block that clips), dense 8193,
       16,385 and 65,537 groups, blocked 16,384 x 1 clipped, grouped 4 x
       4096, and 30% of the ids in one group at 16,385: device time by
       kernel name under torch.profiler (the PyTorch operators between
       launches included), mean of 5 calls, and the event time a call;
  k1   ``histogram`` at 20,000,000 ids into 129, 256, 512, 1024, 2**12 to 2**14,
       2**15 + 1, 2**16 and 2**17 bins, random ids (and sorted, constant and
       weighted): device time of the committed kernel and of variants
       built from the tree's ``csrc/histogram.cu`` by text substitution,
       where the tree has the range tables and the source their anchor:
       ``no_flush`` skips the adds of the shared tables into the global
       table (the id loop and the zeroing alone; its counts are wrong),
       ``range_8k`` / ``range_32k`` hold 2**13 / 2**15 bins a range table
       (2**14 committed), ``range_vec4`` loads 4 x 16 bytes a thread and
       round (2 committed), ``cluster_dsmem`` is the cluster design of
       ``CLUSTER_DSMEM``;
  k4v  the MSD passes alone (``rj_partition_msd`` after K1's totals) at
       dense 16,385 and 65,537, built from the tree's
       ``csrc/partition_msd.cu`` and from variants of it by text
       substitution: ``min_blocks_4`` / ``min_blocks_3`` ask for four /
       three blocks an SM (64 / 80 registers and their spills, against
       the committed two blocks and 128 registers); each held exact
       against K4's plain version;
  ptxas the registers, shared memory and spills of the tree's K1 and K4
       kernels past their narrow paths, from ``nvcc -Xptxas -v``.

One JSON line a shape on standard output; the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

N = 20_000_000
K4_SHAPES = {   # name: groups, group size, capacity, hot share
    "dense_8193": (8193, 1, None, 0.0),
    "dense_16385": (16385, 1, None, 0.0),
    "dense_65537": (65537, 1, None, 0.0),
    "blocked_16384x1_clipped": (16384, 1, 1500, 0.0),
    "grouped_4x4096": (4 * 4096, 4096, 1 << 23, 0.0),
    "dense_16385_skewed": (16385, 1, None, 0.3),
}
K1_BINS = (129, 256, 512, 1024, 1 << 12, 1 << 13, 1 << 14, (1 << 15) + 1,
           1 << 16, 1 << 17)
#: The design the issue proposed for K1 past 2**14 bins, measured and
#: not kept: one table a cluster of 8 blocks, split into shards in their
#: shared memory, each id added into its owner's shard through distributed
#: shared memory (a shared-memory atomicAdd on a neighbouring SM), one
#: wave of clusters, the flush clusters x bins.  Appended to the source as
#: the variant ``cluster_dsmem`` with its own entry.
CLUSTER_DSMEM = r"""
namespace {
constexpr int kClusterBlocks = 8;
constexpr int kMaxShardBits = 15;

// Adds each counted lane's weight (1 unweighted) to bin id of the cluster's
// table, which lives in the shard of block id >> shard_bits at id & (2 **
// shard_bits - 1), through distributed shared memory.  A warp whose counted
// lanes share one id adds their sum once.  Every lane of the warp calls it.
template <bool kWeighted>
__device__ __forceinline__ void add_cluster(cg::cluster_group& cluster, uint32_t* shard,
                                            int shard_bits, bool counted, uint32_t id,
                                            uint32_t w) {
  const unsigned lanes = __ballot_sync(0xffffffffu, counted);
  if (lanes == 0u) return;
  const uint32_t mask = (1u << shard_bits) - 1u;
  const int first = __ffs(lanes) - 1;
  const uint32_t id0 = __shfl_sync(0xffffffffu, id, first);
  if (__all_sync(0xffffffffu, !counted || id == id0)) {
    uint32_t sum = (uint32_t)__popc(lanes);
    if (kWeighted) {
      sum = counted ? w : 0u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if ((int)(threadIdx.x & 31) == first && sum != 0u)
      atomicAdd(cluster.map_shared_rank(shard + (id0 & mask), id0 >> shard_bits), sum);
  } else if (counted && (!kWeighted || w != 0u)) {
    atomicAdd(cluster.map_shared_rank(shard + (id & mask), id >> shard_bits),
              kWeighted ? w : 1u);
  }
}

// One table a cluster: block rank r holds bins [r << shard_bits, (r + 1) <<
// shard_bits).  The loop bounds are block-uniform, as the warp votes need.
template <bool kWeighted>
__global__ void __launch_bounds__(kWideThreads)
histogram_cluster_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ weights,
                         long long n, int num_bins, int shard_bits,
                         uint32_t* __restrict__ out) {
  extern __shared__ uint32_t shard_s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int shard = 1 << shard_bits;
  for (int b = tid; b < shard; b += kWideThreads) shard_s[b] = 0u;
  cluster.sync();  // every shard is zeroed before any block adds into it
  const uint32_t bins = (uint32_t)num_bins;
  const bool aligned = ((uintptr_t)ids & 15u) == 0 &&
                       (!kWeighted || ((uintptr_t)weights & 15u) == 0);
  const long long nvec = aligned ? n / 4 : 0;
  const uint4* vid = reinterpret_cast<const uint4*>(ids);
  const uint4* vw = reinterpret_cast<const uint4*>(weights);
  const long long step = (long long)kWideThreads * kVec;
  for (long long b = (long long)blockIdx.x * step; b < nvec; b += (long long)gridDim.x * step) {
    uint4 q[kVec], wq[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long v = b + (long long)j * kWideThreads + tid;
      const bool inside = v < nvec;
      q[j] = inside ? __ldg(vid + v) : make_uint4(~0u, ~0u, ~0u, ~0u);
      wq[j] = kWeighted && inside ? __ldg(vw + v) : make_uint4(1u, 1u, 1u, 1u);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      add_cluster<kWeighted>(cluster, shard_s, shard_bits, q[j].x < bins, q[j].x, wq[j].x);
      add_cluster<kWeighted>(cluster, shard_s, shard_bits, q[j].y < bins, q[j].y, wq[j].y);
      add_cluster<kWeighted>(cluster, shard_s, shard_bits, q[j].z < bins, q[j].z, wq[j].z);
      add_cluster<kWeighted>(cluster, shard_s, shard_bits, q[j].w < bins, q[j].w, wq[j].w);
    }
  }
  for (long long b = 4 * nvec + (long long)blockIdx.x * kWideThreads; b < n;
       b += (long long)gridDim.x * kWideThreads) {
    const long long i = b + tid;
    const bool inside = i < n;
    const uint32_t id = inside ? __ldg(ids + i) : ~0u;
    const uint32_t w = kWeighted && inside ? __ldg(weights + i) : 1u;
    add_cluster<kWeighted>(cluster, shard_s, shard_bits, inside && id < bins, id, w);
  }
  cluster.sync();  // every add has landed; no shard is read or left while a target
  const long long lo = (long long)cluster.block_rank() << shard_bits;
  for (int b = tid; b < shard; b += kWideThreads) {
    const uint32_t v = shard_s[b];
    if (v != 0u) atomicAdd(out + lo + b, v);
  }
}

// The shard bits of num_bins <= kClusterMaxBins: the fewest with
// kClusterBlocks shards covering the bins.
int shard_bits_for(int num_bins) {
  int bits = 0;
  while (((long long)kClusterBlocks << bits) < num_bins) ++bits;
  return bits;
}

template <bool kWeighted>
cudaError_t launch_cluster(const uint32_t* ids, const uint32_t* weights, long long n, int num_bins,
                           uint32_t* out, cudaStream_t st) {
  auto kernel = histogram_cluster_kernel<kWeighted>;
  const int shard_bits = shard_bits_for(num_bins);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = sizeof(uint32_t) << shard_bits;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // One wave of clusters at most (the clusters the card holds at once at
  // this shard size), queried once a thread, device and size.
  struct Wave {
    int device;
    size_t smem;
    long long clusters;
  };
  static thread_local Wave cached{-1, 0, 0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (cached.device != device || cached.smem != cfg.dynamicSmemBytes) {
    // always the largest shard, so no call lowers it
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(sizeof(uint32_t) << kMaxShardBits));
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    cached = {device, cfg.dynamicSmemBytes, clusters > 0 ? clusters : 1};
  }
  const long long per_cluster = (long long)kClusterBlocks * kWideThreads * kWideItems;
  long long clusters = (n + per_cluster - 1) / per_cluster;
  if (clusters > cached.clusters) clusters = cached.clusters;
  cfg.gridDim = dim3((unsigned)(clusters * kClusterBlocks));
  err = cudaLaunchKernelEx(&cfg, kernel, ids, weights, n, num_bins, shard_bits, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}
}  // namespace

extern "C" int rj_histogram_cluster(const void* ids, const void* weights, long long n,
                                    int num_bins, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bins < 1 || num_bins > (kClusterBlocks << kMaxShardBits))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)num_bins, st);
  if (err != cudaSuccess || n <= 0) return (int)(err != cudaSuccess ? err : cudaGetLastError());
  const uint32_t* k = static_cast<const uint32_t*>(ids);
  const uint32_t* w = static_cast<const uint32_t*>(weights);
  uint32_t* o = static_cast<uint32_t*>(out);
  return (int)(w != nullptr ? launch_cluster<true>(k, w, n, num_bins, o, st)
                            : launch_cluster<false>(k, nullptr, n, num_bins, o, st));
}
"""

#: name: (the (anchor, replacement) edits of csrc/histogram.cu, the
#: entry); a variant whose anchors are not all in the source is skipped
#: ("" appends)
K1_VARIANTS = {
    "no_flush": ([("    if (v != 0u) atomicAdd(out + lo + b, v);",
                   "    if (v == 0xFFFFFFFFu) out[lo + b] = 0u;")],
                 "rj_histogram_wide"),
    "range_8k": ([("constexpr int kMaxRangeBins = 1 << 14;",
                   "constexpr int kMaxRangeBins = 1 << 13;")],
                 "rj_histogram_wide"),
    "range_32k": ([("constexpr int kMaxRangeBins = 1 << 14;",
                    "constexpr int kMaxRangeBins = 1 << 15;"),
                   ("constexpr int kMaxRanges = 8;",
                    "constexpr int kMaxRanges = 4;")],
                  "rj_histogram_wide"),
    "range_vec4": ([("constexpr int kVec = 2;", "constexpr int kVec = 4;")],
                   "rj_histogram_wide"),
    "cluster_dsmem": ([("#include <cuda_runtime.h>\n",
                        "#include <cooperative_groups.h>\n#include "
                        "<cuda_runtime.h>\nnamespace cg = cooperative_groups;\n"),
                       ("", CLUSTER_DSMEM)],
                      "rj_histogram_cluster"),
}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def tools(seed):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpu_radix_join_torch.data.tuples import narrow

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(m, hi):
        return narrow(torch.randint(0, hi, (m,), generator=gen, device=dev,
                                    dtype=torch.int64))

    def by_kernel(fn, reps=5):
        """Mean device µs a call by kernel name, and the calls a call."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = (getattr(e, "device_time_total", 0) or 0) / reps
            if us:
                out[e.key[:90]] = {"us": us, "calls": e.count / reps}
        return out

    def event_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    return dev, rand, by_kernel, event_ms


def part_k4() -> list:
    import torch
    from tpu_radix_join_torch.ops.kernels import partition as k4

    dev, rand, by_kernel, event_ms = tools(18)
    key, rid = rand(N, 1 << 32), rand(N, 1 << 32)
    fills = [0xFFFFFFFF, 0xFFFFFFFE]
    lines = []
    for name, (groups, gsize, cap, hot) in K4_SHAPES.items():
        ids = rand(N, groups + groups // 16)
        if cap is not None:
            ids = torch.where(rand(N, 2) == 0, ids % gsize, ids)
        if hot:
            ids = torch.where(rand(N, 10) < int(10 * hot), 77, ids)

        def call():
            return k4.partition_scatter(ids, [key, rid], fills,
                                        num_groups=groups, group_size=gsize,
                                        capacity=cap)

        got = call()
        want = k4.partition_scatter_plain(ids, [key, rid], fills, groups,
                                          gsize, cap)
        exact = (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                 and torch.equal(got[1], want[1]))
        del got, want
        kernels = by_kernel(call)
        lines.append({"part": "k4", "shape": name, "groups": groups,
                      "group_size": gsize, "capacity": cap, "hot": hot,
                      "exact": exact, "event_ms": event_ms(call),
                      "device_us": sum(k["us"] for k in kernels.values()),
                      "kernels": kernels})
        del ids
        torch.cuda.empty_cache()
    return lines


def part_k1() -> list:
    import torch
    from tpu_radix_join_torch.ops.kernels import _build
    from tpu_radix_join_torch.ops.kernels import histogram as k1

    dev, rand, by_kernel, event_ms = tools(19)
    src = (_build.CSRC / "histogram.cu").read_text()
    ranged = "histogram_range_kernel" in src
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = _build.BUILD_DIR / "k1_variants"
    out.mkdir(parents=True, exist_ok=True)
    fns = {}
    for name, (edits, symbol) in K1_VARIANTS.items():
        s = src
        if not ranged or not all(old in s for old, _ in edits):
            continue
        for old, new in edits:
            s = s + new if old == "" else s.replace(old, new)
        cu = out / f"histogram_{name}.cu"
        cu.write_text(s)
        so = out / f"lib{name}.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(so), str(cu)], check=True)
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[name] = fn
    lines = []
    for bins in K1_BINS:
        ids = rand(N, bins)
        w = rand(N, 1 << 32)
        srt = torch.sort(ids).values
        const = torch.full_like(ids, bins - 1)
        exact = all(torch.equal(k1.histogram(x, y, num_bins=bins),
                                k1.histogram_plain(x, y, bins))
                    for x, y in ((ids, None), (ids, w), (srt, None),
                                 (const, None)))
        line = {"part": "k1", "bins": bins, "exact": exact,
                "event_ms": event_ms(lambda: k1.histogram(ids,
                                                          num_bins=bins))}
        for kind, x, y in (("random", ids, None), ("sorted", srt, None),
                           ("constant", const, None), ("weighted", ids, w)):
            line[kind] = by_kernel(lambda: k1.histogram(x, y, num_bins=bins))
        res = torch.empty(bins, dtype=torch.int32, device=dev)
        for name, fn in fns.items():
            def variant():
                _build.check(fn(ids.data_ptr(), None, N, bins,
                                res.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream),
                             name)
            try:
                variant()
            except RuntimeError as e:   # a table this variant does not take
                line[name] = str(e)
                continue
            if name != "no_flush":
                line[f"{name}_exact"] = torch.equal(
                    res, k1.histogram_plain(ids, None, bins))
            line[name] = by_kernel(variant)
        lines.append(line)
        del ids, w, srt, const
    return lines


def part_ptxas() -> list:
    from tpu_radix_join_torch.ops.kernels import _build

    names = [n for n in ("histogram", "partition_msd", "partition_lsd")
             if n in _build.SOURCES]
    lines = []
    for name, log in _build.build(names, ptxas_verbose=True).items():
        kernel, rows = None, {}
        for l in log.splitlines():
            if "Compiling entry function" in l:
                kernel = l.split("'")[1] if "'" in l else l
            elif kernel and ("registers" in l or "spill" in l
                             or "cluster" in l.lower()):
                rows.setdefault(kernel, []).append(l.split(":", 1)[-1].strip())
        lines.append({"part": "ptxas", "source": name, "kernels": rows})
    return lines


K4_VARIANTS = {
    "committed": [],
    "min_blocks_4": [("__launch_bounds__(kThreads, kMinBlocks)",
                      "__launch_bounds__(kThreads, 4)")],
    "min_blocks_3": [("__launch_bounds__(kThreads, kMinBlocks)",
                      "__launch_bounds__(kThreads, 3)")],
}


def part_k4v() -> list:
    import torch
    from tpu_radix_join_torch.ops.kernels import _build
    from tpu_radix_join_torch.ops.kernels import histogram as k1
    from tpu_radix_join_torch.ops.kernels import partition as k4

    src_path = _build.CSRC / "partition_msd.cu"
    if not src_path.exists():
        return []
    dev, rand, by_kernel, event_ms = tools(20)
    src = src_path.read_text()
    out = _build.BUILD_DIR / "k4_msd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in K4_VARIANTS.items():
        s = src
        for old, new in edits:
            s = s.replace(old, new)
        cu = out / f"partition_msd_{name}.cu"
        cu.write_text(s)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-o", str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    key, rid = rand(N, 1 << 32), rand(N, 1 << 32)
    fills = [0xFFFFFFFF, 0xFFFFFFFE]
    inputs = {g: rand(N, g + g // 16) for g in (16385, 65537)}
    lines = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            lines.append({"part": "k4v", "variant": name, "error": log[-2000:]})
            continue
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        nbytes_fn = lib.rj_partition_msd_scratch_bytes
        nbytes_fn.restype = ctypes.c_longlong
        nbytes_fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
        fn = lib.rj_partition_msd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        line = {"part": "k4v", "variant": name,
                "spills": [l.strip() for l in log.splitlines()
                           if "spill" in l or "registers" in l]}
        for groups, ids in inputs.items():
            hist = k1.histogram(ids, num_bins=groups)
            nbytes = nbytes_fn(N, groups, 0, 2)
            scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64,
                                  device=dev)
            outs = [torch.empty(N, dtype=torch.int32, device=dev)
                    for _ in range(2)]
            p_in = (ctypes.c_void_p * 4)(key.data_ptr(), rid.data_ptr())
            p_out = (ctypes.c_void_p * 4)(*[o.data_ptr() for o in outs])
            f = (ctypes.c_uint32 * 4)(*[x & 0xFFFFFFFF for x in fills])

            def call():
                _build.check(fn(ids.data_ptr(), N, groups, 1, -1,
                                hist.data_ptr(), None, 2, p_in, p_out, f,
                                scratch.data_ptr(), nbytes,
                                torch.cuda.current_stream(dev).cuda_stream),
                             name)

            call()
            want, _ = k4.partition_scatter_plain(ids, [key, rid], fills,
                                                 groups)
            line[f"dense_{groups}_exact"] = all(
                torch.equal(a, b) for a, b in zip(outs, want))
            kern = by_kernel(call)
            line[f"dense_{groups}_us"] = sum(k["us"] for k in kern.values())
            line[f"dense_{groups}_kernels"] = {
                k[:60]: v["us"] for k, v in kern.items()}
            del want, scratch, outs
        lines.append(line)
    return lines


PARTS = {"ptxas": part_ptxas, "k1": part_k1, "k4": part_k4,
         "k4v": part_k4v}


def main() -> int:
    args = sys.argv[1:]
    tree = os.path.dirname(os.path.abspath(__file__))
    if len(args) >= 2 and args[0] == "--tree":
        tree = os.path.abspath(args[1])
        args = args[2:]
    import torch
    if not torch.cuda.is_available():
        print("tools_k1_k4_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    if len(args) == 2 and args[0] == "--part":
        for line in PARTS[args[1]]():
            print(json.dumps(line), flush=True)
        return 0
    print(card(), flush=True)
    failed = 0
    for part in args or PARTS:
        t0 = time.perf_counter()
        try:
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--tree", tree, "--part", part],
                                 capture_output=True, text=True, timeout=420)
            print(run.stdout, end="", flush=True)
            if run.returncode != 0:
                failed += 1
                print(json.dumps({"part": part, "error":
                                  run.stderr[-3000:]}), flush=True)
        except subprocess.TimeoutExpired:
            failed += 1
            print(json.dumps({"part": part, "error": "timeout"}), flush=True)
        print(json.dumps({"part": part, "tree": tree,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
