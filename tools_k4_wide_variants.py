#!/usr/bin/env python3
"""Design variants of K4's wide grouping kernel, built side by side and timed
on one GPU.

    python3 tools_k4_wide_variants.py        # needs one CUDA device

Each variant is ``tpu_radix_join_torch/csrc/partition_wide.cu`` with one
design choice changed by text substitution:

  committed      per-warp counters of 8-bit digits, the lanes of one digit
                 found by a ballot a digit bit; 512 threads x 16 ids, at
                 most 64 registers (two blocks an SM)
  atomic_or      the lanes of one digit gather in a shared word by atomicOr
                 (K2's and the narrow K4's warp match), unless the warp's
                 digits are all one
  hw_match       the lanes of one digit from __match_any_sync
  raking         the tile sort as passes of 5-bit digits, each thread
                 counting 16 consecutive words into its own column of
                 16-bit counters, scanned digit-major, thread-minor
  bases_late     each group's base loaded after the sort, by the thread
                 that holds the group's first sorted id (the kernel's first
                 design): scattered loads, one round trip after another
  prefetch_lane  each lane's loads issued before the previous lane is
                 written (the first right after the sort)
  min_blocks_1   no register cap below 128 (one block an SM)
  tile_4096      512 threads x 8 ids a tile, eight tiles a count chunk
  stamped        the committed kernel with clock64() stamps of thread 0 at
                 the sweep's phase boundaries, read back after one call

Every variant is built with ``nvcc -Xptxas -v`` (its registers, shared
memory and spills are printed), called through its own C entry (so a
variant may size its scratch otherwise), held bit-exact against K4's plain
version (slots, two moved lanes with their fills, the totals) at 20M ids
and at tile edges, and timed by device time (torch.profiler, the sum of its
launches, mean of 10) at 20,000,000 ids moving two lanes, the shapes of
``chip_smoke.py`` phase (t1): dense 257, 1025 and 4097 groups, grouped 16 x
32 and 4 x 256 groups at 2**23 slots a block (clipped), dense 1025 in slots
mode and on sorted ids.  The committed kernel runs first and last, so the
drift within the call shows.  One JSON line a variant on standard output;
the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

STAMPS = 10
PHASES = ["load_and_pass0", "pass1", "bases", "destinations", "lane0",
          "lane1", "rest"]


def sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise ValueError(f"anchor not in partition_wide.cu: {old[:60]!r}")
    return s.replace(old, new, 1)


def constant(name: str, value: int):
    def f(s: str) -> str:
        line = next(l for l in s.splitlines()
                    if l.startswith(f"constexpr int {name} = "))
        return sub(s, line, f"constexpr int {name} = {value};")
    return f


PEERS_BALLOT = """  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool one = (d >> b) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, one);
    peers &= one ? m : ~m;
  }
  return peers;
"""


def atomic_or(s: str) -> str:
    s = sub(s, PEERS_BALLOT, """  __shared__ uint32_t masks[kWarps][kBins];
  const int lane = threadIdx.x & 31;
  uint32_t* mask = masks[threadIdx.x >> 5];
  if (bits < 0) {  // zero the warp's words once a tile
    for (int k = lane; k < kBins; k += 32) mask[k] = 0u;
    __syncwarp();
    return 0u;
  }
  const uint32_t d0 = __shfl_sync(0xffffffffu, d, 0);
  if (__all_sync(0xffffffffu, d == d0)) return 0xffffffffu;
  atomicOr(mask + d, 1u << lane);
  __syncwarp();
  const unsigned peers = mask[d];
  __syncwarp();
  if (lane == __ffs(peers) - 1) mask[d] = 0u;
  __syncwarp();
  return peers;
""")
    return sub(s, "    const int high_bits =",
               "    digit_peers(0u, -1);\n    const int high_bits =")


def hw_match(s: str) -> str:
    return sub(s, PEERS_BALLOT, "  return __match_any_sync(0xffffffffu, d);\n")


RAKING_PASS = """__device__ __forceinline__ void rake_pass(const uint32_t (&w)[kItems], int shift,
                                          uint32_t* stage, uint16_t* count) {
  constexpr int kRakeBins = 32;
  constexpr int kWords = kRakeBins * kThreads / 2;
  constexpr int kMine = kRakeBins / 2;
  const int tid = threadIdx.x;
  uint32_t* words = reinterpret_cast<uint32_t*>(count);
#pragma unroll
  for (int k = 0; k < kWords / kThreads; ++k) words[k * kThreads + tid] = 0u;
  __syncthreads();
  uint32_t before[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    uint16_t* c = count + ((w[j] >> shift) & (kRakeBins - 1u)) * kThreads + tid;
    before[j] = *c;
    *c = (uint16_t)(before[j] + 1u);
  }
  __syncthreads();
  {
    uint4* mine = reinterpret_cast<uint4*>(words + tid * kMine);
    uint4 q[kMine / 4];
    uint32_t sum = 0u;
#pragma unroll
    for (int k = 0; k < kMine / 4; ++k) {
      q[k] = mine[k];
      sum += (q[k].x & 0xFFFFu) + (q[k].x >> 16) + (q[k].y & 0xFFFFu) + (q[k].y >> 16) +
             (q[k].z & 0xFFFFu) + (q[k].z >> 16) + (q[k].w & 0xFFFFu) + (q[k].w >> 16);
    }
    __shared__ uint32_t rake_scratch[kThreads / 32];
    uint32_t run = rj::block_exclusive_scan<kThreads>(sum, 0u, rj::SumOp(), rake_scratch,
                                                      (uint32_t*)nullptr);
    auto rewrite = [&run](uint32_t x) {
      const uint32_t lo = run;
      run += x & 0xFFFFu;
      const uint32_t hi = run;
      run += x >> 16;
      return lo | (hi << 16);
    };
#pragma unroll
    for (int k = 0; k < kMine / 4; ++k) {
      q[k].x = rewrite(q[k].x);
      q[k].y = rewrite(q[k].y);
      q[k].z = rewrite(q[k].z);
      q[k].w = rewrite(q[k].w);
      mine[k] = q[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = (w[j] >> shift) & (kRakeBins - 1u);
    stage[count[d * kThreads + tid] + before[j]] = w[j];
  }
  __syncthreads();
}

"""

COMMITTED_SORT = """      w[j] = ((w[j] < groups ? w[j] : groups) << kIndexBits) | k;
    }
    const int high_bits = 32 - __clz((int)(groups >> kDigitBits));  // 0 below 256 groups
    digit_pass(w, kIndexBits, kDigitBits, stage, count);
#pragma unroll
    for (int j = 0; j < kItems; ++j) w[j] = stage[(warp * kItems + j) * 32 + lane];
    __syncthreads();  // every word is read before the pass rewrites the stage
    digit_pass(w, kIndexBits + kDigitBits, high_bits, stage, count);
"""

RAKING_SORT = """      stage[k] = ((w[j] < groups ? w[j] : groups) << kIndexBits) | k;
    }
    const int passes = (32 - __clz((int)groups) + 4) / 5;
    uint16_t* count16 = reinterpret_cast<uint16_t*>(smem + kStageBytes);
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kItems; ++j) w[j] = stage[tid * kItems + j];
      rake_pass(w, kIndexBits + p * 5, stage, count16);
    }
"""


def raking(s: str) -> str:
    s = sub(s, "constexpr int kUnionBytes = 4 * kBins * kWarps;",
            "constexpr int kUnionBytes = 2 * 32 * kThreads;")
    s = sub(s, "// capacity < 0 selects dense mode.  kSlots:",
            RAKING_PASS + "// capacity < 0 selects dense mode.  kSlots:")
    return sub(s, COMMITTED_SORT, RAKING_SORT)


def prefetch_lane(s: str) -> str:
    s = sub(s, """#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int s = r * kThreads + tid;
      word[r] = stage[s];""", """#pragma unroll
    for (int r = 0; r < kItems; ++r) word[r] = stage[r * kThreads + tid];
    uint32_t v[kItems];
    if (!kSlots) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const long long i = tile_start + (long long)r * kThreads + tid;
        v[r] = (full || i < n) ? __ldg(lanes.in[0] + i) : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int s = r * kThreads + tid;""")
    return sub(s, """      const uint32_t* in = lanes.in[l];
      uint32_t* out = lanes.out[l];
      uint32_t v[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const long long i = tile_start + (long long)r * kThreads + tid;
        v[r] = (full || i < n) ? __ldg(in + i) : 0u;
      }
#pragma unroll
      for (int r = 0; r < kItems; ++r) stage[inverse[r * kThreads + tid]] = v[r];
""", """      uint32_t* out = lanes.out[l];
#pragma unroll
      for (int r = 0; r < kItems; ++r) stage[inverse[r * kThreads + tid]] = v[r];
      if (l + 1 < num_lanes) {
#pragma unroll
        for (int r = 0; r < kItems; ++r) {
          const long long i = tile_start + (long long)r * kThreads + tid;
          v[r] = (full || i < n) ? __ldg(lanes.in[l + 1] + i) : 0u;
        }
      }
""")


def bases_late(s: str) -> str:
    s = sub(s, """#pragma unroll 4
    for (int g = tid; g < num_groups; g += kThreads) {
      const uint32_t lead = dense ? 0u : starts[(g / group_size) * group_size];
      base[g] = starts[g] + chunk_words[chunk * num_groups + g] +
                (uint32_t)rows[tile * num_groups + g] - lead;
    }
""", "")
    return sub(s, "if (g < groups && (s == 0 || (stage[s - 1] >> kIndexBits) != g)) "
                  "base[g] -= (uint32_t)s;", """if (g < groups && (s == 0 || (stage[s - 1] >> kIndexBits) != g)) {
        const uint32_t lead = dense ? 0u : starts[(g / (uint32_t)group_size) * group_size];
        base[g] = starts[g] + chunk_words[chunk * num_groups + g] +
                  (uint32_t)rows[tile * num_groups + g] - (uint32_t)s - lead;
      }""")


def min_blocks_1(s: str) -> str:
    return sub(s, "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")


def tile_4096(s: str) -> str:
    for edit in (constant("kItems", 8), constant("kIndexBits", 12),
                 constant("kChunk", 8)):
        s = edit(s)
    return s


def stamped(s: str) -> str:
    """clock64() of thread 0 at the sweep's phase boundaries, after the
    barrier that closes each phase; the SM id last."""
    s = sub(s, "namespace {\n", "namespace {\n__device__ long long g_stamps"
            f"[(1 << 13) * {STAMPS}];\n"
            "__device__ __forceinline__ void stamp(long long tile, int k) {\n"
            "  if (threadIdx.x == 0 && tile < (1 << 13)) "
            f"g_stamps[tile * {STAMPS} + k] = clock64();\n}}\n")
    s = sub(s, "  if (tile < tiles) {  // block-uniform\n",
            "  if (tile < tiles) {  // block-uniform\n    stamp(tile, 0);\n")
    s = sub(s, "#pragma unroll\n    for (int j = 0; j < kItems; ++j) w[j] = "
               "stage[(warp * kItems + j) * 32 + lane];\n",
            "    stamp(tile, 1);\n#pragma unroll\n    for (int j = 0; j < kItems; "
            "++j) w[j] = stage[(warp * kItems + j) * 32 + lane];\n")
    s = sub(s, "    // the stage holds (group, local index) sorted;",
            "    stamp(tile, 2);\n    // the stage holds (group, local index) sorted;")
    s = sub(s, "    __syncthreads();  // the bases are final, the stage is read\n",
            "    __syncthreads();  // the bases are final, the stage is read\n"
            "    stamp(tile, 3);\n")
    s = sub(s, "    __syncthreads();\n    if (kSlots) {\n",
            "    __syncthreads();\n    stamp(tile, 4);\n    if (kSlots) {\n")
    s = sub(s, "      __syncthreads();  // the stage is read before the next lane\n",
            "      __syncthreads();  // the stage is read before the next lane\n"
            "      if (l < 2) stamp(tile, 5 + l);\n")
    s = sub(s, "  }\n  if (kSlots) return;\n",
            "    stamp(tile, 7);\n    if (threadIdx.x == 0 && tile < (1 << 13)) {\n"
            "      unsigned sm;\n      asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
            f"      g_stamps[tile * {STAMPS} + 9] = sm;\n    }}\n"
            "  }\n  if (kSlots) return;\n")
    return sub(s, 'extern "C" {\n', 'extern "C" {\n'
               "int rj_debug_stamps(void* dst, long long count) {\n"
               "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, count * 8);\n}\n")


VARIANTS = {
    "committed": [],
    "atomic_or": [atomic_or],
    "hw_match": [hw_match],
    "raking": [raking],
    "bases_late": [bases_late],
    "prefetch_lane": [prefetch_lane],
    "min_blocks_1": [min_blocks_1],
    "tile_4096": [tile_4096],
    "stamped": [stamped],
    "committed_again": [],
}


def measure(name: str) -> dict:
    """Check and time the built variant ``name`` (run in a child process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpu_radix_join_torch.data.tuples import narrow
    from tpu_radix_join_torch.ops.kernels import _build
    from tpu_radix_join_torch.ops.kernels import partition as k4

    lib = ctypes.CDLL(str(_build.BUILD_DIR / "k4_variants" / f"lib{name}.so"))
    lib.rj_partition_wide_scratch_bytes.restype = ctypes.c_longlong
    lib.rj_partition_wide_scratch_bytes.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    lib.rj_partition_wide.restype = ctypes.c_int
    lib.rj_partition_wide.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)

    def rand(m, hi):
        return narrow(torch.randint(0, hi, (m,), generator=gen, device=dev,
                                    dtype=torch.int64))

    def group(ids, groups, gsize, cap, lanes, fills, with_slots):
        """One call of the variant: (slots or None, outs, hist)."""
        n = ids.numel()
        c = -1 if cap is None else cap
        nbytes = lib.rj_partition_wide_scratch_bytes(n, groups, gsize, c)
        scratch = torch.empty(nbytes // 8, dtype=torch.int64, device=dev)
        size = k4.out_size(n, groups, gsize, cap)
        slots = (torch.empty(n, dtype=torch.int32, device=dev) if with_slots
                 else None)
        outs = [torch.empty(size, dtype=torch.int32, device=dev)
                for _ in lanes]
        p_in = (ctypes.c_void_p * 4)(*[a.data_ptr() for a in lanes])
        p_out = (ctypes.c_void_p * 4)(*[a.data_ptr() for a in outs])
        f = (ctypes.c_uint32 * 4)(*[x & 0xFFFFFFFF for x in fills])
        _build.check(lib.rj_partition_wide(
            ids.data_ptr(), n, groups, gsize, c,
            slots.data_ptr() if with_slots else None, len(lanes), p_in, p_out,
            f, scratch.data_ptr(), nbytes,
            torch.cuda.current_stream(dev).cuda_stream), name)
        regions = 1 if cap is None else groups // gsize
        at = (-(-8 * (regions + 1) // 8) * 8 + -(-4 * (groups + 1) // 8) * 8) // 4
        return slots, outs, scratch.view(torch.int32)[at:at + groups]

    def device_us(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum((getattr(e, "device_time_total", 0) or 0) / reps
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    n = 20_000_000
    key, rid = rand(n, 1 << 32), rand(n, 1 << 32)
    fills = [0xFFFFFFFF, 0xFFFFFFFE]
    shapes = {"dense_257": (257, 1, None), "dense_1025": (1025, 1, None),
              "dense_4097": (4097, 1, None),
              "grouped_16x32": (16 * 32, 32, 1 << 23),
              "grouped_4x256": (4 * 256, 256, 1 << 23)}
    inputs = {}
    for shape, (groups, gsize, cap) in shapes.items():
        ids = rand(n, groups + groups // 16)
        if cap is not None:
            ids = torch.where(rand(n, 2) == 0, ids % gsize, ids)
        inputs[shape] = ids
    ok = True

    def check(ids, groups, gsize, cap):
        m = ids.numel()
        slots, _, hist = group(ids, groups, gsize, cap, [], [], True)
        _, outs, hist2 = group(ids, groups, gsize, cap, [key[:m], rid[:m]],
                               fills, False)
        want_s, want_h = k4.partition_slots_plain(ids, groups, gsize, cap)
        want_o, _ = k4.partition_scatter_plain(ids, [key[:m], rid[:m]], fills,
                                               groups, gsize, cap)
        return (torch.equal(slots, want_s) and torch.equal(hist, want_h)
                and torch.equal(hist2, want_h)
                and all(torch.equal(a, b) for a, b in zip(outs, want_o)))

    for shape in ("dense_1025", "grouped_16x32"):
        ok &= check(inputs[shape], *shapes[shape])
    for m in (1, 4095, 8191, 8193, 32769, 100003):
        ok &= check(rand(m, 4097 + 256), 4097, 1, None)
        ok &= check(rand(m, 1024), 1024, 32, 3)
    if not ok:
        raise AssertionError(f"variant {name} differs from the plain K4")
    res = {"variant": name, "exact": True}
    for shape, (groups, gsize, cap) in shapes.items():
        ids = inputs[shape]
        res[f"{shape}_us"] = device_us(lambda: group(
            ids, groups, gsize, cap, [key, rid], fills, False))
    ids = inputs["dense_1025"]
    res["dense_1025_slots_us"] = device_us(
        lambda: group(ids, 1025, 1, None, [], [], True))
    srt = torch.sort(ids).values
    res["dense_1025_sorted_us"] = device_us(
        lambda: group(srt, 1025, 1, None, [key, rid], fills, False))
    if name == "stamped":
        group(ids, 1025, 1, None, [key, rid], fills, False)
        torch.cuda.synchronize()
        tiles = min(1 << 13, -(-n // k4.WIDE_TILE_IDS))
        buf = (ctypes.c_longlong * (tiles * STAMPS))()
        _build.check(lib.rj_debug_stamps(buf, tiles * STAMPS), "stamps")
        rows = [buf[t * STAMPS:(t + 1) * STAMPS] for t in range(tiles)]
        res["dense_1025_phase_cycles_mean"] = {
            p: statistics.mean(r[i + 1] - r[i] for r in rows)
            for i, p in enumerate(PHASES[:-1])}
        res["dense_1025_tile_cycles_mean"] = statistics.mean(
            r[7] - r[0] for r in rows)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tools_k4_wide_variants: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    from tpu_radix_join_torch.ops.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    src = (_build.CSRC / "partition_wide.cu").read_text()
    out = _build.BUILD_DIR / "k4_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        s = src
        for edit in edits:
            s = edit(s)
        cu = out / f"partition_wide_{name}.cu"
        cu.write_text(s)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(_build.CSRC), "-o", str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    failed = 0
    for name, proc in procs.items():
        log, _ = proc.communicate()
        ptxas, kernel = {}, None
        for l in log.splitlines():
            if "Compiling entry function" in l:
                kernel = next((k for k in ("count", "carry", "starts",
                                           "sweep_kernelILb1",
                                           "sweep_kernelILb0") if k in l), l)
            elif kernel and ("registers" in l or "spill" in l):
                ptxas.setdefault(kernel, []).append(l.split(":")[-1].strip())
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "error": "nvcc", "log": log}),
                  flush=True)
            failed += 1
            continue
        # each variant in a process of its own, so one that hangs is stopped
        try:
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--measure", name], capture_output=True,
                                 text=True, timeout=240)
            line = run.stdout.strip().splitlines()[-1] if run.returncode == 0 \
                else json.dumps({"variant": name, "error": run.stderr[-2000:]})
        except subprocess.TimeoutExpired:
            line = json.dumps({"variant": name, "error": "timeout"})
        res = json.loads(line)
        failed += "error" in res
        print(json.dumps({**res, "ptxas": {k: v for k, v in ptxas.items()
                                           if k.startswith("sweep")}}),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
