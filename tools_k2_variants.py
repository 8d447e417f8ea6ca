#!/usr/bin/env python3
"""Design variants of K2's onesweep pass, built side by side and timed on one GPU.

    python3 tools_k2_variants.py            # needs one CUDA device

Each variant is ``tpu_radix_join_torch/csrc/radix_sort.cu`` with one design
choice changed by text substitution:

  committed     the warp match by atomicOr, kMinBlocks 3, kLookBack 8
  ballot_match  the warp match built from eight __ballot_sync
  hw_match      the warp match by __match_any_sync
  two_chains    items j and j + kItems / 2 ranked as two interleaved
                chains, with 16-bit counters two to a word
  fence_acquire the look-back words published after __threadfence() and
                read with ld.acquire
  min_blocks_2  no register cap below 128 (two blocks an SM)
  min_blocks_4  at most 64 registers (four blocks an SM)
  lookback_1    the look-back reads one word at a time
  spin_single   a thread waiting in the look-back rereads the nearest
                unpublished word alone, not kLookBack words every try
  stamped       the committed pass with clock64() stamps at its phase
                boundaries, read back after a one-pass sort

Every variant is built with ``nvcc -Xptxas -v`` (its registers, shared
memory and spills are printed), held bit-exact against the plain sort, and
timed with CUDA events (median of 10) at (a)'s shape, 40,000,000 random
keys in one lane (4 passes), and at a 40,000,000-row three-lane sort on two
keys (8 passes), beside ``torch.sort`` of the same keys.  One JSON line a
variant on standard output; the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

RANK_START = "  // rank item by item:"
RANK_END = "  // decoupled look-back"
MATCH_OR = """    uint32_t* word = &lanes_of[j & 1][warp][d];
    if (valid) atomicOr(word, 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? *word : 0u;
    const int leader = __ffs(peers) - 1;
    __syncwarp();
"""
# the other warp matches; the leading __syncwarp orders the previous
# item's counter update before this item's
MATCHES = {
    "ballot_match": """    __syncwarp();
    const unsigned valid_lanes = full ? 0xffffffffu : __ballot_sync(0xffffffffu, valid);
    unsigned peers = valid ? valid_lanes : 0u;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned bit = (d >> b) & 1u;
      const unsigned ones = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? ones : ~ones;
    }
    const int leader = __ffs(peers) - 1;
""",
    "hw_match": """    __syncwarp();
    const unsigned valid_lanes = full ? 0xffffffffu : __ballot_sync(0xffffffffu, valid);
    const unsigned same = __match_any_sync(0xffffffffu, d);  // every lane calls it
    const unsigned peers = valid ? same & valid_lanes : 0u;
    const int leader = __ffs(peers) - 1;
""",
}

TWO_CHAIN_RANK = """  // rank item by item, items j and j + kHalf as two interleaved chains
  uint32_t info[kItems];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    uint32_t d[2], peers[2], next[2] = {0u, 0u};
    int leader[2];
    bool valid[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int item = j + c * kHalf;
      valid[c] = full || warp_start + 32 * item + lane < n;
      d[c] = (key[item] >> shift) & 0xFFu;
      if (valid[c]) atomicOr(&lanes_of[c][warp][d[c]], 1u << lane);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      peers[c] = valid[c] ? lanes_of[c][warp][d[c]] : 0u;
      leader[c] = __ffs(peers[c]) - 1;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (lane == leader[c]) {
        const uint32_t old = atomicAdd(&counter[d[c]], (uint32_t)__popc(peers[c]) << (16 * c));
        next[c] = (old >> (16 * c)) & 0xFFFFu;
        lanes_of[c][warp][d[c]] = 0u;
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int item = j + c * kHalf;
      const uint32_t slot = __shfl_sync(0xffffffffu, next[c], leader[c]) +
                            (uint32_t)__popc(peers[c] & lanemask_lt);
      if (valid[c]) {
        if (!kSlots) stage[slot] = key[item];
        info[item] = (d[c] << kSlotBits) | slot;
      } else {
        info[item] = kInvalid;
      }
    }
  }

"""

STAMPS = 10
PHASES = ["tile_atomic", "key_loads_issued_scan1", "key_arrival",
          "early_counts", "publish_scan2", "rank", "lookback",
          "key_scatter"]


def sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise ValueError(f"anchor not in radix_sort.cu: {old[:60]!r}")
    return s.replace(old, new, 1)


def match(kind: str):
    def f(s: str) -> str:
        return sub(sub(s, MATCH_OR, MATCHES[kind]), "      *word = 0u;\n", "")
    return f


def two_chains(s: str) -> str:
    s = sub(s, "constexpr int kWarpKeys = 32 * kItems;\n",
            "constexpr int kWarpKeys = 32 * kItems;\nconstexpr int kHalf = kItems / 2;\n")
    s = sub(s, "atomicAdd(counter + ((key[j] >> shift) & 0xFFu), 1u);",
            "atomicAdd(counter + ((key[j] >> shift) & 0xFFu), j < kHalf ? 1u : 1u << 16);")
    s = sub(s, """    warp_base[w][tid] = count;
    count += c;""", """    const uint32_t first = c & 0xFFFFu;
    warp_base[w][tid] = count | ((count + first) << 16);
    count += first + (c >> 16);""")
    s = sub(s, "warp_base[w][tid] += digit_start;",
            "warp_base[w][tid] += digit_start * 0x10001u;")
    i, j = s.index(RANK_START), s.index(RANK_END)
    return s[:i] + TWO_CHAIN_RANK + s[j:]


def fence_acquire(s: str) -> str:
    s = sub(s, "ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64")
    return sub(s, '  asm volatile("st.relaxed.gpu.global.u64',
               '  __threadfence();\n  asm volatile("st.relaxed.gpu.global.u64')


def spin_single(s: str) -> str:
    return sub(s, """#pragma unroll
      for (int k = 0; k < kLookBack; ++k)""", """      w[0] = load_word(lookback + t * kRadix + tid);
      if ((uint32_t)(w[0] >> 34) != epoch) continue;  // not published yet
#pragma unroll
      for (int k = 1; k < kLookBack; ++k)""")


def constant(name: str, value: int):
    def f(s: str) -> str:
        line = next(l for l in s.splitlines()
                    if l.startswith(f"constexpr int {name} = "))
        return sub(s, line, f"constexpr int {name} = {value};")
    return f


def stamped(s: str) -> str:
    """clock64() at the phase boundaries of thread 0, ten words a tile."""
    s = sub(s, "namespace {\n", "namespace {\n__device__ long long g_stamps"
            f"[(1 << 17) * {STAMPS}];\n")
    s = sub(s, "  if (tid == 0) tile_shared = atomicAdd(tile_counter, 1u);",
            "  const long long t0 = clock64();\n"
            "  if (tid == 0) tile_shared = atomicAdd(tile_counter, 1u);")
    s = sub(s, "  const uint32_t tile = tile_shared;\n",
            "  const uint32_t tile = tile_shared;\n"
            "  const long long t1 = clock64();\n")
    s = sub(s, "  // each warp's digit counts first",
            "  const long long t2 = clock64();\n  uint32_t acc = 0u;\n"
            "#pragma unroll\n  for (int j = 0; j < kItems; ++j) acc ^= key[j];\n"
            "  if (acc == 0x9E3779B9u && tid > 100000) stage[0] = acc;\n"
            "  const long long t3 = clock64();\n"
            "  // each warp's digit counts first")
    s = sub(s, "  __syncthreads();\n\n  // each digit's count in the tile",
            "  __syncthreads();\n  const long long t4 = clock64();\n\n"
            "  // each digit's count in the tile")
    s = sub(s, RANK_START, "  const long long t5 = clock64();\n" + RANK_START)
    s = sub(s, RANK_END, "  const long long t6 = clock64();\n" + RANK_END)
    s = sub(s, "  __syncthreads();\n\n  constexpr uint32_t kSlotMask",
            "  __syncthreads();\n  const long long t7 = clock64();\n\n"
            "  constexpr uint32_t kSlotMask")
    s = sub(s, "  // every other lane the same way, through the same stage",
            "  __syncthreads();\n  if (tid == 0) {\n    unsigned sm;\n"
            "    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
            f"    long long* g = g_stamps + (long long)tile * {STAMPS};\n"
            "    g[0] = t0; g[1] = t1; g[2] = t2; g[3] = t3; g[4] = t4;\n"
            "    g[5] = t5; g[6] = t6; g[7] = t7; g[8] = clock64(); g[9] = sm;\n"
            "  }\n  // every other lane the same way, through the same stage")
    s = sub(s, 'extern "C" {\n', 'extern "C" {\n'
            "int rj_debug_stamps(void* dst, long long count) {\n"
            "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, count * 8);\n}\n")
    return s


VARIANTS = {
    "committed": [],
    "ballot_match": [match("ballot_match")],
    "hw_match": [match("hw_match")],
    "two_chains": [two_chains],
    "fence_acquire": [fence_acquire],
    "min_blocks_2": [constant("kMinBlocks", 2)],
    "min_blocks_4": [constant("kMinBlocks", 4)],
    "lookback_1": [constant("kLookBack", 1)],
    "spin_single": [spin_single],
    "stamped": [stamped],
}


def measure(name: str) -> dict:
    """Check and time the built variant ``name`` (run in a child process)."""
    import torch
    from tpu_radix_join_torch.data.tuples import narrow
    from tpu_radix_join_torch.ops.kernels import _build
    from tpu_radix_join_torch.ops.kernels import radix_sort as k2

    lib = ctypes.CDLL(str(_build.BUILD_DIR / "variants" / f"lib{name}.so"))
    _build._loaded["radix_sort"] = lib
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(20240601)

    def lane(n, hi=1 << 32):
        return narrow(torch.randint(0, hi, (n,), generator=gen)).to(dev)

    def time_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    n = 40_000_000
    x = lane(n)
    three = [x, lane(n), lane(n)]
    ok = torch.equal(k2.radix_sort([x])[0], k2.radix_sort_plain([x])[0])
    for m in (1, 4095, 4097, 12305, 1000003):
        for hi in (1 << 32, 7):
            pair = [lane(m, hi), lane(m)]
            ok &= all(torch.equal(g, r) for g, r in zip(
                k2.radix_sort(pair), k2.radix_sort_plain(pair)))
    if not ok:
        raise AssertionError(f"variant {name} differs from the plain sort")
    signed = torch.bitwise_xor(x, -(1 << 31))
    res = {"variant": name, "exact": True,
           "k2_a_ms": time_ms(lambda: k2.radix_sort([x])),
           "k2_3lane_8pass_ms": time_ms(
               lambda: k2.radix_sort(three, num_keys=2)),
           "histogram_a_ms": time_ms(lambda: k2.radix_histograms([x])),
           "torch_sort_ms": time_ms(lambda: torch.sort(signed))}
    if name == "stamped":
        k2.radix_sort([x], key_bounds=(256,))     # one pass
        torch.cuda.synchronize()
        tiles = k2.scratch_layout(n, 1).tiles
        buf = (ctypes.c_longlong * (tiles * STAMPS))()
        _build.check(lib.rj_debug_stamps(buf, tiles * STAMPS), "stamps")
        rows = [buf[t * STAMPS:(t + 1) * STAMPS] for t in range(tiles)]
        res["pass_cycles_mean"] = {
            p: statistics.mean(r[i + 1] - r[i] for r in rows)
            for i, p in enumerate(PHASES)}
        res["block_cycles_mean"] = statistics.mean(r[8] - r[0] for r in rows)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tools_k2_variants: torch.cuda.is_available() is false",
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
    src = (_build.CSRC / "radix_sort.cu").read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        s = src
        for edit in edits:
            s = edit(s)
        cu = out / f"radix_sort_{name}.cu"
        cu.write_text(s)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(_build.CSRC), "-o", str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    failed = 0
    for name, proc in procs.items():
        log, _ = proc.communicate()
        ptxas = [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l]
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "error": "nvcc", "log": log}),
                  flush=True)
            failed += 1
            continue
        # each variant in a process of its own, so one that hangs is stopped
        try:
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--measure", name], capture_output=True,
                                 text=True, timeout=180)
            line = run.stdout.strip().splitlines()[-1] if run.returncode == 0 \
                else json.dumps({"variant": name, "error": run.stderr[-2000:]})
        except subprocess.TimeoutExpired:
            line = json.dumps({"variant": name, "error": "timeout"})
        res = json.loads(line)
        failed += "error" in res
        print(json.dumps({**res, "ptxas": ptxas}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
