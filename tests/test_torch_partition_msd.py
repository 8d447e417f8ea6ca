"""K1's range tables and K4's MSD passes past 8192 groups: what the CPU
can hold of their CUDA sources.

  * K1 (``csrc/histogram.cu``): the table that ``num_bins`` alone picks
    (``wide_table``) and the entry and counter the wrapper then takes, with
    the kernel call stubbed; the range design emulated (a block for each
    range of the bins and chunk of the ids, 16-byte loads then a tail, an
    id added as its offset in the range, a warp whose counted ids share
    one bin adding once, each block's table flushed) against
    ``histogram_plain``, counts and wrapping uint32 weight sums; the
    constants against the source;
  * K4 (``csrc/partition_msd.cu``): ``msd_plan``'s digits (every group id
    covered, at most 8 bits a pass, the earlier passes the fewer) up to
    2**31 - 1 groups, and the constants against the source.  The passes
    themselves are emulated tile by tile in
    ``tests/test_torch_wide_fanout_kernels.py`` (``_msd_emulation``).
Tolerance 0 everywhere."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops import kernels  # noqa: E402
from tpu_radix_join_torch.ops.kernels import histogram as k1  # noqa: E402
from tpu_radix_join_torch.ops.kernels import partition as k4  # noqa: E402

CSRC = Path(k1.__file__).resolve().parents[2] / "csrc"
ONES = 0xFFFFFFFF


def _const(src, name):
    expr = re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);",
                     src).group(1)
    expr = re.sub(r"\(long long\)", "", expr)
    for other in re.findall(r"\bk\w+", expr):
        expr = expr.replace(other, str(_const(src, other)))
    return int(eval(expr, {}))


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("bins,table", [
    (1, None), (k1.MAX_BINS, None), (k1.MAX_BINS + 1, "range"),
    (1024, "range"), (1 << 14, "range"), ((1 << 15) + 1, "range"),
    (1 << 17, "range"), (k1.RANGE_MAX_BINS, "range"),
    (k1.RANGE_MAX_BINS + 1, "global")])
def test_the_bin_count_alone_picks_k1s_path(monkeypatch, bins, table):
    """The wrapper calls ``rj_histogram`` up to 128 bins and
    ``rj_histogram_wide`` past them (counted as ``histogram`` and
    ``histogram_wide``), which picks its table by ``num_bins`` alone:
    ``wide_table`` mirrors that choice from the kernel's constants."""
    if table is not None:
        assert k1.wide_table(bins) == table
    calls = []

    def fake(name, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, len(argtypes), args[3]))
            return 0
        return fn

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(k1, "c_function", fake)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    kernels.reset_launches()
    k1._histogram_cuda(lane_from_numpy(np.zeros(4, np.uint32), "cpu"), None,
                       bins)
    wide = table is not None
    assert calls == [("rj_histogram_wide" if wide else "rj_histogram", 6,
                      bins)]
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "histogram_wide" if wide else "histogram": 1}
    kernels.reset_launches()


def _range_emulation(ids, weights, bins, chunks, threads=8, vec=2):
    """``histogram_range_kernel`` over ``chunks`` chunks: ranges of at most
    ``MAX_RANGE_BINS`` bins (rounded up to 32), block ``b`` holding range
    ``b // chunks`` and striding over chunk ``b % chunks`` (``threads`` x
    ``vec`` 16-byte loads a round, then the tail one id a thread); a warp
    of 32 lanes adds each counted id's weight at its offset in the range
    (wrapping uint32: an id below the range or ~0 past n wraps past it),
    once for the warp when its counted ids share one bin; every block's
    table flushed into the global one."""
    ranges = -(-bins // k1.MAX_RANGE_BINS)
    range_bins = -(-(-(-bins // ranges)) // 32) * 32
    n = ids.size
    w = np.ones(n, np.uint64) if weights is None else weights.astype(
        np.uint64)
    out = np.zeros(bins, np.uint64)
    nvec = n // 4
    for blk in range(chunks * ranges):
        chunk, lo = blk % chunks, (blk // chunks) * range_bins
        count = min(range_bins, bins - lo)
        table = np.zeros(count, np.uint64)
        seen = []
        step = threads * vec
        for b in range(chunk * step, nvec, chunks * step):
            for j in range(vec):
                v = np.arange(b + j * threads, b + (j + 1) * threads)
                v = v[v < nvec]
                seen.append(np.concatenate([4 * v + k for k in range(4)]))
        for b in range(4 * nvec + chunk * threads, n, chunks * threads):
            seen.append(np.arange(b, min(b + threads, n)))
        for pos in seen:
            for warp in range(0, pos.size, 32):
                p = pos[warp:warp + 32]
                rel = (ids[p].astype(np.int64) - lo) & ONES
                p, rel = p[rel < count], rel[rel < count]
                if p.size == 0:
                    continue
                if (rel == rel[0]).all():
                    table[rel[0]] += w[p].sum()
                else:
                    np.add.at(table, rel, w[p])
        out[lo:lo + count] += table
    return (out & np.uint64(ONES)).astype(np.uint32)


@pytest.mark.parametrize("bins", [k1.MAX_BINS + 1, (1 << 15) + 1,
                                  1 << 17])
@pytest.mark.parametrize("kind", ["random", "sorted", "constant"])
def test_range_emulation_equals_the_plain_version(bins, kind):
    rng = np.random.default_rng(bins + len(kind))
    n = 3001                          # a tail past the 16-byte loads
    ids = rng.integers(0, bins + bins // 8, n).astype(np.uint32)
    if kind == "sorted":
        ids = np.sort(ids)
    elif kind == "constant":
        ids[:] = bins - 1
    ids[:2] = (ONES, bins)
    w = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    for weights in (None, w):
        want = k1.histogram_plain(
            lane_from_numpy(ids, "cpu"),
            None if weights is None else lane_from_numpy(weights, "cpu"),
            bins)
        for chunks in (1, 3):
            got = _range_emulation(ids, weights, bins, chunks)
            np.testing.assert_array_equal(got, lane_to_numpy(want))


def test_k1_constants_match_the_kernel_source():
    src = (CSRC / "histogram.cu").read_text()
    assert _const(src, "kMaxBins") == k1.MAX_BINS
    assert _const(src, "kMaxRangeBins") == k1.MAX_RANGE_BINS
    assert _const(src, "kMaxRanges") == k1.MAX_RANGES
    assert _const(src, "kRangeMaxBins") == k1.RANGE_MAX_BINS
    # a range table fits a block's 227 KB of shared memory
    assert 4 * k1.MAX_RANGE_BINS <= 227 * 1024


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("groups", [k4.WIDE_MAX_GROUPS + 1, 16384, 16385,
                                    65536, 65537, 12000, 1 << 24,
                                    (1 << 31) - 1])
def test_msd_plan_covers_every_group_id(groups):
    plan = k4.msd_plan(groups)
    bits = [b for b, _ in plan]
    assert sum(bits) == (groups - 1).bit_length()
    assert len(plan) == max(2, -(-sum(bits) // k4.MSD_DIGIT_BITS))
    assert all(1 <= b <= k4.MSD_DIGIT_BITS for b in bits)
    assert bits == sorted(bits)
    assert [s for _, s in plan] == [sum(bits[i + 1:])
                                    for i in range(len(bits))]
    # the coarse pass's values and every later pass's fit one thread each
    assert ((groups - 1) >> plan[0][1]) + 1 <= 1 << k4.MSD_DIGIT_BITS


def test_msd_constants_match_the_kernel_source():
    src = (CSRC / "partition_msd.cu").read_text()
    assert _const(src, "kTile") == k4.MSD_TILE_IDS
    assert _const(src, "kDigitBits") == k4.MSD_DIGIT_BITS
    assert _const(src, "kMaxLanes") == k4.MAX_LANES + 1   # and the id
    assert _const(src, "kMaxPasses") == len(k4.msd_plan((1 << 31) - 1))
    assert _const(src, "kThreads") == 1 << k4.MSD_DIGIT_BITS
