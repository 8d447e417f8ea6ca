"""The single-pass K3 and K5 (``csrc/merge_scan_partitions.cuh``): a numpy
emulation of what the card's kernel computes, held bit for bit against the
plain versions (``merge_scan_plain``, ``merge_scan_wide_plain``, which every
CPU tensor takes) and the JAX ``merge_scan_partitions`` /
``merge_scan_partitions_wide`` in interpret mode; and the one scratch block
a call zeroes (``scratch_layout``) against the C entry's size rule.

The emulation follows the kernel: each position folded into one word
``pid << 2 | run_start << 1 | is_s`` as the lanes load, tiles of
``threads x items`` words, each thread's (R, B) summary, two block scans,
the warp look-back over 64-bit status words (32 a round back to the nearest
inclusive word, some tiles leaving only their aggregate), then every
thread's weights from its carried state, binned by partition."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.ops import merge_count as jmc  # noqa: E402
from tpu_radix_join.ops.pallas.merge_scan import (  # noqa: E402
    TILE, merge_scan_partitions as jax_k3,
    merge_scan_partitions_wide as jax_k5)

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops.kernels import merge_scan as k3  # noqa: E402
from tpu_radix_join_torch.ops.kernels import merge_scan_wide as k5  # noqa: E402

CSRC = Path(k3.__file__).resolve().parents[2] / "csrc"
ONES = 0xFFFFFFFF
#: the interpret kernels compile once per length and fanout: every case
#: that meets them is padded to this length
JAX_LENGTH = 2 * TILE
#: the kernel's own tile (threads, items) and a small one for long walks
KERNEL_TILE = (256, 39)
SMALL_TILE = (32, 3)

# ------------------------------------------------ the carry and its words
# As csrc/merge_scan_lookback.cuh computes them (copied from
# tests/test_torch_merge_scan_chunks.py, K6's emulation).
CARRY_IDENTITY = (0, -1)
AGGREGATE, INCLUSIVE = 1, 2
_FIELD = (1 << 31) - 1


def _compose(a, b):
    """``a`` then ``b`` in position order: (R1 + R2, max(B1, R1 + B2)),
    -1 for "no run starts here"."""
    return (a[0] + b[0], max(a[1], a[0] + b[1] if b[1] >= 0 else -1))


def _status_word(flag, carry):
    """The 64-bit look-back word: flag in bits 62-63, R in 31-61, B + 1 in
    0-30."""
    r, b = carry
    if not (0 <= r <= _FIELD and -1 <= b < _FIELD and flag in (1, 2)):
        raise ValueError(f"no status word holds ({flag}, {r}, {b})")
    return (flag << 62) | (r << 31) | (b + 1)


def _status_fields(word):
    return word >> 62, ((word >> 31) & _FIELD, (word & _FIELD) - 1)


def _look_back(words, t):
    """What warp 0 of tile ``t`` composes: the published words of tiles
    t - 1, t - 2, ... 32 a round, back to the nearest inclusive one,
    composed earliest tile first."""
    before, j = CARRY_IDENTITY, t - 1
    while True:
        window = [_status_fields(words[k]) for k in
                  range(j, max(j - 32, -1), -1)]
        last = next((i for i, (f, _) in enumerate(window)
                     if f == INCLUSIVE), None)
        acc = CARRY_IDENTITY
        for _, c in reversed(window[:len(window) if last is None
                                    else last + 1]):
            acc = _compose(acc, c)
        before = _compose(acc, before)
        if last is not None:
            return before
        j -= 32


# ------------------------------------------------------- the emulation
def _words_packed(packed, fanout_bits):
    """K3's load: key = packed >> 1, side = bit 0, pid = the top f bits."""
    p = packed.astype(np.int64)
    key = p >> 1
    start = np.ones(len(p), bool)              # position 0 starts a run
    start[1:] = key[1:] != key[:-1]
    pid = p >> (32 - fanout_bits) if fanout_bits else np.zeros_like(p)
    return pid << 2 | start.astype(np.int64) << 1 | (p & 1)


def _words_wide(lo_rot, hi, tag, fanout_bits):
    """K5's load: a run starts where the (lo, hi) pair changes (hi None:
    never read)."""
    lo = lo_rot.astype(np.int64)
    start = np.ones(len(lo), bool)
    start[1:] = lo[1:] != lo[:-1]
    if hi is not None:
        start[1:] |= hi[1:] != hi[:-1]
    pid = lo >> (32 - fanout_bits) if fanout_bits else np.zeros_like(lo)
    return pid << 2 | start.astype(np.int64) << 1 | (tag.astype(np.int64) & 1)


def _emulate(words, fanout_bits, tile=KERNEL_TILE, inclusive_p=0.5, seed=0):
    """``(counts, max_weight)`` as the kernel computes them from the words:
    uint32 counts [2**f] and the largest weight."""
    threads, items = tile
    size = threads * items
    rng = np.random.default_rng(seed)
    m = len(words)
    published = []
    counts = np.zeros(1 << fanout_bits, np.uint64)
    maxw = 0
    cols = np.arange(items)
    for t in range(-(-m // size)):
        w = np.zeros(size, np.int64)
        valid = min(size, m - t * size)
        w[:valid] = words[t * size:t * size + valid]
        w = w.reshape(threads, items)          # thread k owns row k
        inside = (np.arange(size) < valid).reshape(threads, items)
        is_s = w & 1
        is_r = np.where(inside, 1 - is_s, 0)
        start = (w >> 1 & 1).astype(bool) & inside
        # each thread's summary: its R count, the R count before its last
        # run start (-1 when none starts there)
        incl = np.cumsum(is_r, axis=1)
        count_r = incl[:, -1]
        last = np.where(start, cols, -1).max(axis=1)
        last_start = np.where(last >= 0, (incl - is_r)[np.arange(threads),
                                                        last], -1)
        # the block scans
        excl_r = np.cumsum(count_r) - count_r
        cand = np.where(last_start >= 0, excl_r + last_start, -1)
        excl_base = np.concatenate([[-1], np.maximum.accumulate(cand)[:-1]])
        agg = (int(count_r.sum()), int(cand.max()))
        # warp 0's look-back
        if t == 0:
            before = CARRY_IDENTITY
            published.append(_status_word(INCLUSIVE, agg))
        else:
            published.append(_status_word(AGGREGATE, agg))
            before = _look_back(published, t)
            if rng.random() < inclusive_p:
                published[t] = _status_word(INCLUSIVE, _compose(before, agg))
        # every thread's weights from its carried (c_r, base_run)
        c_r = before[0] + excl_r[:, None] + incl
        b0 = np.maximum(before[1], np.where(excl_base >= 0,
                                            before[0] + excl_base, -1))
        at = np.maximum.accumulate(np.where(start, cols, -1), axis=1)
        base = np.where(at >= 0, np.take_along_axis(c_r - is_r,
                                                    np.maximum(at, 0), 1),
                        np.maximum(b0, 0)[:, None])
        weight = np.where(inside, is_s * (c_r - base), 0)
        np.add.at(counts, (w >> 2)[inside], weight[inside].astype(np.uint64))
        maxw = max(maxw, int(weight.max()))
    return (counts & np.uint64(ONES)).astype(np.uint32), maxw


# ---------------------------------------------------------- the inputs
def _sorted_pm(r, s, fanout_bits):
    """K3's input: the sorted partition-major packed union (JAX pack)."""
    return np.sort(np.asarray(jmc._pack_pm(jnp.asarray(r), jnp.asarray(s),
                                           fanout_bits)))


def _sorted_wide(r_lo, r_hi, s_lo, s_hi, fanout_bits):
    """K5's input: the union sorted by (lo_rot, hi), R before S in a run."""
    lo = np.asarray(jmc._rotate_pid(jnp.asarray(np.concatenate([r_lo, s_lo])),
                                    fanout_bits))
    hi = np.concatenate([r_hi, s_hi])
    tag = np.concatenate([np.zeros(len(r_lo), np.uint32),
                          np.ones(len(s_lo), np.uint32)])
    order = np.lexsort((tag, hi, lo))
    return lo[order], hi[order], tag[order]


def _mixed_keys(rng, n_r, n_s, run_r, run_s, domain):
    """Keys with one long run (``run_r`` R and ``run_s`` S copies of one
    key) among duplicates from ``domain``."""
    r = np.concatenate([np.full(run_r, 42, np.uint32),
                        rng.integers(0, domain, n_r - run_r).astype(np.uint32)])
    s = np.concatenate([np.full(run_s, 42, np.uint32),
                        rng.integers(0, domain, n_s - run_s).astype(np.uint32)])
    return r, s


def _k3_case(name, fanout_bits, rng):
    """A sorted packed union for K3."""
    tile = KERNEL_TILE[0] * KERNEL_TILE[1]
    if name == "one_position":
        return _sorted_pm(np.zeros(0, np.uint32), np.array([7], np.uint32),
                          fanout_bits)
    if name in ("tile_minus_1", "tile", "tile_plus_1"):
        n = tile + {"tile_minus_1": -1, "tile": 0, "tile_plus_1": 1}[name]
        r, s = _mixed_keys(rng, n // 2, n - n // 2, 3000, 2000, 900)
        return _sorted_pm(r, s, fanout_bits)
    if name == "run_over_four_tiles":
        r, s = _mixed_keys(rng, 25000, 20000, 24000, 19000, 50)
        return _sorted_pm(r, s, fanout_bits)
    if name == "handful_per_partition":
        # every partition holds a few positions: many partitions a tile
        keys = rng.integers(0, 1 << 11, 3000).astype(np.uint32)
        return _sorted_pm(keys[:1400], keys[1000:], fanout_bits)
    if name == "all_r":
        return _sorted_pm(rng.integers(0, 40, 12000).astype(np.uint32),
                          np.zeros(0, np.uint32), fanout_bits)
    if name == "all_s":
        return _sorted_pm(np.zeros(0, np.uint32),
                          rng.integers(0, 40, 12000).astype(np.uint32),
                          fanout_bits)
    raise ValueError(name)


def _k5_case(name, fanout_bits, rng, with_hi):
    """Sorted (lo_rot, hi, tag) lanes for K5 (hi None without hi)."""
    tile = KERNEL_TILE[0] * KERNEL_TILE[1]
    if name == "one_position":
        r_lo, s_lo = np.zeros(0, np.uint32), np.array([ONES - 1], np.uint32)
    elif name in ("tile_minus_1", "tile", "tile_plus_1"):
        n = tile + {"tile_minus_1": -1, "tile": 0, "tile_plus_1": 1}[name]
        r_lo, s_lo = _mixed_keys(rng, n // 2, n - n // 2, 3000, 2000, 900)
    elif name == "run_over_four_tiles":
        r_lo, s_lo = _mixed_keys(rng, 25000, 20000, 24000, 19000, 50)
    elif name == "handful_per_partition":
        keys = rng.integers(0, 1 << 11, 3000).astype(np.uint32)
        r_lo, s_lo = keys[:1400], keys[1000:]
    elif name == "all_r":
        r_lo, s_lo = (rng.integers(0, 40, 12000).astype(np.uint32),
                      np.zeros(0, np.uint32))
    elif name == "all_s":
        r_lo, s_lo = (np.zeros(0, np.uint32),
                      rng.integers(0, 40, 12000).astype(np.uint32))
    else:
        raise ValueError(name)
    # full-range lo (bit 31 set on half the keys); hi from 3 values, so
    # equal lo meets different hi
    r_lo = r_lo ^ np.uint32(0x80000000) * (r_lo & 1)
    s_lo = s_lo ^ np.uint32(0x80000000) * (s_lo & 1)
    r_hi = (rng.integers(0, 3, len(r_lo)).astype(np.uint32) if with_hi
            else np.zeros(len(r_lo), np.uint32))
    s_hi = (rng.integers(0, 3, len(s_lo)).astype(np.uint32) if with_hi
            else np.zeros(len(s_lo), np.uint32))
    if name == "run_over_four_tiles":       # the run keeps one hi
        r_hi[:24000] = 1
        s_hi[:19000] = 1
    lo, hi, tag = _sorted_wide(r_lo, r_hi, s_lo, s_hi, fanout_bits)
    return lo, (hi if with_hi else None), tag


def _lane(a):
    return lane_from_numpy(a, "cpu")


def _out(c, w):
    return lane_to_numpy(c), int(lane_to_numpy(w.reshape(1))[0])


def _plain_k3(packed, f):
    return _out(*k3.merge_scan_partitions(_lane(packed),
                                          num_partitions=1 << f))


def _plain_k5(lo, hi, tag, f):
    return _out(*k5.merge_scan_partitions_wide(
        _lane(lo), None if hi is None else _lane(hi), _lane(tag),
        num_partitions=1 << f))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def _kernel_out(kernel, case, f, rng, tile=KERNEL_TILE, inclusive_p=0.5):
    """(emulated, plain) outputs of one kernel on one case."""
    if kernel == "k3":
        packed = _k3_case(case, f, rng)
        return (_emulate(_words_packed(packed, f), f, tile, inclusive_p),
                _plain_k3(packed, f))
    lanes = _k5_case(case, f, rng, with_hi=kernel == "k5_hi")
    return (_emulate(_words_wide(*lanes, f), f, tile, inclusive_p),
            _plain_k5(*lanes, f))


KERNELS = ["k3", "k5_hi", "k5_no_hi"]


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("fanout", [0, 5, 7])
@pytest.mark.parametrize("kernel", KERNELS)
def test_emulation_equals_plain_and_pallas_interpret(kernel, fanout):
    """At two TPU tiles: one key's run of 35,000 positions (over three of
    the card's tiles) among duplicates; the emulation at the kernel's tile
    and at a small one (long look-back walks), the plain version and the
    interpreted TPU kernel on its padded lanes agree bit for bit."""
    rng = np.random.default_rng(fanout)
    r, s = _mixed_keys(rng, 30000, 30000, 20000, 15000, 3000)
    pad = JAX_LENGTH - len(r) - len(s)
    if kernel == "k3":
        packed = _sorted_pm(r, s, fanout)
        words = _words_packed(packed, fanout)
        plain = _plain_k3(packed, fanout)
        padded = np.concatenate([packed, np.full(pad, ONES, np.uint32)])
        c, w = jax_k3(jnp.asarray(padded), num_partitions=1 << fanout,
                      interpret=True)
    else:
        with_hi = kernel == "k5_hi"
        # full-range lo, hi from 2 values (equal lo, different hi); no R
        # pair is the all-ones pad the interpreted kernel appends
        r_lo, s_lo = r ^ np.uint32(0x80000000), s ^ np.uint32(0x80000000)
        r_hi = (rng.integers(0, 2, len(r)).astype(np.uint32) if with_hi
                else np.zeros(len(r), np.uint32))
        s_hi = (rng.integers(0, 2, len(s)).astype(np.uint32) if with_hi
                else np.zeros(len(s), np.uint32))
        if with_hi:                     # the run keeps one hi
            r_hi[:20000], s_hi[:15000] = 1, 1
        lo, hi, tag = _sorted_wide(r_lo, r_hi, s_lo, s_hi, fanout)
        words = _words_wide(lo, hi if with_hi else None, tag, fanout)
        plain = _plain_k5(lo, hi if with_hi else None, tag, fanout)
        ones = np.full(pad, ONES, np.uint32)
        c, w = jax_k5(jnp.asarray(np.concatenate([lo, ones])),
                      jnp.asarray(np.concatenate([hi, ones])),
                      jnp.asarray(np.concatenate([tag, np.ones(pad,
                                                               np.uint32)])),
                      num_partitions=1 << fanout, interpret=True)
    want = (np.asarray(c), int(w))
    assert want[1] >= 20000 and int(want[0].astype(np.uint64).sum()) > \
        15000 * 20000
    _assert_same(plain, want)
    _assert_same(_emulate(words, fanout), want)
    _assert_same(_emulate(words, fanout, SMALL_TILE, inclusive_p=0.03,
                          seed=fanout), want)


@pytest.mark.parametrize("case", [
    "one_position", "tile_minus_1", "tile", "tile_plus_1",
    "run_over_four_tiles", "handful_per_partition", "all_r", "all_s"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_emulation_equals_plain_at_tile_edges(kernel, case):
    """Lengths at the kernel's tile (9,984 positions) and one position; a
    run of 43,000 positions over four tiles; a tile spanning all 128
    partitions with a few positions each; no S, no R."""
    f = 7 if case == "handful_per_partition" else 5
    got, want = _kernel_out(kernel, case, f, np.random.default_rng(len(case)))
    _assert_same(got, want)
    if case == "handful_per_partition":
        assert np.count_nonzero(want[0]) > 100


@pytest.mark.parametrize("kernel", KERNELS)
def test_emulation_on_small_tiles_walks_far(kernel):
    """The four-tile run at a tile of 96 words: hundreds of tiles in the
    run, look-back walks of many rounds (few inclusive words)."""
    got, want = _kernel_out(kernel, "run_over_four_tiles", 0,
                            np.random.default_rng(3), SMALL_TILE,
                            inclusive_p=0.01)
    _assert_same(got, want)
    assert want[1] >= 24000


@pytest.mark.parametrize("f", [0, 1, 5, 7])
def test_words_bin_by_the_top_bits(f):
    """A word's pid is the packed lane's (K3) or the rotated lane's (K5)
    top f bits, and K5 without hi finds K3's run starts on the same keys."""
    rng = np.random.default_rng(f)
    packed = np.sort(rng.integers(0, 1 << 32, 5000,
                                  dtype=np.uint64).astype(np.uint32))
    words = _words_packed(packed, f)
    np.testing.assert_array_equal(words >> 2, packed.astype(np.int64)
                                  >> (32 - f) if f else 0)
    wide = _words_wide(packed >> 1, None, packed & 1, 0)
    np.testing.assert_array_equal(wide & 3, words & 3)


@pytest.mark.parametrize("m, f, tiles", [
    (0, 0, 0), (1, 0, 1), (k3.SCAN_TILE, 5, 1), (k3.SCAN_TILE + 1, 7, 2),
    ((1 << 31) - 1, 7, -(-((1 << 31) - 1) // k3.SCAN_TILE))])
def test_scratch_layout(m, f, tiles):
    lay = k3.scratch_layout(m, f)
    assert lay.tiles == lay.lookback_words == tiles
    assert lay.word_bytes == k3.LOOKBACK_WORD_BYTES == 8
    # look-back words, the tile counter, the max weight, the counts
    assert lay.bytes == 8 * tiles + 4 + 4 + 4 * (1 << f)
    assert (lay.counter_offset, lay.max_offset, lay.counts_offset,
            lay.words) == (2 * tiles, 2 * tiles + 1, 2 * tiles + 2,
                           2 * tiles + 2 + (1 << f))
    assert k5.scratch_layout(m, f) == lay


def test_scratch_layout_sizes_stated_in_perf():
    # (a)'s and (h)'s 40M unions at fanout 5; (m)'s wide slab union
    lay = k3.scratch_layout(40_000_000, 5)
    assert (lay.tiles, 8 * lay.lookback_words, lay.bytes) == (
        4_007, 32_056, 32_192)
    lay = k5.scratch_layout((1 << 23) + (1 << 20), 5)
    assert (lay.tiles, lay.bytes) == (946, 7_704)
    for bad in ((1 << 31, 5), (-1, 5), (10, 31), (10, -1)):
        with pytest.raises(ValueError):
            k3.scratch_layout(*bad)


def test_c_entry_scratch_rule_equals_scratch_layout():
    """The tile and the scratch size the C entry refuses any other of, read
    from csrc/merge_scan_partitions.cuh, equal the wrappers' constants and
    ``scratch_layout``; both entries size their scratch by that rule."""
    src = (CSRC / "merge_scan_partitions.cuh").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    items = int(re.search(r"kItems = (\d+);", src).group(1))
    assert threads * items == k3.SCAN_TILE == k5.SCAN_TILE
    rule = re.search(r"long long scratch_bytes\(long long m, int "
                     r"fanout_bits\) \{\s*return ([^;]+);", src).group(1)
    assert "bytes != scratch_bytes(m, fanout_bits)" in src
    rule = rule.replace("1ll", "1").replace("num_tiles(m)", "tiles")
    for m, f in ((0, 0), (1, 3), (k3.SCAN_TILE, 5), (40_000_000, 5),
                 ((1 << 31) - 1, 7)):
        tiles = -(-m // (threads * items))
        assert eval(rule, {"tiles": tiles, "fanout_bits": f}) == \
            k3.scratch_layout(m, f).bytes
    for entry in ("merge_scan.cu", "merge_scan_wide.cu"):
        text = (CSRC / entry).read_text()
        assert '#include "merge_scan_partitions.cuh"' in text
        assert "rj_bins::launch(" in text
