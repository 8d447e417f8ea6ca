"""Port parity of K6 and the chunked counts: ``ops/kernels/merge_scan_chunks``
(its plain version, which every CPU tensor takes) against the JAX
``merge_scan_chunks(..., interpret=True)`` on the same sorted lanes, and
``ops/merge_count`` (``merge_count_chunks``, ``merge_count_pallas``,
``presort_keys`` + ``merge_count_presorted``) against the JAX functions.
Every comparison is exact."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.data.relation import host_join_count  # noqa: E402
from tpu_radix_join.ops import merge_count as jmc  # noqa: E402
from tpu_radix_join.ops.pallas.merge_scan import (  # noqa: E402
    TILE, merge_scan_chunks as jax_chunks)

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops import merge_count as tmc  # noqa: E402
from tpu_radix_join_torch.ops.kernels import merge_scan_chunks as k6  # noqa: E402

#: the interpret kernel compiles once per length: every family shares these
LENGTHS = (2 * TILE, 3 * TILE)


def _family(name: str, rng):
    """(r_keys, s_keys) whose packed union fits 2 * TILE positions."""
    half = TILE - 64
    if name == "random":
        return (rng.integers(0, 300, half).astype(np.uint32),
                rng.integers(0, 300, half).astype(np.uint32))
    if name == "duplicate_heavy":
        return (rng.integers(0, 50, TILE + 500).astype(np.uint32),
                rng.integers(0, 50, TILE - 900).astype(np.uint32))
    if name == "runs_crossing_tiles":
        return (rng.integers(0, 7, 100).astype(np.uint32),
                rng.integers(0, 7, 2 * TILE - 200).astype(np.uint32))
    if name == "r_run_two_tiles":
        # one key's inner run spans two of K3's tiles and most of a TPU tile
        return (np.full(TILE - 300, 42, np.uint32),
                np.concatenate([np.full(100, 42, np.uint32),
                                np.arange(1000, 1000 + TILE - 100,
                                          dtype=np.uint32)]))
    if name == "sentinel_saturated":
        edge = np.array([0, 1, jmc.MAX_MERGE_KEY, jmc.MAX_MERGE_KEY + 1,
                         0x7FFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
        return (edge[rng.integers(0, len(edge), half)],
                edge[rng.integers(0, len(edge), half)])
    if name == "unique":
        keys = rng.permutation(2 * half).astype(np.uint32)
        return keys[:half], keys[half:][::-1].copy()
    raise ValueError(name)


FAMILIES = ["random", "duplicate_heavy", "runs_crossing_tiles",
            "r_run_two_tiles", "sentinel_saturated", "unique"]


def _sorted_pack(r, s):
    """The sorted packed union (JAX ``_pack``), unpadded."""
    return np.sort(np.asarray(jmc._pack(jnp.asarray(r), jnp.asarray(s))))


def _padded(packed, length):
    pad = length - len(packed)
    assert pad >= 0
    return np.concatenate([packed, np.full(pad, 0xFFFFFFFF, np.uint32)])


def _k6(lane, width):
    sums, maxw = k6.merge_scan_chunks(lane_from_numpy(lane, "cpu"),
                                      width=width)
    return lane_to_numpy(sums), int(lane_to_numpy(maxw.reshape(1))[0])


def _reference(packed, width):
    """Per-window uint32 sums and the max weight from the JAX package's
    own weights (the XLA path's ``_weights``)."""
    w, _ = jmc._weights(jnp.asarray(packed))
    w = np.asarray(w).astype(np.uint64)
    pad = (-len(w)) % width
    w = np.concatenate([w, np.zeros(pad, np.uint64)])
    sums = w.reshape(-1, width).sum(axis=1) & np.uint64(0xFFFFFFFF)
    return sums.astype(np.uint32), int(w.max()) if len(w) else 0


@pytest.mark.parametrize("family", FAMILIES)
def test_tile_counts_equal_pallas_interpret(family):
    """At width TILE, K6 gives the TPU kernel's per-tile counts bit for bit,
    on the TPU's padded lane and on the unpadded one (whose missing tail
    tiles would be zero)."""
    r, s = _family(family, np.random.default_rng(len(family)))
    packed = _sorted_pack(r, s)
    padded = _padded(packed, LENGTHS[0])
    want = np.asarray(jax_chunks(jnp.asarray(padded), interpret=True))
    got, got_w = _k6(padded, k6.TILE)
    np.testing.assert_array_equal(got, want)
    got_u, got_uw = _k6(packed, k6.TILE)
    np.testing.assert_array_equal(got_u, want[:len(got_u)])
    assert not want[len(got_u):].any()
    assert got_w == got_uw == _reference(packed, 1)[1]
    if family != "sentinel_saturated":
        assert int(want.astype(np.uint64).sum()) == host_join_count(r, s)


def test_run_spanning_many_tiles_equals_pallas_interpret():
    """An inner run of two TPU tiles: the carried base survives every tile
    boundary of both kernels."""
    r = np.full(2 * TILE, 42, np.uint32)
    s = np.concatenate([np.full(100, 42, np.uint32),
                        np.arange(1000, 1000 + TILE - 100, dtype=np.uint32)])
    packed = _sorted_pack(r, s)
    assert len(packed) == LENGTHS[1]
    want = np.asarray(jax_chunks(jnp.asarray(packed), interpret=True))
    got, maxw = _k6(packed, k6.TILE)
    np.testing.assert_array_equal(got, want)
    assert int(want.astype(np.uint64).sum()) == 2 * TILE * 100
    assert maxw == 2 * TILE


@pytest.mark.parametrize("width", [1, 2, 7, 15, 480, 481, 3840, 4097,
                                   TILE - 1, TILE, TILE + 1, 5 * TILE])
@pytest.mark.parametrize("family", ["duplicate_heavy", "r_run_two_tiles"])
def test_any_window_width_equals_the_jax_weights(family, width):
    """Widths below a thread's items, not dividing the tile, wider than the
    lane: the window sums of the JAX weights, wrapped to uint32."""
    r, s = _family(family, np.random.default_rng(7))
    packed = _sorted_pack(r, s)
    got, maxw = _k6(packed, width)
    want, want_w = _reference(packed, min(width, len(packed)))
    np.testing.assert_array_equal(got, want)
    assert maxw == want_w


def test_window_sums_wrap_and_max_weight_does_not():
    """A window whose weights pass 2**32 wraps like the TPU's int32 sums;
    the largest single weight does not."""
    r = np.full(70000, 5, np.uint32)
    s = np.full(70000, 5, np.uint32)
    packed = _sorted_pack(r, s)
    got, maxw = _k6(packed, len(packed))
    assert maxw == 70000
    assert int(got[0]) == (70000 * 70000) % (1 << 32)
    np.testing.assert_array_equal(got, _reference(packed, len(packed))[0])


def test_edge_lanes():
    """All pads, an empty lane, one position, n < w."""
    pads = np.full(1000, 0xFFFFFFFF, np.uint32)
    got, maxw = _k6(pads, 33)
    assert got.shape == (31,) and not got.any() and maxw == 0
    got, maxw = _k6(np.zeros(0, np.uint32), 5)
    assert got.shape == (0,) and maxw == 0
    got, maxw = _k6(np.array([3], np.uint32), 1)
    np.testing.assert_array_equal(got, [0])
    pair = np.array([4, 5], np.uint32)            # key 2: R then S
    got, maxw = _k6(pair, 100)
    np.testing.assert_array_equal(got, [1])
    assert maxw == 1


def test_wrapper_rejects_bad_arguments():
    lane = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        k6.merge_scan_chunks(lane, width=0)
    with pytest.raises(ValueError):
        k6.merge_scan_chunks(lane.to(torch.int64), width=4)
    assert k6.TILE == TILE


# ------------------------------------------------------------ merge counts
def _lanes(*arrays):
    return [lane_from_numpy(a, "cpu") for a in arrays]


@pytest.mark.parametrize("n_s", [5000, 700])
@pytest.mark.parametrize("num_chunks", [1024, 4096])
def test_merge_count_chunks_equals_jax(num_chunks, n_s):
    """The partials (zero-extended to ``num_chunks``) and the max weight;
    a union shorter than ``num_chunks`` leaves windows of width 1."""
    rng = np.random.default_rng(num_chunks + n_s)
    r = rng.integers(0, 900, 3000).astype(np.uint32)
    s = rng.integers(0, 900, n_s).astype(np.uint32)
    r[:5] = jmc.MAX_MERGE_KEY + np.arange(5, dtype=np.uint32)   # pads
    want_c, want_w = jmc.merge_count_chunks(jnp.asarray(r), jnp.asarray(s),
                                            num_chunks=num_chunks,
                                            return_max_weight=True)
    got_c, got_w = tmc.merge_count_chunks(*_lanes(r, s),
                                          num_chunks=num_chunks,
                                          return_max_weight=True)
    np.testing.assert_array_equal(lane_to_numpy(got_c), np.asarray(want_c))
    assert int(lane_to_numpy(got_w.reshape(1))[0]) == int(want_w)
    plain = tmc.merge_count_chunks(*_lanes(r, s), num_chunks=num_chunks)
    assert torch.equal(plain, got_c)


def test_merge_count_pallas_equals_jax():
    """The fused count under its JAX name: K6 at the TPU tile, on the
    unpadded union, equals the TPU path's padded per-tile counts."""
    rng = np.random.default_rng(11)
    r = rng.integers(0, 1000, TILE).astype(np.uint32)
    s = rng.integers(0, 1000, TILE // 2).astype(np.uint32)
    want = np.asarray(jmc.merge_count_pallas(jnp.asarray(r), jnp.asarray(s),
                                             interpret=True))
    got = lane_to_numpy(tmc.merge_count_pallas(*_lanes(r, s)))
    np.testing.assert_array_equal(got, want[:len(got)])
    assert not want[len(got):].any()
    assert int(got.astype(np.uint64).sum()) == host_join_count(r, s)


@pytest.mark.parametrize("case", ["high_keys", "duplicates", "low_keys"])
def test_presorted_count_equals_jax(case):
    """``presort_keys`` sorts unsigned and ``merge_count_presorted`` finds
    keys >= 2**31 (``torch.searchsorted`` alone compares signed)."""
    rng = np.random.default_rng(len(case))
    if case == "high_keys":
        r = rng.integers(0, 0xFFFFFFFE, 4000, dtype=np.uint64).astype(np.uint32)
        s = np.concatenate([r[:1500], rng.integers(1 << 31, 0xFFFFFFFE, 500,
                                                   dtype=np.uint64)
                            .astype(np.uint32)])
        s = np.concatenate([s, np.full(7, 0xFFFFFFFF, np.uint32)])  # pads
    elif case == "duplicates":
        r = (rng.integers(0, 40, 4000).astype(np.uint32)
             | np.uint32(0x80000000))
        s = (rng.integers(0, 60, 3000).astype(np.uint32)
             | np.uint32(0x80000000))
    else:
        r = rng.integers(0, 500, 4000).astype(np.uint32)
        s = rng.integers(0, 700, 3000).astype(np.uint32)
    r_sorted_j = jmc.presort_keys(jnp.asarray(r))
    want_t, want_w = jmc.merge_count_presorted(r_sorted_j, jnp.asarray(s),
                                               return_max_weight=True)
    r_sorted = tmc.presort_keys(lane_from_numpy(r, "cpu"))
    np.testing.assert_array_equal(lane_to_numpy(r_sorted),
                                  np.asarray(r_sorted_j))
    got_t, got_w = tmc.merge_count_presorted(r_sorted,
                                             lane_from_numpy(s, "cpu"),
                                             return_max_weight=True)
    assert int(lane_to_numpy(got_t.reshape(1))[0]) == int(want_t)
    assert int(got_w) == int(want_w)
    assert int(want_t) == host_join_count(r, s) % (1 << 32)
    assert int(lane_to_numpy(tmc.merge_count_presorted(
        r_sorted, lane_from_numpy(s, "cpu")).reshape(1))[0]) == int(want_t)


# ------------------------------------------- the single-pass carry of K6
# The card's K6 is one launch: a tile's summary (R, B), its look-back word,
# and the composition of every tile before it in tile order.  These hold that
# arithmetic: a plain emulation of the tiles, the threads inside a tile and
# the warp look-back (32 words a round, the nearest inclusive word ending the
# walk, some tiles leaving only their aggregate) against the plain weights
# and the interpreted TPU kernel.  The carry and its word as
# csrc/merge_scan_lookback.cuh computes them:
CARRY_IDENTITY = (0, -1)
AGGREGATE, INCLUSIVE = 1, 2
_FIELD = (1 << 31) - 1


def _compose(a, b):
    """``a`` then ``b`` in position order: (R1 + R2, max(B1, R1 + B2)),
    -1 for "no run starts here"."""
    return (a[0] + b[0], max(a[1], a[0] + b[1] if b[1] >= 0 else -1))


def _status_word(flag, carry):
    """The 64-bit look-back word: flag in bits 62-63, R in 31-61, B + 1 in
    0-30 (kFlagShift, kRShift, kField)."""
    r, b = carry
    if not (0 <= r <= _FIELD and -1 <= b < _FIELD and flag in (1, 2)):
        raise ValueError(f"no status word holds ({flag}, {r}, {b})")
    return (flag << 62) | (r << 31) | (b + 1)


def _status_fields(word):
    return word >> 62, ((word >> 31) & _FIELD, (word & _FIELD) - 1)


def _summary(packed, prev_key):
    """(R, B) of a run of positions: its R count and the R count before its
    last run start (-1 when none starts there)."""
    keys = packed >> 1
    is_r = 1 - (packed & 1).astype(np.int64)
    prev = np.concatenate([[prev_key], keys[:-1]])
    starts = np.flatnonzero(keys != prev)
    before = np.cumsum(is_r) - is_r
    return int(is_r.sum()), int(before[starts[-1]]) if len(starts) else -1


def _emulate_chunks(packed, width, tile, items=39, inclusive_p=0.5, seed=0):
    """K6 as the kernel computes it: per-thread summaries composed into the
    tile's, published as look-back words; each tile composes its
    predecessors' words in tile order, 32 at a time back to the nearest
    inclusive one, then weighs its positions from the carried state."""
    rng = np.random.default_rng(seed)
    m = len(packed)
    keys = packed.astype(np.int64) >> 1
    words = []                       # what each tile left in its slot
    sums = np.zeros(-(-m // width), np.uint64)
    maxw = 0
    for t in range(-(-m // tile)):
        lo, hi = t * tile, min((t + 1) * tile, m)
        prev_key = keys[lo - 1] if lo else 0xFFFFFFFF
        agg = CARRY_IDENTITY
        for a in range(lo, hi, items):           # the tile's threads
            b = min(a + items, hi)
            agg = _compose(agg, _summary(packed[a:b],
                                           keys[a - 1] if a else prev_key))
        if t == 0:
            before = CARRY_IDENTITY
            words.append(_status_word(INCLUSIVE, agg))
        else:
            words.append(_status_word(AGGREGATE, agg))
            before, j = CARRY_IDENTITY, t - 1
            while True:
                window = [_status_fields(words[k]) for k in
                          range(j, max(j - 32, -1), -1)]
                last = next((i for i, (f, _) in enumerate(window)
                             if f == INCLUSIVE), None)
                acc = CARRY_IDENTITY
                for _, c in reversed(window[:len(window) if last is None
                                            else last + 1]):
                    acc = _compose(acc, c)     # earliest tile first
                before = _compose(acc, before)
                if last is not None:
                    break
                j -= 32
            if rng.random() < inclusive_p:
                words[t] = _status_word(INCLUSIVE,
                                          _compose(before, agg))
        # weights from the carried (c_r, base_run) and the previous key
        c_r, base = before[0], max(before[1], 0)
        prev = prev_key
        for i in range(lo, hi):
            p = int(packed[i])
            c_r += 1 - (p & 1)
            if p >> 1 != prev:
                base = c_r - (1 - (p & 1))
            prev = p >> 1
            w = (p & 1) * (c_r - base)
            sums[i // width] += w
            maxw = max(maxw, w)
    return (sums & np.uint64(0xFFFFFFFF)).astype(np.uint32), maxw


def _emulation_family(name, rng, n):
    if name == "runs_over_tiles":                # runs longer than two tiles
        return _sorted_pack(rng.integers(0, 3, n // 3).astype(np.uint32),
                            rng.integers(0, 3, n - n // 3).astype(np.uint32))
    if name == "all_r":
        return _sorted_pack(rng.integers(0, 40, n).astype(np.uint32),
                            np.zeros(0, np.uint32))
    if name == "all_s":
        return _sorted_pack(np.zeros(0, np.uint32),
                            rng.integers(0, 40, n).astype(np.uint32))
    if name == "all_pads":
        return np.full(n, 0xFFFFFFFF, np.uint32)
    return _sorted_pack(*_family("duplicate_heavy", rng))[:n]


@pytest.mark.parametrize("tile", [1, 7, 1000, 3840, k6.SCAN_TILE])
@pytest.mark.parametrize("family", ["runs_over_tiles", "all_r", "all_s",
                                    "all_pads", "duplicate_heavy"])
def test_lookback_emulation_equals_the_plain_weights(tile, family):
    """Tile sizes of 1, 7, 3,840, the kernel's own and 1,000 (which divides
    neither the lane nor the window): the emulated carry gives the plain
    window sums and max weight, whichever tiles leave only aggregates."""
    rng = np.random.default_rng(tile)
    n = 1500 if tile < 100 else 3 * k6.SCAN_TILE + 17
    packed = _emulation_family(family, rng, n)
    # few inclusive words at small tiles: walks of more than 32 words
    inclusive_p = 0.03 if tile < 100 else 0.5
    for width in (7, 1024, n):
        got = _emulate_chunks(packed, width, tile, inclusive_p=inclusive_p,
                              seed=width)
        want = _k6(packed, width)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("tile", [3840, k6.SCAN_TILE])
def test_lookback_emulation_equals_pallas_interpret(tile):
    """At the TPU's tile width, on the TPU's padded lane, a run of one key
    spanning many of the card's tiles."""
    r = np.full(3 * tile, 9, np.uint32)
    s = np.concatenate([np.full(50, 9, np.uint32),
                        np.arange(100, 100 + TILE - 3 * tile,
                                  dtype=np.uint32)])
    packed = _padded(_sorted_pack(r, s), LENGTHS[0])
    want = np.asarray(jax_chunks(jnp.asarray(packed), interpret=True))
    got, maxw = _emulate_chunks(packed, TILE, tile, inclusive_p=0.2)
    np.testing.assert_array_equal(got, want)
    assert maxw == 3 * tile


_carries = st.tuples(st.integers(0, 1 << 20), st.integers(-1, 1 << 20)).map(
    lambda c: (c[0], min(c[1], c[0] - 1) if c[0] else -1))


@settings(max_examples=300, deadline=None)
@given(_carries, _carries, _carries)
def test_carry_composition_is_associative(a, b, c):
    """(R, B) with B < R or -1, as a tile's summary is; not commutative."""
    assert _compose(_compose(a, b), c) == _compose(a, _compose(b, c))
    assert _compose(CARRY_IDENTITY, a) == a == _compose(
        a, CARRY_IDENTITY)


@pytest.mark.parametrize("flag", [AGGREGATE, INCLUSIVE])
@pytest.mark.parametrize("carry", [((1 << 31) - 1, -1), ((1 << 31) - 1,
                                                          (1 << 31) - 2),
                                   (0, -1), (5, 0), (12345, 678)])
def test_status_word_round_trip(flag, carry):
    word = _status_word(flag, carry)
    assert 0 < word < 1 << 64
    assert _status_fields(word) == (flag, carry)


def test_status_word_rejects_what_does_not_fit():
    for carry in ((1 << 31, 0), (0, (1 << 31) - 1), (-1, -1), (0, -2)):
        with pytest.raises(ValueError):
            _status_word(AGGREGATE, carry)


@pytest.mark.parametrize("m, width, tiles, windows", [
    (0, 1, 0, 0), (1, 1, 1, 1), (k6.SCAN_TILE, 33792, 1, 1),
    (k6.SCAN_TILE + 1, 7, 2, -(-(k6.SCAN_TILE + 1) // 7)),
    ((1 << 31) - 1, 1 << 20, -(-((1 << 31) - 1) // k6.SCAN_TILE), 2048)])
def test_scratch_layout(m, width, tiles, windows):
    lay = k6.scratch_layout(m, width)
    assert (lay.tiles, lay.windows) == (tiles, windows)
    assert lay.word_bytes == 8 and lay.lookback_words == tiles
    # look-back words, the tile counter, the max weight, the window sums
    assert lay.bytes == 8 * tiles + 4 + 4 + 4 * windows
    assert (lay.counter_offset, lay.max_offset, lay.sums_offset) == (
        2 * tiles, 2 * tiles + 1, 2 * tiles + 2)


def test_scratch_layout_sizes_stated_in_perf():
    # (k)'s slab union: 2**25 + 2**20 positions in 1,024 windows
    lay = k6.scratch_layout(34_603_008, 33_792)
    assert (lay.tiles, lay.windows) == (3_466, 1_024)
    assert 8 * lay.lookback_words == 27_728 and lay.bytes == 31_832
    with pytest.raises(ValueError):
        k6.scratch_layout(1 << 31, 1)
