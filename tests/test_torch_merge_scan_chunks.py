"""Port parity of K6 and the chunked counts: ``ops/kernels/merge_scan_chunks``
(its plain version, which every CPU tensor takes) against the JAX
``merge_scan_chunks(..., interpret=True)`` on the same sorted lanes, and
``ops/merge_count`` (``merge_count_chunks``, ``merge_count_pallas``,
``presort_keys`` + ``merge_count_presorted``) against the JAX functions.
Every comparison is exact."""

import numpy as np
import pytest

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
