"""Port parity: the pieces of K2's onesweep sort that the CPU can check.

The digit table of a sort (``radix_histograms_plain``, which the card's
histogram kernel is held to) against numpy's per-pass ``bincount``, its pass
count against the JAX ``num_radix_passes``, the onesweep arithmetic (digit
bases from the table, per-tile counts carried across tiles, ranks in input
order) against the plain pass, the wrapper's scratch sizing, and what the
wrapper rejects.  Integer results, compared exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.ops.pallas.radix_sort import (  # noqa: E402
    num_radix_passes as jax_num_radix_passes, radix_pass_slots_pallas)
import jax.numpy as jnp  # noqa: E402

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops.kernels import radix_sort as k2  # noqa: E402

N = 4096
TILE = k2.TILE_KEYS


def _family(case, n=N):
    rng = np.random.default_rng(sum(map(ord, case)))
    return {
        "random": rng.integers(0, 1 << 32, n, dtype=np.uint32),
        "sentinel_saturated": rng.choice(
            np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32), n),
        "duplicate_heavy": (rng.integers(0, 1 << 32, n) % 7).astype(np.uint32),
        "presorted": np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32)),
        "reverse_sorted": np.sort(
            rng.integers(0, 1 << 32, n, dtype=np.uint32))[::-1].copy(),
        "all_equal": np.full(n, 0xDEADBEEF, np.uint32),
    }[case]


FAMILIES = ["random", "sentinel_saturated", "duplicate_heavy", "presorted",
            "reverse_sorted", "all_equal"]


def _numpy_table(keys, bounds):
    """[passes, 256] per-pass digit bincounts, least significant key
    first, each key's passes from shift 0 up."""
    rows = []
    for lane, bound in reversed(list(zip(keys, bounds))):
        for p in range(jax_num_radix_passes(bound)):
            d = (lane.astype(np.int64) >> (8 * p)) & 0xFF
            rows.append(np.bincount(d, minlength=256))
    return np.stack(rows)


@pytest.mark.parametrize("case", FAMILIES)
def test_histogram_table_equals_numpy_bincount(case):
    keys = _family(case)
    got = k2.radix_histograms([lane_from_numpy(keys, "cpu")])
    want = _numpy_table([keys], [None])
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 256)
    np.testing.assert_array_equal(lane_to_numpy(got.reshape(-1)),
                                  want.reshape(-1))
    assert (want.sum(1) == N).all()


@pytest.mark.parametrize("bounds", [
    (None,), (1,), (256,), (257,), (1 << 16,), ((1 << 24) + 1,),
    (64, None), (None, 1 << 12), (32, 1 << 20, None), (2, 2, 2)])
def test_histogram_table_lex_keys_and_bounds(bounds):
    rng = np.random.default_rng(len(bounds) * 31 + sum(b or 7 for b in bounds))
    keys = [rng.integers(0, b or 1 << 32, 3001, dtype=np.uint64)
            .astype(np.uint32) for b in bounds]
    got = k2.radix_histograms([lane_from_numpy(a, "cpu") for a in keys],
                              key_bounds=bounds)
    want = _numpy_table(keys, bounds)
    assert got.shape[0] == sum(jax_num_radix_passes(b) for b in bounds)
    assert got.shape[0] == len(k2.pass_plan(len(bounds), bounds))
    np.testing.assert_array_equal(lane_to_numpy(got.reshape(-1)),
                                  want.reshape(-1))


@pytest.mark.parametrize("num_keys, bounds", [
    (1, None), (1, (1 << 8,)), (2, (64, None)), (2, None),
    (3, (32, None, None))])
def test_pass_plan_runs_least_significant_key_first(num_keys, bounds):
    plan = k2.pass_plan(num_keys, bounds)
    want = []
    for ki in range(num_keys - 1, -1, -1):
        b = None if bounds is None else bounds[ki]
        want += [(ki, 8 * p) for p in range(jax_num_radix_passes(b))]
    assert plan == want


def _onesweep_slots(keys, shift, counts):
    """The card's pass in numpy: digit bases from the histogram row, each
    tile's per-digit counts, their exclusive prefix over the tiles before
    it (what the look-back resolves), and ranks in input order."""
    d = (keys.astype(np.int64) >> shift) & 0xFF
    base = np.cumsum(counts) - counts
    slots = np.empty(keys.size, np.int64)
    before = np.zeros(256, np.int64)
    for t in range(0, keys.size, TILE):
        g = d[t:t + TILE]
        order = np.argsort(g, kind="stable")
        tile_counts = np.bincount(g, minlength=256)
        tile_start = np.cumsum(tile_counts) - tile_counts
        local = np.empty(g.size, np.int64)
        local[order] = np.arange(g.size)
        slots[t:t + g.size] = base[g] + before[g] + local - tile_start[g]
        before += tile_counts
    return slots.astype(np.uint32)


@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 17])
@pytest.mark.parametrize("case", ["random", "sentinel_saturated",
                                  "all_equal"])
@pytest.mark.parametrize("shift", [0, 24])
def test_onesweep_arithmetic_equals_plain_pass(n, case, shift):
    keys = _family(case, n)
    lane = lane_from_numpy(keys, "cpu")
    row = k2.radix_histograms_plain([lane])[shift // 8]
    got = _onesweep_slots(keys, shift, lane_to_numpy(row).astype(np.int64))
    want = lane_to_numpy(k2.radix_pass_slots(lane, shift=shift))
    np.testing.assert_array_equal(got, want)
    if n == N:
        np.testing.assert_array_equal(got, np.asarray(radix_pass_slots_pallas(
            jnp.asarray(keys), shift=shift, interpret=True)))


@pytest.mark.parametrize("n, tiles", [
    (0, 0), (1, 1), (TILE, 1), (TILE + 1, 2), ((1 << 30) + 1, (1 << 18) + 1),
    ((1 << 32) - 1, 1 << 20)])
@pytest.mark.parametrize("passes", [1, 4, 9])
def test_scratch_layout(n, tiles, passes):
    lay = k2.scratch_layout(n, passes)
    assert lay.tiles == tiles
    assert lay.lookback_words == 256 * tiles
    # 64-bit words: 32 status bits over a 32-bit count that reaches n
    assert lay.word_bytes == 8 and n < 1 << (8 * lay.word_bytes - 32)
    assert lay.table_words == 256 * passes and lay.counters == passes
    assert lay.bytes == 8 * lay.lookback_words + 4 * (
        lay.table_words + lay.counters + (lay.table_words + lay.counters) % 2)


def test_scratch_layout_sizes_stated_in_perf():
    # 40M keys (the packed union) and 2**27 (the presort): 20 MB and 67 MB
    assert k2.scratch_layout(40_000_000, 4).lookback_words * 8 == 20_000_768
    assert k2.scratch_layout(1 << 27, 4).lookback_words * 8 == 67_108_864
    with pytest.raises(ValueError):
        k2.scratch_layout(1 << 32, 4)


def test_launch_counter_registered():
    from tpu_radix_join_torch.ops import kernels
    assert {"radix_histogram", "radix_pass"} <= set(kernels.LAUNCHES)


def _lanes(k, n=8, dtype=torch.int32, device="cpu"):
    return [torch.zeros(n, dtype=dtype, device=device) for _ in range(k)]


@pytest.mark.parametrize("what", ["five_lanes", "five_key_lanes", "int64",
                                  "unequal", "bad_shift", "bad_bounds"])
def test_wrapper_rejects(what):
    if what == "five_lanes":
        # lanes off the CPU go to the card, which moves at most four
        with pytest.raises(ValueError, match="at most 4 lanes"):
            k2.radix_sort(_lanes(5, device="meta"))
    elif what == "five_key_lanes":
        with pytest.raises(ValueError, match="at most 4 key lanes"):
            k2.radix_histograms(_lanes(5, device="meta"))
    elif what == "int64":
        with pytest.raises(ValueError, match="int32"):
            k2.radix_sort(_lanes(1, dtype=torch.int64))
        with pytest.raises(ValueError, match="int32"):
            k2.radix_histograms(_lanes(1, dtype=torch.int64))
    elif what == "unequal":
        with pytest.raises(ValueError, match="equal-length"):
            k2.radix_sort([*_lanes(1), *_lanes(1, n=4)])
        with pytest.raises(ValueError, match="equal-length"):
            k2.radix_histograms([*_lanes(1), *_lanes(1, n=4)])
    elif what == "bad_shift":
        for shift in (4, 32, -8):
            with pytest.raises(ValueError, match="shift"):
                k2.radix_pass_slots(_lanes(1)[0], shift=shift)
    else:
        with pytest.raises(ValueError, match="key_bounds"):
            k2.radix_histograms(_lanes(2), key_bounds=(None,))


def test_four_meta_lanes_pass_the_lane_check():
    # four lanes are accepted; only the device is refused
    with pytest.raises(ValueError, match="cpu or cuda"):
        k2.radix_sort(_lanes(4, device="meta"))
