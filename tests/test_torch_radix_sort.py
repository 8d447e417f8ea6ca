"""Port parity: K2, the LSD radix sort (ops/kernels/radix_sort.py and
ops/sorting.py), against the JAX Pallas kernel in interpret mode and
numpy's stable order, on the adversarial key families of test_radix_sort.py.
Integer results, compared exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.ops.pallas.radix_sort import (  # noqa: E402
    num_radix_passes as jax_num_radix_passes, radix_pass_slots_pallas,
    radix_sort_pallas)

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops import sorting  # noqa: E402
from tpu_radix_join_torch.ops.kernels import radix_sort as k2  # noqa: E402

N = 4096    # the JAX tests' shape: the interpret kernel traces once per shift


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


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
@pytest.mark.parametrize("case", ["random", "sentinel_saturated",
                                  "duplicate_heavy"])
def test_pass_slots_equal_pallas_interpret(case, shift):
    keys = _family(case)
    want = np.asarray(radix_pass_slots_pallas(jnp.asarray(keys), shift=shift,
                                              interpret=True))
    got = k2.radix_pass_slots(lane_from_numpy(keys, "cpu"), shift=shift)
    np.testing.assert_array_equal(lane_to_numpy(got), want)


@pytest.mark.parametrize("case", FAMILIES)
def test_sort_equals_pallas_interpret_and_numpy(case):
    keys = _family(case)
    vals = np.arange(N, dtype=np.uint32)
    want = radix_sort_pallas((jnp.asarray(keys), jnp.asarray(vals)),
                             num_keys=1, interpret=True)
    got = k2.radix_sort([lane_from_numpy(keys, "cpu"),
                         lane_from_numpy(vals, "cpu")])
    # both sorts are stable, so even the value lane matches position for
    # position; numpy's stable argsort is the independent check
    order = np.argsort(keys, kind="stable")
    for g, w, ref in zip(got, want, (keys[order], vals[order])):
        np.testing.assert_array_equal(lane_to_numpy(g), np.asarray(w))
        np.testing.assert_array_equal(lane_to_numpy(g), ref)


@pytest.mark.parametrize("n", [0, 1, 2, 255, 3001])
def test_ragged_and_tiny_lengths(n):
    keys = _family("random", n) if n else np.zeros(0, np.uint32)
    got = sorting.sort_unstable(lane_from_numpy(keys, "cpu"))
    np.testing.assert_array_equal(lane_to_numpy(got), np.sort(keys))


def test_key_bounds_and_lexicographic_keys():
    rng = np.random.default_rng(9)
    hi = rng.integers(0, 1 << 8, N, dtype=np.uint32)
    lo = rng.integers(0, 1 << 16, N, dtype=np.uint32)
    want = radix_sort_pallas((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2,
                             key_bounds=(1 << 8, 1 << 16), interpret=True)
    got = sorting.sort_lex_unstable(lane_from_numpy(hi, "cpu"),
                                    lane_from_numpy(lo, "cpu"), num_keys=2,
                                    key_bounds=(1 << 8, 1 << 16))
    order = np.lexsort((lo, hi))
    for g, w, ref in zip(got, want, (hi[order], lo[order])):
        np.testing.assert_array_equal(lane_to_numpy(g), np.asarray(w))
        np.testing.assert_array_equal(lane_to_numpy(g), ref)
    k, v = sorting.sort_kv_unstable(lane_from_numpy(lo, "cpu"),
                                    lane_from_numpy(hi, "cpu"),
                                    key_bound=1 << 16)
    order = np.argsort(lo, kind="stable")
    np.testing.assert_array_equal(lane_to_numpy(k), lo[order])
    np.testing.assert_array_equal(lane_to_numpy(v), hi[order])


@pytest.mark.parametrize("bound", [None, 1, 2, 256, 257, 1 << 16,
                                   (1 << 24) + 1, 1 << 32])
def test_num_radix_passes_matches_jax(bound):
    assert k2.num_radix_passes(bound) == jax_num_radix_passes(bound)


def test_wrappers_reject_what_the_kernel_cannot_take():
    lane = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        k2.radix_sort([lane, torch.zeros(4, dtype=torch.int32)])
    with pytest.raises(ValueError):
        k2.radix_sort([lane.to(torch.int64)])
    with pytest.raises(ValueError):
        k2.radix_pass_slots(lane, shift=4)
    with pytest.raises(ValueError):
        k2.radix_sort([lane], num_keys=2)
