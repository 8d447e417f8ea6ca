"""Port parity: K1, the partition histogram (ops/kernels/histogram.py and
ops/radix.local_histogram), against the JAX Pallas kernel run in interpret
mode on the CPU.  Integer results, compared exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.ops.pallas.histogram import histogram_pallas  # noqa: E402
from tpu_radix_join.ops.radix import local_histogram as jax_local_histogram  # noqa: E402,E501

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops.kernels import histogram as k1  # noqa: E402
from tpu_radix_join_torch.ops.radix import local_histogram  # noqa: E402


def _jax(pid, weights, bins):
    return np.asarray(histogram_pallas(
        jnp.asarray(pid), None if weights is None else jnp.asarray(weights),
        num_partitions=bins, interpret=True))


@pytest.mark.parametrize("n,bins", [(1, 1), (5000, 32), (16383, 128)])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_histogram_equals_pallas_interpret(n, bins, weighted):
    rng = np.random.default_rng(n + bins)
    # ids up to 2 * bins: the ones >= bins must be ignored
    pid = rng.integers(0, 2 * bins, n, dtype=np.uint32)
    w = rng.integers(0, 1 << 32, n, dtype=np.uint32) if weighted else None
    got = k1.histogram(lane_from_numpy(pid, "cpu"),
                       None if w is None else lane_from_numpy(w, "cpu"),
                       num_bins=bins)
    assert got.dtype == torch.int32 and got.shape == (bins,)
    np.testing.assert_array_equal(lane_to_numpy(got), _jax(pid, w, bins))


def test_sentinel_ids_and_one_hot_bin():
    pid = np.array([0xFFFFFFFF, 0xFFFFFFFE, 0x80000000, 3, 3, 3, 31],
                   np.uint32)
    got = k1.histogram_plain(lane_from_numpy(pid, "cpu"), None, 32)
    np.testing.assert_array_equal(lane_to_numpy(got), _jax(pid, None, 32))
    assert lane_to_numpy(got)[3] == 3


def test_local_histogram_with_valid_mask_matches_jax():
    rng = np.random.default_rng(4)
    pid = rng.integers(0, 32, 9000, dtype=np.uint32)
    valid = rng.random(9000) < 0.7
    want = np.asarray(jax_local_histogram(jnp.asarray(pid), 32,
                                          valid=jnp.asarray(valid),
                                          impl="pallas_interpret"))
    got = local_histogram(lane_from_numpy(pid, "cpu"), 32,
                          valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(lane_to_numpy(got), want)


def test_wrapper_rejects_bad_inputs():
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        k1.histogram(ids.to(torch.int64), num_bins=4)
    with pytest.raises(ValueError):
        k1.histogram(ids, num_bins=0)
    with pytest.raises(ValueError):
        k1.histogram(ids, torch.zeros(4, dtype=torch.int32), num_bins=4)
