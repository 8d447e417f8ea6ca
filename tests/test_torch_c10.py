"""ROADMAP C10's repairs: the library baseline arms and the elastic
recovery make no host synchronisation on a CUDA lane, and stay what they
were on the CPU.

``partition_slots_plain`` (K4's plain version, ``partition_impl="sort"``)
and ``local_histogram``'s ``"sort"`` / ``"xla"`` arm held bit for bit
against the JAX package (``partition_slots_pallas(..., interpret=True)``,
``local_histogram(impl="xla")``) across dense, blocked, clipped, grouped
and all-invalid ids; ``partition_scatter_plain`` against the lanes JAX's
slots place.  That nothing of them is sized by the data is shown on
PyTorch's ``meta`` device, where every data-dependent output size (a
``bincount``, a boolean index, ``nonzero``) raises: the spellings the
card's sync guard caught.  ``execute_recovery`` on the CPU against the
numpy oracle, with ``robustness/recovery.py`` among the lint's hot files.
The ``JoinConfig`` helpers the port gained beside them equal JAX's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.core.config import JoinConfig as JJoinConfig  # noqa: E402
from tpu_radix_join.ops import radix as jradix  # noqa: E402
from tpu_radix_join.ops.pallas.partition import (  # noqa: E402
    partition_slots_pallas)

from tpu_radix_join_torch import Relation  # noqa: E402
from tpu_radix_join_torch.analysis import (register_builtin_rules,  # noqa: E402
                                           run_lint)
from tpu_radix_join_torch.analysis import rules_sync  # noqa: E402
from tpu_radix_join_torch.core.config import JoinConfig  # noqa: E402
from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops import radix as tradix  # noqa: E402
from tpu_radix_join_torch.ops.kernels import LAUNCHES  # noqa: E402
from tpu_radix_join_torch.ops.kernels import partition as k4  # noqa: E402
from tpu_radix_join_torch.robustness import recovery  # noqa: E402
from tpu_radix_join_torch.robustness.checkpoint import (  # noqa: E402
    PartitionManifest)

register_builtin_rules()


def _ids(n, hi, seed):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.uint32)


def _lane(a):
    return lane_from_numpy(np.asarray(a, np.uint32), "cpu")


# ids stay below 2**31: the TPU kernel and JAX's XLA histogram read int32
CASES = {
    "dense": (_ids(5000, 7, 2), dict(num_groups=7)),
    "dense_invalid": (_ids(5000, 10, 3), dict(num_groups=7)),
    "blocked_fits": (_ids(4000, 8, 4), dict(num_groups=8, capacity=1000)),
    "blocked_clipped": (_ids(4000, 8, 5), dict(num_groups=8, capacity=300)),
    "grouped_clipped": (_ids(6000, 16, 6),
                        dict(num_groups=16, group_size=4, capacity=900)),
    "all_invalid": (np.full(3000, 40, np.uint32),
                    dict(num_groups=32, capacity=64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_partition_slots_plain_equals_jax(case):
    ids, kw = CASES[case]
    want = partition_slots_pallas(jnp.asarray(ids), interpret=True, **kw)
    got = k4.partition_slots_plain(_lane(ids), kw["num_groups"],
                                   kw.get("group_size", 1),
                                   kw.get("capacity"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(lane_to_numpy(g),
                                      np.asarray(w).astype(np.uint32))


@pytest.mark.parametrize("case", list(CASES))
def test_partition_scatter_plain_places_jaxs_slots(case):
    """Each lane lands where JAX's slots say, the dropped tuples nowhere,
    every other slot holds its fill; the outputs are exactly ``out_size``
    slots (the trash slot sliced off) and contiguous."""
    ids, kw = CASES[case]
    g, size_g, cap = (kw["num_groups"], kw.get("group_size", 1),
                      kw.get("capacity"))
    slots, hist = (np.asarray(x).astype(np.uint32) for x in
                   partition_slots_pallas(jnp.asarray(ids), interpret=True,
                                          **kw))
    size = k4.out_size(ids.size, g, size_g, cap)
    rng = np.random.default_rng(7)
    lanes = [rng.integers(0, 1 << 32, ids.size, dtype=np.uint64)
             .astype(np.uint32) for _ in range(2)]
    fills = [0xFFFFFFFF, 0x80000001]
    outs, got_hist = k4.partition_scatter_plain(
        _lane(ids), [_lane(x) for x in lanes], fills, g, size_g, cap)
    keep = slots != k4.DROPPED
    for out, lane, fill in zip(outs, lanes, fills):
        want = np.full(size, fill, np.uint32)
        want[slots[keep]] = lane[keep]
        assert out.shape == (size,) and out.is_contiguous()
        np.testing.assert_array_equal(lane_to_numpy(out), want)
    np.testing.assert_array_equal(lane_to_numpy(got_hist), hist)


HIST_CASES = {
    "plain": (_ids(5000, 32, 8), None, 32),
    "valid_mask": (_ids(5000, 32, 9),
                   np.random.default_rng(9).random(5000) < 0.6, 32),
    "out_of_range": (_ids(5000, 100, 10), None, 32),
    "masked_out_of_range": (_ids(5000, 100, 11),
                            np.random.default_rng(11).random(5000) < 0.5,
                            64),
    "all_invalid": (_ids(5000, 32, 12), np.zeros(5000, bool), 32),
}


@pytest.mark.parametrize("impl", ["sort", "xla"])
@pytest.mark.parametrize("case", list(HIST_CASES))
def test_library_histogram_arm_equals_jax(case, impl):
    pid, valid, parts = HIST_CASES[case]
    want = jradix.local_histogram(
        jnp.asarray(pid), parts,
        None if valid is None else jnp.asarray(valid), impl="xla")
    before = LAUNCHES["baseline_histogram"]
    got = tradix.local_histogram(
        _lane(pid), parts, None if valid is None else torch.from_numpy(valid),
        impl=impl)
    assert LAUNCHES["baseline_histogram"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (parts,)
    np.testing.assert_array_equal(lane_to_numpy(got),
                                  np.asarray(want).astype(np.uint32))


def test_library_arms_size_nothing_by_the_data():
    """On ``meta`` tensors (shapes, no values) an output sized by the data
    cannot be made: the repaired arms run there; the spellings C10 found
    (``bincount``, boolean indexing) raise."""
    n = 4096
    ids = torch.empty(n, dtype=torch.int32, device="meta")
    lane = torch.empty(n, dtype=torch.int32, device="meta")
    valid = torch.empty(n, dtype=torch.bool, device="meta")
    slots, hist = k4.partition_slots_plain(ids, 32, 1, 200)
    assert slots.shape == (n,) and hist.shape == (32,)
    outs, hist = k4.partition_scatter_plain(ids, [lane, lane], [0, 1], 32,
                                            4, 300)
    assert [o.shape for o in outs] == [(8 * 300,)] * 2
    assert tradix.local_histogram(ids, 32, valid, impl="sort").shape == (32,)
    with pytest.raises((NotImplementedError, RuntimeError)):
        torch.bincount(ids.long(), minlength=33)
    with pytest.raises((NotImplementedError, RuntimeError)):
        lane[valid]


# ------------------------------------------------------------ the recovery

def _oracle(r_keys, s_keys, num_p):
    """Per-partition match counts of ``r ⋈ s`` by numpy."""
    out = {}
    for p in range(num_p):
        r = r_keys[(r_keys & (num_p - 1)) == p]
        s = s_keys[(s_keys & (num_p - 1)) == p]
        vals, counts = np.unique(r, return_counts=True)
        idx = np.searchsorted(vals, s)
        hit = (idx < vals.size) & (vals[np.minimum(idx, vals.size - 1)] == s)
        out[p] = int(counts[idx[hit]].sum())
    return out


@pytest.mark.parametrize("outer_kind", ["unique", "modulo"])
def test_execute_recovery_on_the_cpu_equals_the_oracle(outer_kind, tmp_path):
    n, num_p = 6000, 32
    kw = {"modulo": 700} if outer_kind == "modulo" else {}
    rk, _ = recovery.host_keys(Relation(n, 2, "unique", seed=1))
    sk, _ = recovery.host_keys(Relation(n, 2, outer_kind, seed=2, **kw))
    want = _oracle(rk, sk, num_p)
    plan = recovery.plan_recovery(
        num_nodes=2, num_partitions=num_p, lost_ranks=[1], epoch=1,
        weights=recovery.partition_weights(rk, sk, num_p))
    matches, counts = recovery.execute_recovery(plan, rk, sk, device="cpu",
                                                slab=512)
    assert counts == want and matches == sum(want.values())
    # resumed from a manifest holding half the partitions
    man = PartitionManifest(str(tmp_path / "m"), fingerprint="f")
    for p in range(0, num_p, 2):
        man.mark_done(p, want[p], 0, epoch=0)
    plan = recovery.plan_recovery(num_nodes=2, num_partitions=num_p,
                                  lost_ranks=[1], epoch=1, manifest=man)
    assert len(plan.recompute) == num_p // 2
    matches, counts = recovery.execute_recovery(plan, rk, sk, device="cpu",
                                                manifest=man)
    assert counts == want and matches == sum(want.values())


def test_recovery_is_a_hot_file_of_the_sync_rule(tmp_path):
    rel = "tpu_radix_join_torch/robustness/recovery.py"
    assert rel in rules_sync.HOT_FILES
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text("import torch\n\n\ndef sizes(x: torch.Tensor):\n"
                    "    return torch.stack([x, x]).cpu()\n")
    res = run_lint(str(tmp_path), rule_ids=["sync-point"],
                   baseline_path=None, paths=[str(path)])
    assert [f.rule for f in res.findings if f.path == rel] == ["sync-point"]


# --------------------------------------------------------- JoinConfig helpers

CONFIGS = [
    {},
    {"two_level": True},
    {"two_level": True, "local_fanout_bits": 7},
    {"network_fanout_bits": 8, "probe_algorithm": "bucket"},
    {"key_bits": 64},
    {"num_nodes": 4, "two_level": True, "network_fanout_bits": 6},
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_join_config_helpers_equal_jax(kw):
    got, want = JoinConfig(**kw), JJoinConfig(**kw)
    for name in ("total_fanout_bits", "total_partition_count",
                 "key_remainder_bits", "probe_shift_bits"):
        assert getattr(got, name) == getattr(want, name), name
    for size in (0, 1, 2, 3, 1000, 1 << 20, (1 << 20) + 1):
        assert got.bucket_count_for(size) == want.bucket_count_for(size)
    moved = got.replace(network_fanout_bits=4, two_level=True)
    assert isinstance(moved, JoinConfig) and moved is not got
    assert moved.total_fanout_bits == want.replace(
        network_fanout_bits=4, two_level=True).total_fanout_bits
    assert got.replace() == got
