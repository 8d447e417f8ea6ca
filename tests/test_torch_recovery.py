"""Elastic recovery of the port (robustness/recovery.py, the engine's
elastic wrapper) against the JAX package.

  * host only: ``plan_recovery`` (resumed, recompute, reassignment, with
    and without ``joined_ranks``, load-aware and round-robin),
    ``partition_weights``, ``host_keys`` of 32- and 64-bit relations and
    ``execute_recovery``'s per-partition counts equal JAX's on the same
    seeded inputs;
  * the manifest's fence under a hedge (first writer wins, a late
    original loses to the hedge and a hedge after the original loses, a
    claim advises and only a done line decides) equals JAX's;
  * one 4-rank gloo world (tests/torch_dist_worker.py) against JAX's
    ``HashJoin(num_nodes=4, network_fanout_bits=3)`` on the virtual mesh:
    a simulated rank death at boundaries 1, 2 and 3, the manifest resume
    and the non-elastic engine's ``rank_lost`` class give the same
    matches, partition counts, recovery diagnostics and counters.

Tolerance 0 throughout."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.core.config import JoinConfig as JConfig  # noqa: E402
from tpu_radix_join.data.relation import Relation as JRelation  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.operators.hash_join import HashJoin as JHashJoin  # noqa
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402
from tpu_radix_join.robustness import recovery as jrec  # noqa: E402
from tpu_radix_join.robustness.checkpoint import (  # noqa: E402
    PartitionManifest as JManifest)

from tpu_radix_join_torch.data.relation import Relation  # noqa: E402
from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    MEPOCH, RANKLOST, RECOVERMS, RECOVERN, Measurements)
from tpu_radix_join_torch.robustness import faults  # noqa: E402
from tpu_radix_join_torch.robustness import recovery as trec  # noqa: E402
from tpu_radix_join_torch.robustness.checkpoint import (  # noqa: E402
    PartitionManifest)
from tpu_radix_join_torch.robustness.membership import RankLost  # noqa
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4
NUM_P = 8
COUNTERS = ("RANKLOST", "MEPOCH", "RECOVERN", "HEDGED", "HEDGEWIN",
            "SPECWASTE", "RANKJOIN")


def _oracle(n, seed):
    rng = np.random.default_rng(seed)
    rk = (rng.permutation(n) + 1).astype(np.uint32)
    sk = rng.integers(1, n + 1, size=n).astype(np.uint32)
    return rk, sk


class _Done:
    def __init__(self, done):
        self.done = done

    def completed(self):
        return dict(self.done)


# ------------------------------------------------------------ host only
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("lost,joined,resumed", [
    ([3], (), {}),
    ([3], (), {0: 5, 7: 9}),
    ([1, 2], (), {4: 1}),
    ([], (4, 5), {}),
    ([0], (4,), {2: 3, 3: 3}),
])
def test_plan_recovery_equals_jax(lost, joined, resumed, weights):
    rk, sk = _oracle(1 << 10, 11)
    done = {p: {"count": c, "owner": p % N, "epoch": 0}
            for p, c in resumed.items()}
    kw = dict(num_nodes=N, num_partitions=NUM_P, lost_ranks=lost, epoch=2,
              manifest=_Done(done), joined_ranks=joined)
    tw = trec.partition_weights(rk, sk, NUM_P) if weights else None
    jw = jrec.partition_weights(rk, sk, NUM_P) if weights else None
    got = trec.plan_recovery(weights=tw, **kw)
    want = jrec.plan_recovery(weights=jw, **kw)
    for f in ("epoch", "lost_ranks", "survivors", "num_partitions",
              "resumed", "recompute", "reassignment"):
        assert getattr(got, f) == getattr(want, f), f
    assert {k: v for k, v in got.to_diag().items()
            if k not in ("replan_strategy", "replan_predicted_ms")} == \
        {k: v for k, v in want.to_diag().items()
         if k not in ("replan_strategy", "replan_predicted_ms")}


def test_plan_recovery_no_survivors_raises_and_replans_on_h100():
    with pytest.raises(RankLost):
        trec.plan_recovery(num_nodes=2, num_partitions=4, lost_ranks=[0, 1],
                           epoch=1)
    from tpu_radix_join_torch.planner.cost_model import Workload
    from tpu_radix_join_torch.planner.profile import load_profile
    work = Workload(r_tuples=1 << 20, s_tuples=1 << 20, num_nodes=2)
    plan = trec.plan_recovery(num_nodes=2, num_partitions=8, lost_ranks=[1],
                              epoch=1, profile=load_profile("h100"),
                              workload=work)
    assert plan.replan_strategy and plan.replan_predicted_ms > 0
    # advice only: h100 prices no interconnect, so it refuses a mesh of
    # several survivors, and a broken profile is ignored the same way
    for profile in (load_profile("h100"), object()):
        other = trec.plan_recovery(num_nodes=4, num_partitions=8,
                                   lost_ranks=[3], epoch=1, profile=profile,
                                   workload=dataclasses.replace(
                                       work, num_nodes=4))
        assert other.replan_strategy == "" and other.survivors == (0, 1, 2)


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_partition_weights_equal_jax(seed):
    rng = np.random.default_rng(seed)
    rk = rng.integers(0, 1 << 32, size=3000, dtype=np.uint64).astype(
        np.uint32)
    sk = rng.integers(0, 1 << 32, size=2000, dtype=np.uint64).astype(
        np.uint32)
    for p in (1, 8, 32, 1024):
        np.testing.assert_array_equal(trec.partition_weights(rk, sk, p),
                                      jrec.partition_weights(rk, sk, p))
        assert trec.partition_weights(rk, sk, p).dtype == np.float32


@pytest.mark.parametrize("kind,key_bits,kw", [
    ("unique", 32, {}), ("modulo", 32, {"modulo": 77}),
    ("zipf", 32, {"zipf_theta": 0.75, "key_domain": 4096}),
    ("unique", 64, {}),
])
def test_host_keys_equal_jax(kind, key_bits, kw):
    args = dict(global_size=4096, num_nodes=N, kind=kind, seed=7,
                key_bits=key_bits, **kw)
    keys, hi = trec.host_keys(Relation(**args))
    jkeys, jhi = jrec.host_keys(JRelation(**args))
    np.testing.assert_array_equal(keys, jkeys)
    if key_bits == 64:
        np.testing.assert_array_equal(hi, jhi)
    else:
        assert hi is None and jhi is None


@pytest.mark.parametrize("key_bits", [32, 64])
def test_execute_recovery_counts_equal_jax(tmp_path, key_bits):
    n = 1 << 10
    rk, sk = _oracle(n, 3)
    rhi = shi = None
    if key_bits == 64:
        rhi = (rk * np.uint32(3)) & np.uint32(7)
        shi = (sk * np.uint32(3)) & np.uint32(7)
    true = np.bincount(sk & (NUM_P - 1), minlength=NUM_P)
    mans = []
    for cls, d in ((PartitionManifest, "t"), (JManifest, "j")):
        man = cls(str(tmp_path / d), fingerprint={"t": 1})
        man.mark_many({p: int(true[p]) for p in range(3)},
                      owner_of=lambda p: p % N)
        mans.append(man)
    tm, jm = Measurements(), JMeasurements()
    kw = dict(num_nodes=N, num_partitions=NUM_P, lost_ranks=[3], epoch=1,
              weights=trec.partition_weights(rk, sk, NUM_P))
    tplan = trec.plan_recovery(manifest=mans[0], **kw)
    jplan = jrec.plan_recovery(manifest=mans[1], **kw)
    got = trec.execute_recovery(tplan, rk, sk, rhi, shi, slab=256,
                                measurements=tm, manifest=mans[0],
                                device="cpu")
    want = jrec.execute_recovery(jplan, rk, sk, rhi, shi, slab=256,
                                 measurements=jm, manifest=mans[1])
    assert got == want
    assert tm.counters[RECOVERN] == jm.counters["RECOVERN"] == NUM_P - 3
    assert RECOVERMS in tm.counters
    assert mans[0].completed() == mans[1].completed()
    # one survivor's share at a time tiles the recompute, as in JAX
    for r in tplan.survivors:
        assert (trec.execute_recovery(tplan, rk, sk, rhi, shi, slab=256,
                                      only_rank=r, device="cpu")
                == jrec.execute_recovery(jplan, rk, sk, rhi, shi, slab=256,
                                         only_rank=r))


def test_execute_recovery_without_work_touches_nothing():
    plan = trec.plan_recovery(num_nodes=N, num_partitions=NUM_P,
                              lost_ranks=[3], epoch=1,
                              manifest=_Done({p: {"count": 1, "owner": 0,
                                                  "epoch": 0}
                                              for p in range(NUM_P)}))
    assert plan.recompute == ()
    got = trec.execute_recovery(plan, np.zeros(0, np.uint32),
                                np.zeros(0, np.uint32), device="cuda")
    assert got == (NUM_P, {p: 1 for p in range(NUM_P)})


# ------------------------------------------------- the fence under a hedge
def _fence_script(man):
    """The JAX package's hedge-fence scenarios on ``man``; every verdict
    and audit, in order."""
    out = [man.mark_done(3, 111, 5, epoch=1),      # the hedge, first
           man.mark_done(3, 111, 7, epoch=1),      # the late original
           man.mark_done(4, 40, 7, epoch=1),       # the original, first
           man.claim(4, owner=5, epoch=1),         # a hedge's claim: refused
           man.mark_done(4, 40, 5, epoch=1),       # the hedge writes anyway
           man.claim(2, owner=4, epoch=1),
           man.claim(2, owner=4, epoch=1),         # idempotent
           man.claim(2, owner=6, epoch=1),         # a rival: refused
           man.claim(2, owner=6, epoch=2),         # a newer epoch wins
           man.mark_done(2, 9, 4, epoch=1),
           man.mark_done(2, 12, 6, epoch=2)]       # a done line decides
    aud = man.audit()
    return out, man.completed(), man.claims(), aud


def test_manifest_fence_equals_jax(tmp_path):
    got = _fence_script(PartitionManifest(str(tmp_path / "t"),
                                          fingerprint={"t": 2}))
    want = _fence_script(JManifest(str(tmp_path / "j"),
                                   fingerprint={"t": 2}))
    assert got == want
    out, done, claims, aud = got
    assert done[3]["owner"] == 5 and done[4]["owner"] == 7
    assert done[2] == {"count": 12, "owner": 6, "epoch": 2}
    assert aud["fenced_duplicates"] == {3: 1, 4: 1}
    # a reopened manifest reads the same verdicts
    again = PartitionManifest(str(tmp_path / "t"), fingerprint={"t": 2})
    assert again.completed() == done


# ------------------------------------------------------------ four ranks
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_recovery"),
                      deadline_s=240.0)
    yield pool
    pool.close()


def _jax_elastic(rk, sk, faults_=(), manifest=None, elastic=True, seed=0,
                 tmp=None):
    eng = JHashJoin(JConfig(num_nodes=N, network_fanout_bits=3,
                            verify="check"))
    eng.elastic = elastic
    m = JMeasurements()
    eng.measurements = m
    if manifest is not None:
        man = JManifest(str(tmp / "jm"), fingerprint={"t": 1})
        man.mark_many({int(p): int(c) for p, c in manifest.items()},
                      owner_of=lambda p: p % 4)
        eng.partition_manifest = man
    inj = jfaults.FaultInjector(seed=seed, measurements=m)
    for site, at in faults_:
        inj.arm(site, at=at)
    rid = jnp.arange(len(rk), dtype=jnp.uint32)
    out = {}
    try:
        with inj:
            res = eng.join_arrays(JBatch(key=jnp.asarray(rk), rid=rid),
                                  JBatch(key=jnp.asarray(sk), rid=rid))
        out.update(matches=res.matches, ok=res.ok,
                   partition_counts=np.asarray(res.partition_counts).tolist(),
                   diagnostics=res.diagnostics)
    except Exception as e:
        out.update(raised=type(e).__name__,
                   failure_class=getattr(e, "failure_class", None))
    out["counters"] = {k: int(v) for k, v in m.counters.items()}
    return out


def _task(rk, sk, **kw):
    rid = list(range(len(rk)))
    return dict({"kind": "elastic",
                 "config": {"num_nodes": N, "network_fanout_bits": 3,
                            "verify": "check"},
                 "lanes": {"r": [rk.tolist(), rid], "s": [sk.tolist(), rid]},
                 "engine": {"elastic": True}}, **kw)


def _same(got, want):
    for key in ("matches", "ok", "partition_counts", "raised",
                "failure_class"):
        assert got.get(key) == want.get(key), key
    if "diagnostics" in want:
        for key in ("recovered", "lost_ranks", "recovered_partitions",
                    "resumed_partitions", "membership_epoch", "survivors",
                    "recovery_assignment", "failure_class", "hedged",
                    "hedgewin", "specwaste", "hedged_partitions", "regrown",
                    "joined_ranks_admitted", "straggler"):
            assert got["diagnostics"].get(key) == \
                want["diagnostics"].get(key), key
    for key in COUNTERS:
        assert got["counters"].get(key, 0) == want["counters"].get(key, 0), \
            key


@pytest.mark.parametrize("at", [1, 2, 3])
def test_rank_death_at_each_boundary_equals_jax(world, at):
    """A simulated death fired on every rank at boundary ``at``: every rank
    recomputes every partition from the host lanes and returns JAX's exact
    recovered result, RANKLOST 1 and MEPOCH 1."""
    n = 1 << 11
    rk, sk = _oracle(n, 1)
    arms = [[faults.RANK_DEATH, at]]
    outs = world.run(_task(rk, sk, faults=arms, seed=at))
    want = _jax_elastic(rk, sk, faults_=[(jfaults.RANK_DEATH, at)], seed=at)
    assert want["matches"] == n and want["diagnostics"]["lost_ranks"] == [3]
    for got in outs:
        _same(got, want)
    assert outs[0]["counters"][RANKLOST] == 1
    assert outs[0]["counters"][MEPOCH] == 1
    assert outs[0]["counters"][RECOVERN] == NUM_P


def test_manifest_resume_equals_jax(world, tmp_path):
    n = 1 << 11
    rk, sk = _oracle(n, 2)
    true = np.bincount(sk & (NUM_P - 1), minlength=NUM_P)
    lines = {str(p): int(true[p]) for p in range(4)}
    outs = world.run(_task(rk, sk, faults=[[faults.RANK_DEATH, 2]], seed=9,
                           manifest=lines))
    want = _jax_elastic(rk, sk, faults_=[(jfaults.RANK_DEATH, 2)], seed=9,
                        manifest={int(p): c for p, c in lines.items()},
                        tmp=tmp_path)
    assert want["diagnostics"]["resumed_partitions"] == [0, 1, 2, 3]
    for got in outs:
        _same(got, want)
        assert 0 < got["counters"][RECOVERN] < NUM_P
        assert got["audit_total"] == n


def test_non_elastic_engine_classifies_rank_death(world):
    n = 1 << 10
    rk, sk = _oracle(n, 5)
    outs = world.run(_task(rk, sk, faults=[[faults.RANK_DEATH, 1]], seed=1,
                           engine={"elastic": False}))
    want = _jax_elastic(rk, sk, faults_=[(jfaults.RANK_DEATH, 1)], seed=1,
                        elastic=False)
    assert want["raised"] == "RankLost"
    for got in outs:
        _same(got, want)
        assert got["failure_class"] == "rank_lost"


def test_membership_epoch_keys_the_capacity_cache(tmp_path):
    """The cache fingerprint carries the membership epoch: capacities of
    the boot mesh never warm-start the mesh after a loss."""
    import tpu_radix_join_torch as tx
    from tpu_radix_join_torch.robustness.membership import (LeaseBoard,
                                                            MembershipView)
    eng = tx.HashJoin(tx.JoinConfig(), device="cpu")
    assert eng._cache_config_fp()["membership_epoch"] == 0
    jeng = JHashJoin(JConfig(num_nodes=1))
    assert eng._cache_config_fp() == jeng._cache_config_fp()
    view = MembershipView(LeaseBoard(str(tmp_path), rank=0, num_ranks=2))
    eng.membership = view
    view.declare_lost(1, cause="test")
    assert eng._cache_config_fp()["membership_epoch"] == 1


def test_join_recovers_from_relation_specs_on_the_host():
    """``HashJoin.join`` hands recovery its Relation specs: a recovery of a
    one-rank engine of 4 nodes' worth of partitions regenerates them with
    the native generator and hits the oracle."""
    import tpu_radix_join_torch as tx
    eng = tx.HashJoin(tx.JoinConfig(network_fanout_bits=3), device="cpu")
    eng.elastic = True
    inner = tx.Relation(1 << 12, 1, "unique", seed=3)
    outer = tx.Relation(1 << 12, 1, "unique", seed=4)
    lost = RankLost(5, 1, "test")
    r, s = eng.place(inner), eng.place(outer)
    eng.elastic_inputs = trec.relation_inputs(inner, outer)
    res = eng._recover_join(r, s, lost, 1, lost_nodes=[1],
                            joined_nodes=[1, 2])
    assert res.ok and res.matches == 1 << 12
    assert res.diagnostics["survivors"] == [0, 2]
    assert set(eng.last_recovery) >= {"regen_s", "recompute_s", "total_s"}


def test_classified_failure_leaves_the_elastic_path_at_once(tmp_path):
    """A deadline that expires inside an elastic join is a classified
    verdict, not a transport error: the query fails ``deadline_exceeded``
    at once instead of waiting a lapse window (10 s here) for a lease to
    explain it."""
    import time

    import tpu_radix_join_torch.service as tsvc
    from tpu_radix_join_torch import JoinConfig
    from tpu_radix_join_torch.robustness.membership import (LeaseBoard,
                                                            MembershipView)

    class TickClock:
        t = 0.0

        def __call__(self):
            self.t += 1.0
            return self.t - 1.0

    board = LeaseBoard(str(tmp_path), rank=0, num_ranks=1, lease_s=5.0)
    sess = tsvc.JoinSession(JoinConfig(), device="cpu", clock=TickClock(),
                            membership=MembershipView(board), elastic=True)
    try:
        # admitted, generated, placed, then the engine's start: past 3.5 s
        sess.submit(tsvc.QueryRequest("late", tuples_per_node=256,
                                      deadline_s=3.5))
        t0 = time.monotonic()
        out = sess.run_next()
        waited = time.monotonic() - t0
    finally:
        sess.close()
    assert out.failure_class == "deadline_exceeded"
    assert "'start'" in out.detail
    assert waited < board.lapse_window_s / 2
