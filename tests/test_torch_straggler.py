"""Straggler detection and hedging (robustness/straggler.py) and the
engine's hedge and regrowth paths, against the JAX package.

  * host only: ``StragglerDetector``'s verdicts over seeded progress
    streams (threshold, dwell, min_outstanding, ties to the smallest
    rank), ``board_progress``, ``unfinished_partitions`` and
    ``score_hedge`` equal JAX's;
  * one 4-rank gloo world (tests/torch_dist_worker.py) against JAX's
    ``HashJoin(num_nodes=4, network_fanout_bits=3)`` on the virtual mesh:
    ``compute.straggle`` with the hedge on (a one-lease membership and a
    manifest on every rank) and off, and regrowth under
    ``membership.rank_join`` with ``elastic_grow``, give the same matches,
    partition counts, diagnostics and counters (HEDGED, HEDGEWIN,
    SPECWASTE, RANKJOIN, MEPOCH, RECOVERN).

Tolerance 0 throughout."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.core.config import JoinConfig as JConfig  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.operators.hash_join import HashJoin as JHashJoin  # noqa
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402
from tpu_radix_join.robustness import straggler as jstr  # noqa: E402
from tpu_radix_join.robustness.checkpoint import (  # noqa: E402
    PartitionManifest as JManifest)
from tpu_radix_join.robustness.membership import (  # noqa: E402
    LeaseBoard as JBoard, MembershipView as JView)

from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    HEDGED, HEDGEWIN, MEPOCH, RANKJOIN, RANKLOST, SPECWASTE, Measurements)
from tpu_radix_join_torch.robustness import faults  # noqa: E402
from tpu_radix_join_torch.robustness import straggler as tstr  # noqa: E402
from tpu_radix_join_torch.robustness.checkpoint import (  # noqa: E402
    PartitionManifest)
from tpu_radix_join_torch.robustness.membership import LeaseBoard  # noqa
from test_torch_recovery import _oracle, _same, _task  # noqa: E402
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4


# ------------------------------------------------------------ host only
def _stream(seed, steps=40):
    """A seeded progress stream: per step ``{rank: done}`` of 2-5 ranks
    (some rank slower), and the outstanding partitions of each."""
    rng = random.Random(seed)
    ranks = rng.sample(range(6), rng.randint(2, 5))
    done = {r: 0 for r in ranks}
    rate = {r: rng.choice([0, 1, 1, 2, 3]) for r in ranks}
    out = []
    for _ in range(steps):
        for r in ranks:
            done[r] += rate[r] if rng.random() < 0.8 else 0
        if rng.random() < 0.1:
            r = rng.choice(ranks)
            rate[r] = rng.choice([0, 1, 3])
        share = rng.randint(4, 40)
        out.append((dict(done), {r: max(0, share - d)
                                 for r, d in done.items()}))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_detector_verdicts_equal_jax(seed):
    rng = random.Random(1000 + seed)
    kw = dict(threshold=rng.choice([0.3, 0.5, 0.7]),
              min_outstanding=rng.randint(1, 4),
              dwell_checks=rng.randint(1, 3))
    got_det, want_det = tstr.StragglerDetector(**kw), \
        jstr.StragglerDetector(**kw)
    fired = 0
    for progress, outstanding in _stream(seed):
        got = got_det.observe(progress, outstanding)
        want = want_det.observe(progress, outstanding)
        assert (None if got is None else
                (got.rank, got.progress, got.median, got.outstanding)) == \
            (None if want is None else
             (want.rank, want.progress, want.median, want.outstanding))
        fired += got is not None
        if got is not None:
            exc, jexc = got.to_exc(3), want.to_exc(3)
            assert str(exc) == str(jexc) and exc.epoch == 3


def test_detector_guards_equal_jax():
    for bad in ({"threshold": 0.0}, {"threshold": 1.0},
                {"dwell_checks": 0}):
        with pytest.raises(ValueError):
            tstr.StragglerDetector(**bad)
    det = tstr.StragglerDetector(threshold=0.6, dwell_checks=1)
    v = det.observe({3: 1, 1: 1, 0: 10, 2: 10}, {1: 9, 3: 9})
    assert v is not None and v.rank == 1       # ties: the smallest rank
    assert det.observe({0: 0}, {0: 8}) is None
    assert det.observe({0: 0, 1: 0}, {0: 8}) is None


def test_board_progress_and_unfinished_equal_jax(tmp_path):
    boards = []
    for cls, d in ((LeaseBoard, "t"), (JBoard, "j")):
        a = cls(str(tmp_path / d), rank=0, num_ranks=3, lease_s=5.0)
        b = cls(str(tmp_path / d), rank=1, num_ranks=3, lease_s=5.0)
        a.progress_of = lambda: 7
        a.heartbeat(0)
        b.heartbeat(0)
        boards.append(a)
    assert tstr.board_progress(boards[0], [0, 1, 2]) == \
        jstr.board_progress(boards[1], [0, 1, 2]) == {0: 7}
    mans = []
    for cls, d in ((PartitionManifest, "tm"), (JManifest, "jm")):
        man = cls(str(tmp_path / d), fingerprint={"t": 1})
        man.mark_many({1: 3, 5: 4}, owner_of=lambda p: p % 4)
        mans.append(man)
    for rank in range(4):
        assert tstr.unfinished_partitions(16, lambda p: p % 4, rank,
                                          mans[0]) == \
            jstr.unfinished_partitions(16, lambda p: p % 4, rank, mans[1])


def test_score_hedge_equals_jax(tmp_path):
    tm, jm = Measurements(), JMeasurements()
    scores = []
    for cls, d, m in ((PartitionManifest, "t", tm), (JManifest, "j", jm)):
        man = cls(str(tmp_path / d), fingerprint={"t": 5})
        man.mark_done(0, 5, 2, epoch=1)        # the hedge's writer won
        man.mark_done(1, 5, 3, epoch=1)        # the straggler landed first
        man.mark_done(2, 5, 3, epoch=1)
        man.mark_done(2, 5, 1, epoch=1)        # a late hedge: fenced
        scores.append(tstr.score_hedge(man, [0, 1, 2, 4], straggler=3,
                                       measurements=m)
                      if cls is PartitionManifest else
                      jstr.score_hedge(man, [0, 1, 2, 4], straggler=3,
                                       measurements=m))
    assert scores[0] == scores[1] == {"hedgewin": 1, "specwaste": 2}
    assert tm.counters[HEDGEWIN] == jm.counters["HEDGEWIN"] == 1
    assert tm.counters[SPECWASTE] == jm.counters["SPECWASTE"] == 2


# ------------------------------------------------------------ four ranks
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_straggler"),
                      deadline_s=240.0)
    yield pool
    pool.close()


def _jax_engine(tmp, m, *, membership=False, manifest=False, **attrs):
    eng = JHashJoin(JConfig(num_nodes=N, network_fanout_bits=3,
                            verify="check"))
    eng.elastic = True
    eng.measurements = m
    for k, v in attrs.items():
        setattr(eng, k, v)
    man = None
    if membership:
        board = JBoard(str(tmp / "leases"), rank=0, num_ranks=1,
                       lease_s=300.0, measurements=m)
        board.heartbeat(0)
        eng.membership = JView(board, measurements=m)
    if manifest:
        man = JManifest(str(tmp / "m"), fingerprint={"t": 1},
                        measurements=m)
        eng.partition_manifest = man
    return eng, man


def _jax_run(rk, sk, tmp, arms, seed, **kw):
    m = JMeasurements()
    eng, man = _jax_engine(tmp, m, **kw)
    inj = jfaults.FaultInjector(seed=seed, measurements=m)
    for site, at in arms:
        inj.arm(site, at=at)
    rid = jnp.arange(len(rk), dtype=jnp.uint32)
    with inj:
        res = eng.join_arrays(JBatch(key=jnp.asarray(rk), rid=rid),
                              JBatch(key=jnp.asarray(sk), rid=rid))
    out = {"matches": res.matches, "ok": res.ok,
           "partition_counts": np.asarray(res.partition_counts).tolist(),
           "diagnostics": res.diagnostics,
           "counters": {k: int(v) for k, v in m.counters.items()}}
    if man is not None:
        out["audit_total"] = man.audit()["total"]
    return out


def test_hedge_equals_jax(world, tmp_path):
    """``compute.straggle`` with the hedge on: the straggler's stripe is
    recomputed through the fence, exact, with no epoch bump, and HEDGED,
    HEDGEWIN and SPECWASTE equal JAX's (HEDGEWIN + SPECWASTE = the hedged
    partitions)."""
    n = 1 << 11
    rk, sk = _oracle(n, 3)
    attrs = {"hedge": "on", "straggle_factor": 3.0, "straggle_unit_s": 0.05}
    outs = world.run(_task(rk, sk, faults=[[faults.COMPUTE_STRAGGLE, 1]],
                           seed=11, membership=True, manifest={},
                           engine=dict(attrs, elastic=True)))
    want = _jax_run(rk, sk, tmp_path, [(jfaults.COMPUTE_STRAGGLE, 1)], 11,
                    membership=True, manifest=True, **attrs)
    d = want["diagnostics"]
    assert want["matches"] == n and d["hedged"] is True
    assert want["counters"][HEDGED] == 1
    assert want["counters"].get(MEPOCH, 0) == 0
    for got in outs:
        _same(got, want)
        c = got["counters"]
        assert (c.get(HEDGEWIN, 0) + c.get(SPECWASTE, 0)
                == got["diagnostics"]["hedged_partitions"])
        assert c.get(RANKLOST, 0) == 0
        assert got["audit_total"] == want["audit_total"] == n


def test_hedge_off_sleeps_out_the_straggle(world, tmp_path):
    n = 1 << 11
    rk, sk = _oracle(n, 3)
    attrs = {"straggle_factor": 2.0, "straggle_unit_s": 0.01}
    outs = world.run(_task(rk, sk, faults=[[faults.COMPUTE_STRAGGLE, 1]],
                           seed=11, engine=dict(attrs, elastic=True)))
    want = _jax_run(rk, sk, tmp_path, [(jfaults.COMPUTE_STRAGGLE, 1)], 11,
                    **attrs)
    assert not want["diagnostics"].get("recovered")
    for got in outs:
        _same(got, want)
        assert got["counters"].get(HEDGED, 0) == 0


def test_regrowth_equals_jax(world, tmp_path):
    """``membership.rank_join`` with ``elastic_grow``: the injected
    newcomer's lease is admitted at the next boundary, the epoch fences
    once, and the re-expanded plan gives partitions to owners past the
    boot mesh; exact, as JAX."""
    n = 1 << 11
    rk, sk = _oracle(n, 4)
    outs = world.run(_task(rk, sk, faults=[[faults.RANK_JOIN, 1]], seed=13,
                           membership=True,
                           engine={"elastic": True, "elastic_grow": True}))
    want = _jax_run(rk, sk, tmp_path, [(jfaults.RANK_JOIN, 1)], 13,
                    membership=True, elastic_grow=True)
    d = want["diagnostics"]
    assert d["regrown"] is True and d["lost_ranks"] == []
    assert want["counters"][RANKJOIN] == 1
    for got in outs:
        _same(got, want)
        owners = {int(o) for o in
                  got["diagnostics"]["recovery_assignment"].values()}
        assert max(owners) >= N
