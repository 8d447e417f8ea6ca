"""The serving fast paths of the port against the JAX package: the delta
merge and the batched count (``ops/merge_delta``) bit for bit on seeded
lanes — duplicates, empty sides, keys at ``MAX_SERVE_KEY``, composites
that use bit 31 and counts that wrap past 2**32 — the fingerprints, the
result cache, the resident-state manager and the micro-batcher on the same
fake clock, and whole one-rank sessions (``JoinSession(device="cpu")``
against JAX's ``JoinSession(JoinConfig(num_nodes=1))``): the cache hit and
the cache poison, the batched drain, the delta chain with an eviction
reset, and a resident budget of zero.  Outcomes and the counters the
service ticks must be equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_radix_join.service as jsvc  # noqa: E402
from tpu_radix_join.core.config import JoinConfig as JConfig  # noqa: E402
from tpu_radix_join.core.config import (  # noqa: E402
    ServiceConfig as JServiceConfig)
from tpu_radix_join.ops import merge_delta as jmd  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402
from tpu_radix_join.service import journal as jjournal  # noqa: E402
from tpu_radix_join.service import microbatch as jmicro  # noqa: E402
from tpu_radix_join.service import resident as jresident  # noqa: E402
from tpu_radix_join.service import resultcache as jcache  # noqa: E402

import tpu_radix_join_torch.service as tsvc  # noqa: E402
from tpu_radix_join_torch import JoinConfig  # noqa: E402
from tpu_radix_join_torch.core.config import ServiceConfig  # noqa: E402
from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops import merge_delta as tmd  # noqa: E402
from tpu_radix_join_torch.performance import Measurements  # noqa: E402
from tpu_radix_join_torch.robustness import faults as tfaults  # noqa: E402
from tpu_radix_join_torch.service import journal as tjournal  # noqa: E402
from tpu_radix_join_torch.service import microbatch as tmicro  # noqa: E402
from tpu_radix_join_torch.service import resident as tresident  # noqa: E402
from tpu_radix_join_torch.service import resultcache as tcache  # noqa: E402

TPN = 1 << 10
MAXK = tmd.MAX_SERVE_KEY
#: the counters the service ticks
SERVICE_COUNTERS = ("QADMIT", "QREJECT", "QDEADLINE", "QWARM", "QDEGRADED",
                    "BRKTRIP", "BRKPROBE", "RCHIT", "RCMISS", "BATCHN",
                    "BATCHQ", "DELTAMERGE", "RESBYTES", "FINJECT")
#: the outcome fields held equal (latency and detail vary)
OUTCOME_FIELDS = ("query_id", "tenant", "status", "failure_class", "matches",
                  "expected", "warm", "served_by", "engine", "degraded",
                  "breaker_state")


def _lane(a):
    return lane_from_numpy(np.asarray(a, np.uint32), "cpu")


def _keys(rng, n, hi=MAXK, dup=False):
    """Seeded uint32 keys in [0, hi]; with ``dup`` few distinct values."""
    if dup:
        vals = rng.integers(0, hi + 1, max(1, n // 8), dtype=np.uint64)
        return rng.choice(vals, n).astype(np.uint32) if n else \
            np.zeros(0, np.uint32)
    return rng.integers(0, hi + 1, n, dtype=np.uint64).astype(np.uint32)


# ------------------------------------------------------- ops/merge_delta

MERGE_SHAPES = [(0, 5), (5, 0), (0, 0), (1, 1), (1000, 37), (512, 512),
                (3000, 1)]


@pytest.mark.parametrize("n,d", MERGE_SHAPES)
@pytest.mark.parametrize("dup", [False, True])
def test_merge_sorted_bit_exact(n, d, dup):
    rng = np.random.default_rng(n * 31 + d + dup)
    a = np.sort(_keys(rng, n, dup=dup))
    b = np.sort(_keys(rng, d, dup=dup))
    if n and d:
        a[-1] = b[-1] = MAXK                 # the ceiling on both sides
    a, b = np.sort(a), np.sort(b)
    want = np.asarray(jmd.merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    got = lane_to_numpy(tmd.merge_sorted(_lane(a), _lane(b)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.sort(np.concatenate([a, b])))


DELTA_CASES = ["plain", "empty_delta", "empty_resident", "duplicates",
               "ceiling", "wrap"]


@pytest.mark.parametrize("case", DELTA_CASES)
def test_delta_merge_count_and_increment_bit_exact(case):
    rng = np.random.default_rng(DELTA_CASES.index(case))
    base = _keys(rng, 4096, dup=case == "duplicates")
    delta = _keys(rng, 256, dup=case == "duplicates")
    outer = np.concatenate([_keys(rng, 1024), base[:512], delta[:64]])
    if case == "empty_delta":
        delta = delta[:0]
    if case == "empty_resident":
        base = base[:0]
    if case == "ceiling":
        base[:3] = MAXK
        delta[:2] = MAXK
        outer[:5] = MAXK
    if case == "wrap":
        # 2**15 equal inner keys against 2**17 equal outer keys: 2**32
        # matches, which wrap to 0 in the uint32 count
        base = np.full(1 << 15, 77, np.uint32)
        delta = np.full(8, 77, np.uint32)
        outer = np.full(1 << 17, 77, np.uint32)
    lane = np.sort(base)
    ju, jt = jmd.delta_merge_count(jnp.asarray(lane), jnp.asarray(delta),
                                   jnp.asarray(outer))
    tu, tt = tmd.delta_merge_count(_lane(lane), _lane(delta), _lane(outer))
    assert np.array_equal(lane_to_numpy(tu), np.asarray(ju))
    assert (int(tt) & 0xFFFFFFFF) == int(jt)
    osorted = np.sort(outer)
    ju2, ji = jmd.delta_merge_increment(jnp.asarray(lane),
                                        jnp.asarray(delta),
                                        jnp.asarray(osorted))
    tu2, ti = tmd.delta_merge_increment(_lane(lane), _lane(delta),
                                        _lane(osorted))
    assert np.array_equal(lane_to_numpy(tu2), np.asarray(ju2))
    assert (int(ti) & 0xFFFFFFFF) == int(ji)
    assert tmd.compiled_delta_merge_count(1, 1, 1) is tmd.delta_merge_count
    assert (tmd.compiled_delta_merge_increment(1, 1, 1)
            is tmd.delta_merge_increment)


@pytest.mark.parametrize("key_bound,sizes", [
    (1 << 10, ((128, 200), (256, 100), (64, 300))),
    # shift 30: the third query's tag is bit 31
    (1 << 30, ((300, 100), (0, 50), (77, 0))),
    (1000, ((1, 1), (5, 9), (40, 3), (7, 7), (0, 0), (11, 2))),
])
def test_batched_merge_count_bit_exact(key_bound, sizes):
    rng = np.random.default_rng(key_bound % 997)
    r_parts = [_keys(rng, n, hi=key_bound - 1, dup=True)
               for n, _ in sizes]
    s_parts = [_keys(rng, m, hi=key_bound - 1, dup=True)
               for _, m in sizes]
    r_sizes = tuple(n for n, _ in sizes)
    s_sizes = tuple(m for _, m in sizes)
    r_cat = np.concatenate(r_parts).astype(np.uint32)
    s_cat = np.concatenate(s_parts).astype(np.uint32)
    want = np.asarray(jmd.batched_merge_count(
        jnp.asarray(r_cat), jnp.asarray(s_cat), r_sizes, s_sizes, key_bound))
    fn = tmd.compiled_batched_merge_count(r_sizes, s_sizes, key_bound)
    got = lane_to_numpy(fn(_lane(r_cat), _lane(s_cat)))
    assert np.array_equal(got, want)
    for i, (r, s) in enumerate(zip(r_parts, s_parts)):
        assert int(got[i]) == sum(int((r == k).sum()) for k in s)


def test_batched_merge_count_wraps_like_jax():
    # one query's 2**14 x 2**18 equal keys: 2**32 matches wrap to 0; the
    # other query's count is untouched
    r = np.concatenate([np.full(1 << 14, 5, np.uint32),
                        np.arange(16, dtype=np.uint32)])
    s = np.concatenate([np.full(1 << 18, 5, np.uint32),
                        np.arange(8, dtype=np.uint32)])
    args = ((1 << 14, 16), ((1 << 18), 8), 1 << 8)
    want = np.asarray(jmd.batched_merge_count(jnp.asarray(r),
                                              jnp.asarray(s), *args))
    got = lane_to_numpy(tmd.batched_merge_count(_lane(r), _lane(s), *args))
    assert np.array_equal(got, want) and got.tolist() == [0, 8]


def test_batch_feasible_and_shift_equal_jax():
    for q in (1, 2, 3, 8, 64, 1 << 12):
        for kb in (1, 2, 3, 1000, 1 << 20, 1 << 28, 1 << 30, MAXK, 1 << 32):
            assert tmd.batch_feasible(q, kb) == jmd.batch_feasible(q, kb)
            assert tmd.composite_shift(kb) == jmd.composite_shift(kb)
    with pytest.raises(ValueError):
        tmd.composite_shift(0)
    with pytest.raises(ValueError):
        tmd.batched_merge_count(_lane([1]), _lane([1]), (1, 0), (1,), 8)
    with pytest.raises(ValueError):
        tmd.batched_merge_count(_lane([1, 2]), _lane([1, 2]), (1, 1),
                                (1, 1), MAXK)


# -------------------------------------------------------- fingerprints

REQUESTS = [
    {"query_id": "q", "tuples_per_node": 1024, "seed": 2},
    {"seed": 2.0, "query_id": "q", "tuples_per_node": 1024.0},
    {"query_id": "q", "seed": 2, "deadline_s": 1.5, "display_name": "x"},
    {"query_id": "q", "flag": True, "nested": {"b": [1.0, 2], "a": 3.5}},
    {"query_id": "q2", "tenant": "t", "outer_kind": "zipf",
     "zipf_theta": 0.75, "delta_tuples_per_node": 16},
]


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_fingerprints_are_jax_strings(i):
    req = REQUESTS[i]
    assert (tjournal.request_fingerprint(req)
            == jjournal.request_fingerprint(req))
    for cfg_fp, epoch in ((None, None), ({"num_nodes": 4}, 3)):
        assert (tcache.content_fingerprint(req, cfg_fp, epoch)
                == jcache.content_fingerprint(req, cfg_fp, epoch))


def test_content_fingerprint_of_requests_equals_jax():
    kw = dict(query_id="q", tenant="t", tuples_per_node=512, seed=9,
              outer_kind="modulo", modulo=16, deadline_s=0.5)
    t = tcache.content_fingerprint(tsvc.QueryRequest(**kw), {"c": 1}, None)
    j = jcache.content_fingerprint(jsvc.QueryRequest(**kw), {"c": 1}, None)
    assert t == j
    # the envelope never enters it
    assert t == tcache.content_fingerprint(
        tsvc.QueryRequest(**dict(kw, query_id="other", tenant="u",
                                 deadline_s=None)), {"c": 1}, None)


def test_journal_round_trip_and_audit_equal_jax(tmp_path):
    got = []
    for mod, d in ((tjournal, "t"), (jjournal, "j")):
        j = mod.QueryJournal(str(tmp_path / d))
        fp = j.append_intent({"query_id": "a", "seed": 1})["fp"]
        j.append_intent({"query_id": "b", "seed": 2})
        j.append_outcome(fp, {"query_id": "a", "status": "ok"})
        j.append_outcome(fp, {"query_id": "a", "status": "ok"})
        with open(j.path, "a") as f:
            f.write('{"torn": ')
        got.append((j.audit().to_json(), [r["query_id"]
                                          for r in j.unacknowledged()],
                    j.depth(), j.outcome_for(fp)))
    assert got[0] == got[1]
    assert got[0][0]["double_exec"] == 1


# ------------------------------------------------- the host fast paths

class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


PACKAGES = {
    "port": (tcache, tresident, tmicro, tfaults, Measurements, tsvc),
    "jax": (jcache, jresident, jmicro, jfaults, JMeasurements, jsvc),
}


def _run_cache_script(pkg):
    cache, _, _, faults, Meas, _ = PACKAGES[pkg]
    clock = FakeClock()
    m = Meas()
    c = cache.ResultCache(2, ttl_s=10.0, measurements=m, clock=clock)
    log = [c.get("a")]
    c.put("a", {"matches": 1})
    c.put("b", {"matches": 2})
    log.append(c.get("a"))
    c.put("c", {"matches": 3})                  # evicts b (LRU)
    log += [c.get("b"), c.get("a"), len(c)]
    clock.t = 11.0
    log.append(c.get("a"))                      # TTL expired
    c.put("e", {"matches": 5}, epoch=1)
    log += [c.get("e", epoch=2), c.get("e", epoch=1)]
    c.put("p", {"matches": 7})
    inj = faults.FaultInjector(seed=3, measurements=m)
    inj.arm(faults.CACHE_POISON, at=1)
    with inj:
        log.append(c.get("p"))                  # poisoned: dropped
    log.append(c.get("p"))
    off = cache.ResultCache(0, measurements=m)
    off.put("x", {"matches": 1})
    log += [off.get("x"), off.stats()]
    log.append(c.stats())
    return log, {k: m.counters.get(k, 0) for k in SERVICE_COUNTERS}


def test_result_cache_equals_jax():
    assert _run_cache_script("port") == _run_cache_script("jax")


class _Lane:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def _run_resident_script(pkg):
    _, resident, _, _, Meas, _ = PACKAGES[pkg]
    m = Meas()
    res = resident.ResidentStateManager(100, measurements=m)
    log = [res.put("a", _Lane(40)), res.put("b", _Lane(40)),
           res.get("a") is not None, res.put("c", _Lane(40)),
           res.get("b") is None, res.put("huge", _Lane(1000))]
    res.note_merge("a")
    res.put("e", _Lane(10), epoch=1)
    log += [res.get("e", epoch=2), list(res.keys()), res.stats()]
    log.append(res.invalidate("a"))
    log.append(res.invalidate())
    off = resident.ResidentStateManager(0)
    log += [off.put("a", _Lane(1)), off.get("a")]
    return log, {k: m.counters.get(k, 0) for k in SERVICE_COUNTERS}


def test_resident_manager_equals_jax():
    assert _run_resident_script("port") == _run_resident_script("jax")
    res = tresident.ResidentStateManager(1 << 20)
    lane = torch.zeros(1000, dtype=torch.int32)
    assert res.put("lane", lane) and res.resident_bytes == 4000


def _ids(x):
    """Query ids of an offer's group, or of due() / flush()'s groups."""
    if x is None:
        return None
    return [_ids(g) if isinstance(g, list) else g.query_id for g in x]


def _run_batcher_script(pkg):
    _, _, micro, _, _, svc = PACKAGES[pkg]
    clock = FakeClock()

    def req(qid, **kw):
        return svc.QueryRequest(query_id=qid, tuples_per_node=TPN, **kw)

    off = micro.MicroBatcher(0.0, max_queries=4, clock=clock)
    log = [_ids(off.offer(req("s0"), 1 << 12))]
    mb = micro.MicroBatcher(50.0, max_queries=3, clock=clock)
    log.append(_ids(mb.offer(req("x"), tmd.MAX_SERVE_KEY)))   # infeasible
    log.append(_ids(mb.offer(req("tight", deadline_s=0.01), 1 << 12)))
    log.append(_ids(mb.offer(req("a"), 1 << 12)))
    clock.t = 0.01
    log.append(_ids(mb.offer(req("m", outer_kind="modulo", modulo=16),
                             1 << 12)))
    log.append(_ids(mb.offer(req("b"), 1 << 12)))
    log += [_ids(mb.due()), mb.next_deadline_s(), mb.pending()]
    log.append(_ids(mb.offer(req("c"), 1 << 12)))               # full
    clock.t = 0.0605
    log.append(_ids(mb.due()))
    log.append(_ids(mb.offer(req("d"), 1 << 12)))
    log += [_ids(mb.flush()), mb.stats(),
            micro.batch_signature(req("z", repeats=2)),
            micro.SIGNATURE_FIELDS]
    with pytest.raises(ValueError):
        micro.MicroBatcher(-1.0)
    with pytest.raises(ValueError):
        micro.MicroBatcher(1.0, max_queries=1)
    return log


def test_microbatcher_equals_jax():
    assert _run_batcher_script("port") == _run_batcher_script("jax")


def test_pop_matching_equals_jax():
    got = []
    for svc in (tsvc, jsvc):
        q = svc.AdmissionQueue()
        for i in range(5):
            q.submit(svc.QueryRequest(f"q{i}", seed=7 if i % 2 == 0 else 8))
        first = q.pop()
        peers = q.pop_matching(lambda r: r.seed == 7, 8)
        got.append([first.query_id, [r.query_id for r in peers],
                    [q.pop().query_id for _ in range(2)],
                    q.pop_matching(lambda r: True, 0)])
    assert got[0] == got[1] == ["q0", ["q2", "q4"], ["q1", "q3"], []]


# --------------------------------------------- whole one-rank sessions

def _sessions(svc_kw, port_kw=None):
    """(port session, JAX session) over one rank with the same service
    knobs, each with its own registry."""
    port = tsvc.JoinSession(JoinConfig(**(port_kw or {})),
                            ServiceConfig(**svc_kw),
                            measurements=Measurements(), device="cpu")
    jax_ = jsvc.JoinSession(JConfig(num_nodes=1, **(port_kw or {})),
                            JServiceConfig(**svc_kw),
                            measurements=JMeasurements())
    return port, jax_


def _req(pkg_svc, qid, **kw):
    kw.setdefault("tuples_per_node", TPN)
    kw.setdefault("seed", 7)
    return pkg_svc.QueryRequest(query_id=qid, **kw)


def _view(out):
    return {k: getattr(out, k) for k in OUTCOME_FIELDS}


def _counters(sess):
    return {k: int(sess.measurements.counters.get(k, 0))
            for k in SERVICE_COUNTERS}


def _both(script, svc_kw, port_kw=None):
    """Run ``script(session, svc_module)`` on both packages' sessions and
    return (port outcomes, JAX outcomes, port counters, JAX counters)."""
    port, jax_ = _sessions(svc_kw, port_kw)
    try:
        got = [script(port, tsvc), script(jax_, jsvc)]
        views = [[_view(o) for o in outs] for outs in got]
        return views[0], views[1], _counters(port), _counters(jax_)
    finally:
        port.close()
        jax_.close()


def test_session_cache_hit_and_poison_equal_jax():
    def script(sess, svc):
        sess.submit(_req(svc, "cold"))
        outs = [sess.run_next()]
        miss = sess.try_cache(_req(svc, "miss", seed=99))
        outs.append(sess.try_cache(_req(svc, "hot")))
        faults = tfaults if svc is tsvc else jfaults
        inj = faults.FaultInjector(seed=1)
        inj.arm(faults.CACHE_POISON, at=1)
        with inj:
            poisoned = sess.try_cache(_req(svc, "poisoned"))
        sess.submit(_req(svc, "again"))
        outs.append(sess.run_next())
        outs.append(sess.try_cache(_req(svc, "hot2")))
        assert miss is None and poisoned is None
        return outs

    port, jax_, pc, jc = _both(script, {"result_cache_max": 4})
    assert port == jax_ and pc == jc
    assert [o["served_by"] for o in port] == ["execute", "cache_hit",
                                              "execute", "cache_hit"]
    assert port[0]["matches"] == port[1]["matches"] == TPN
    assert pc["RCHIT"] == 2


def test_session_batched_drain_equals_jax():
    def script(sess, svc):
        for i in range(3):
            sess.submit(_req(svc, f"b{i}", seed=i))
        sess.submit(_req(svc, "solo", outer_kind="modulo", modulo=16))
        sess.submit(_req(svc, "z", outer_kind="zipf"))
        outs = sess.drain()
        return sorted(outs, key=lambda o: o.query_id)

    port, jax_, pc, jc = _both(script, {"batch_window_ms": 50.0,
                                        "batch_max_queries": 8})
    assert port == jax_ and pc == jc
    by = {o["query_id"]: o for o in port}
    assert [by[f"b{i}"]["served_by"] for i in range(3)] == ["batched"] * 3
    assert by["solo"]["served_by"] == by["z"]["served_by"] == "execute"
    assert all(o["matches"] == o["expected"] for o in port)
    assert pc["BATCHN"] == 1 and pc["BATCHQ"] == 3


@pytest.mark.parametrize("budget", [1 << 24, 6000])
def test_session_delta_chain_eviction_reset_equals_jax(budget):
    def script(sess, svc):
        outs = []
        for i in range(3):
            sess.submit(_req(svc, f"d{i}", delta_tuples_per_node=32))
            outs.append(sess.run_next())
        # an outer of another kind: the full probe of the merged union
        sess.submit(_req(svc, "dm", delta_tuples_per_node=32,
                         outer_kind="modulo", modulo=64))
        outs.append(sess.run_next())
        sess.resident.invalidate()            # eviction mid-chain
        for i in (3, 4):
            sess.submit(_req(svc, f"d{i}", delta_tuples_per_node=32))
            outs.append(sess.run_next())
        return outs

    port, jax_, pc, jc = _both(script, {"resident_budget_bytes": budget})
    assert port == jax_ and pc == jc
    assert all(o["status"] == "ok" and o["matches"] == o["expected"]
               for o in port)
    if budget > 6000:
        assert [o["served_by"] for o in port] == [
            "execute", "delta_merge", "delta_merge", "delta_merge",
            "execute", "delta_merge"]
        assert pc["DELTAMERGE"] == 4 and pc["RESBYTES"] > 0
    else:
        # the union and the sorted outer lane do not fit together: the
        # outer's admission evicts the union, so every query is cold
        assert [o["served_by"] for o in port] == ["execute"] * 6


def test_session_delta_budget_zero_stays_on_full_path_equals_jax():
    def script(sess, svc):
        outs = []
        for i in range(2):
            sess.submit(_req(svc, f"d{i}", delta_tuples_per_node=32))
            outs.append(sess.run_next())
        return outs

    port, jax_, pc, jc = _both(script, {})
    assert port == jax_ and pc == jc
    assert [o["served_by"] for o in port] == ["execute", "execute"]
    assert pc["DELTAMERGE"] == 0 and pc["RESBYTES"] == 0


def test_fastpath_stats_and_summary_keys_equal_jax():
    def script(sess, svc):
        sess.submit(_req(svc, "a"))
        sess.submit(_req(svc, "b", delta_tuples_per_node=16))
        return sess.drain()

    svc_kw = {"result_cache_max": 2, "resident_budget_bytes": 1 << 20}
    port, jax_ = _sessions(svc_kw)
    try:
        outs = [script(port, tsvc), script(jax_, jsvc)]
        assert ([_view(o) for o in outs[0]] == [_view(o) for o in outs[1]])
        ps, js = port.fastpath_stats(), jax_.fastpath_stats()
        assert ps == js
        psum, jsum = port.summary(), jax_.summary()
        assert set(psum) == set(jsum)
        for k in ("queries_submitted", "queries_ok", "breaker_state",
                  "cache_hits", "resident_bytes", "delta_merges",
                  "warm_queries", "placed_bytes"):
            assert psum[k] == jsum[k], k
    finally:
        port.close()
        jax_.close()
    assert dataclasses.asdict(ServiceConfig()) == dataclasses.asdict(
        JServiceConfig())
