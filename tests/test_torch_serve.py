"""Whole resident-service sessions of the port against the JAX package's:
the command line's serve mode (``main(["--serve", ...])``: the
three-query smoke, rejections, a malformed line), the warm skip of the
sizing pass, deadlines that expire at each of the engine's phase
boundaries through its ``cancel`` hook (on a fake clock both sessions
read alike), the breaker's trip, degraded CPU engine, half-open probe and
recovery through ``backend.dispatch``, and, over a four-rank gloo world
(tests/torch_dist_worker.py) against JAX at ``num_nodes=4`` on the
virtual mesh, the three-query smoke and a delta chain.  Outcomes and the
counters the service ticks must be equal."""

import json
import time

import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join.service as jsvc  # noqa: E402
from tpu_radix_join.core.config import JoinConfig as JConfig  # noqa: E402
from tpu_radix_join.core.config import (  # noqa: E402
    ServiceConfig as JServiceConfig)
from tpu_radix_join.main import main as jmain  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402

import tpu_radix_join_torch.service as tsvc  # noqa: E402
from tpu_radix_join_torch import JoinConfig  # noqa: E402
from tpu_radix_join_torch.core.config import ServiceConfig  # noqa: E402
from tpu_radix_join_torch.main import main as tmain  # noqa: E402
from tpu_radix_join_torch.performance import Measurements  # noqa: E402
from tpu_radix_join_torch.robustness import faults as tfaults  # noqa: E402
from torch_dist_worker import SERVE_FIELDS, WorkerPool  # noqa: E402

TPN = 1 << 10
SERVICE_COUNTERS = ("QADMIT", "QREJECT", "QDEADLINE", "QWARM", "QDEGRADED",
                    "BRKTRIP", "BRKPROBE", "RCHIT", "RCMISS", "BATCHN",
                    "BATCHQ", "DELTAMERGE", "RESBYTES", "FINJECT")
#: the CLI's outcome keys held equal (latency varies)
CLI_FIELDS = ("event", "query_id", "tenant", "status", "failure_class",
              "matches", "expected", "engine", "degraded", "warm",
              "breaker_state", "served_by")
#: the summary keys held equal (latencies and compile counts vary)
SUMMARY_KEYS = ("queries_submitted", "queries_ok", "queries_failed",
                "queries_rejected", "admission_rejection_rate",
                "deadline_miss_rate", "degraded_rate", "breaker_state",
                "breaker_trips", "breaker_probes", "queue_rejected",
                "placed_bytes", "warm_queries", "degraded_queries")


def _lines(out):
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    outcomes = [{k: r.get(k) for k in CLI_FIELDS} for r in recs
                if r.get("event") == "outcome"]
    errors = [r for r in recs if r.get("event") == "request_error"]
    summary = next((r for r in recs if r.get("event") == "summary"), None)
    return outcomes, errors, summary


def _cli_both(capsys, tmp_path, requests, flags, raw_lines=()):
    """(port rc, outcomes, errors, summary), the same for JAX, of one
    serve run of ``requests`` (dicts) and ``raw_lines`` at one rank."""
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps(r) + "\n" for r in requests)
                    + "".join(line + "\n" for line in raw_lines))
    got = []
    for main, extra in ((tmain, ["--device", "cpu"]),
                        (jmain, ["--nodes", "1"])):
        rc = main(["--serve", str(reqs)] + flags + extra)
        got.append((rc,) + _lines(capsys.readouterr().out))
    return got


@pytest.mark.parametrize("probe", ["sort", "bucket"])
def test_cli_serve_smoke_three_queries_equal_jax(capsys, tmp_path, probe):
    reqs = [{"query_id": f"q{i}", "tuples_per_node": TPN, "seed": 7 + i}
            for i in range(3)]
    port, jax_ = _cli_both(capsys, tmp_path, reqs, ["--probe", probe])
    assert port[:3] == jax_[:3]
    assert ({k: port[3][k] for k in SUMMARY_KEYS}
            == {k: jax_[3][k] for k in SUMMARY_KEYS})
    rc, outcomes, _, summary = port
    assert rc == 0
    assert [o["status"] for o in outcomes] == ["ok"] * 3
    assert all(o["matches"] == TPN for o in outcomes)
    assert [o["warm"] for o in outcomes] == [False, True, True]
    assert summary["warm_queries"] == 2
    assert summary["slo_p50_ms"] > 0 and summary["slo_p99_ms"] > 0


def test_cli_serve_rejections_delta_chain_and_bad_lines_equal_jax(
        capsys, tmp_path):
    reqs = ([{"query_id": f"q{i}", "tenant": "noisy", "tuples_per_node": TPN,
              "seed": 7} for i in range(5)]
            + [{"query_id": f"d{i}", "tenant": f"t{i}", "tuples_per_node": TPN,
                "delta_tuples_per_node": 16} for i in range(3)])
    flags = ["--serve-batch", "10", "--serve-tenant-quota", "2",
             "--result-cache", "4", "--resident-budget-mb", "4",
             "--probe", "bucket"]
    port, jax_ = _cli_both(capsys, tmp_path, reqs, flags,
                           raw_lines=["this is not json", "[1, 2]"])
    assert port[:3] == jax_[:3]
    rc, outcomes, errors, summary = port
    assert rc == 1                        # the malformed lines fail the run
    assert [e["line"] for e in errors] == [9, 10]
    by = {o["query_id"]: o for o in outcomes}
    rejected = [o for o in outcomes if o["status"] == "rejected"]
    assert len(rejected) == 3
    assert all(o["failure_class"] == "admission_rejected" for o in rejected)
    assert [by[f"d{i}"]["served_by"] for i in range(3)] == [
        "execute", "delta_merge", "delta_merge"]
    for k in ("queries_submitted", "queries_ok", "queries_rejected",
              "cache_hits", "delta_merges", "resident_bytes",
              "admission_rejection_rate"):
        assert summary[k] == jax_[3][k], k


def test_cli_serve_batch_window_and_refusals(capsys, tmp_path):
    reqs = [{"query_id": f"b{i}", "tuples_per_node": 256, "seed": i}
            for i in range(4)]
    port, jax_ = _cli_both(capsys, tmp_path, reqs,
                           ["--batch-window-ms", "60000", "--batch-max", "4"])
    assert port[:3] == jax_[:3]
    assert [o["served_by"] for o in port[1]] == ["batched"] * 4
    assert port[3]["fused_batches"] == jax_[3]["fused_batches"] == 1


#: the JAX command line's elastic flags, refused by name until membership,
#: recovery and stragglers were ported (each now runs: ``_ELASTIC_RUNS``),
#: and the one flag the port still refuses, naming its item
REFUSED = [(["--elastic-grow"], None), (["--elastic-join", "2"], None),
           (["--rank-death-at", "1"], None),
           (["--rank-join-at", "1"], None), (["--hedge", "on"], None),
           (["--hedge-threshold", "0.3"], None),
           (["--straggle-factor", "2"], None),
           (["--elastic", "on", "--nodes", "2"], None),
           (["--transfer-guard", "log"], "A18e")]

_ONE_SHOT = ["--device", "cpu", "--tuples-per-node", "2048",
             "--network-fanout", "3", "--rank-lease-s", "30"]


def _one_shot(capsys, argv):
    """One in-process join of ``_ONE_SHOT`` + ``argv``: (rc, stdout, the
    final JSON line)."""
    rc = tmain(_ONE_SHOT + argv)
    out = capsys.readouterr().out
    return rc, out, json.loads(out.strip().splitlines()[-1])


def _world_pair(tmp_path, argv, extra_env=None):
    """Two plain processes of one gloo world (``env://``) running the
    command line: their return codes and outputs."""
    from test_torch_elastic_procs import _port, _reap, _spawn
    port = _port()
    base = ["--device", "cpu", "--nodes", "2", "--tuples-per-node", "2048",
            "--network-fanout", "3", "--elastic", "on",
            "--rank-lease-s", "0.5", "--lease-dir", str(tmp_path / "L")]
    procs = [_spawn(base + argv, r, port, extra_env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        _reap(procs)
    return [p.returncode for p in procs], outs


def _run_elastic_grow(capsys, tmp_path, monkeypatch):
    from tpu_radix_join_torch.robustness.membership import LeaseBoard
    leases = tmp_path / "L"
    LeaseBoard(str(leases), rank=1, num_ranks=1, lease_s=30.0).heartbeat(
        0, status="joining")             # a newcomer asks before the join
    rc, out, last = _one_shot(capsys, ["--elastic", "on", "--elastic-grow",
                                       "--lease-dir", str(leases)])
    assert rc == 0 and last["matches"] == last["expected"] == 2048
    assert "[RESULTS] regrown: joined_ranks=[1] survivors=[0, 1]" in out
    assert last["counters"]["RANKJOIN"] == 1
    assert last["counters"]["MEPOCH"] == 1


def _run_elastic_join(capsys, tmp_path, monkeypatch):
    """A newcomer process joins a one-rank incumbent here, and both end
    exact through the shared manifest."""
    from test_torch_elastic_procs import _reap, _spawn
    leases, ck = tmp_path / "L", tmp_path / "ck"
    shared = ["--device", "cpu", "--tuples-per-node", "2048",
              "--network-fanout", "3", "--elastic", "on",
              "--rank-lease-s", "0.5", "--lease-dir", str(leases),
              "--checkpoint-dir", str(ck)]
    joiner = _spawn(shared + ["--elastic-join", "1"])
    try:
        deadline = time.monotonic() + 60
        while not (leases / "lease_r1.json").exists():
            assert time.monotonic() < deadline and joiner.poll() is None
            time.sleep(0.1)
        rc = tmain(shared + ["--elastic-grow"])
        out = capsys.readouterr().out
        jout = joiner.communicate(timeout=120)[0]
    finally:
        _reap([joiner])
    assert rc == 0 and joiner.returncode == 0, jout
    assert "[RESULTS] regrown: joined_ranks=[1]" in out
    assert "[RESULTS] joiner: rank=1 epoch=1" in jout, jout
    assert "manifest_partitions=8/8" in jout
    assert "[RESULTS] Expected: 2048 (OK)" in jout


def _run_rank_death_at(capsys, tmp_path, monkeypatch):
    """A simulated death on both ranks of a world: each recomputes every
    partition from the host-regenerated relations, exact."""
    rcs, outs = _world_pair(tmp_path, ["--rank-death-at", "2"])
    assert rcs == [0, 0], outs
    assert "[RESULTS] recovered: epoch=1 lost_ranks=[1] resumed=0 " \
        "recomputed=8" in outs[0], outs[0]
    assert "[RESULTS] Expected: 4096 (OK)" in outs[0]
    assert "RANKLOST\t1" in outs[0] and "RECOVERN\t8" in outs[0]


def _run_rank_join_at(capsys, tmp_path, monkeypatch):
    rc, out, last = _one_shot(capsys, ["--elastic", "on", "--elastic-grow",
                                       "--rank-join-at", "1", "--lease-dir",
                                       str(tmp_path / "L")])
    assert rc == 0 and last["matches"] == last["expected"] == 2048
    assert last["recovered"] and last["counters"]["RANKJOIN"] == 1
    assert "[RESULTS] regrown: joined_ranks=[1]" in out


def _run_hedge(capsys, tmp_path, monkeypatch):
    """A straggling rank 1 hedged over a world through the shared
    manifest: rank 0 recomputes its stripe, and every hedged partition is
    a win."""
    rcs, outs = _world_pair(tmp_path, [
        "--hedge", "on", "--straggle-factor", "20",
        "--checkpoint-dir", str(tmp_path / "ck")])
    assert rcs == [0, 0], outs
    assert "[RESULTS] hedged: straggler=1 partitions=4 hedgewin=4 " \
        "specwaste=0" in outs[0], outs[0]
    assert "[RESULTS] Expected: 4096 (OK)" in outs[0]
    assert "HEDGED\t1" in outs[0] and "MEPOCH" not in outs[0]


def _run_hedge_threshold(capsys, tmp_path, monkeypatch):
    from tpu_radix_join_torch.operators.hash_join import HashJoin
    seen = []
    join_arrays = HashJoin.join_arrays

    def spy(self, *a, **kw):
        seen.append((self.hedge, self.hedge_threshold, self.elastic))
        return join_arrays(self, *a, **kw)

    monkeypatch.setattr(HashJoin, "join_arrays", spy)
    req = tmp_path / "q.jsonl"
    req.write_text(json.dumps({"query_id": "h", "tuples_per_node": 512})
                   + "\n")
    rc = tmain(["--serve", str(req), "--device", "cpu", "--elastic", "on",
                "--lease-dir", str(tmp_path / "L"), "--hedge", "on",
                "--hedge-threshold", "0.3"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert rc == 0 and seen == [("on", 0.3, True)]
    assert lines[0]["status"] == "ok" and lines[0]["matches"] == 512


def _run_straggle_factor(capsys, tmp_path, monkeypatch):
    """Unhedged, the join eats the straggle: 2 x 0.05 s."""
    monkeypatch.setenv("TPU_RJ_STRAGGLE_UNIT_S", "0.05")
    rc, out, last = _one_shot(capsys, ["--elastic", "on", "--straggle-factor",
                                       "2", "--lease-dir",
                                       str(tmp_path / "L")])
    assert rc == 0 and last["matches"] == last["expected"] == 2048
    assert last["join_ms"] >= 100.0 and not last["recovered"]


def _run_elastic_nodes(capsys, tmp_path, monkeypatch):
    """``--elastic on --nodes 2``: leases over both ranks, an exact join,
    and every lease withdrawn at the exit."""
    rcs, outs = _world_pair(tmp_path, [])
    assert rcs == [0, 0], outs
    assert "[RESULTS] Expected: 4096 (OK)" in outs[0]
    assert not list((tmp_path / "L").glob("lease_r*.json"))


_ELASTIC_RUNS = {"--elastic-grow": _run_elastic_grow,
                 "--elastic-join": _run_elastic_join,
                 "--rank-death-at": _run_rank_death_at,
                 "--rank-join-at": _run_rank_join_at,
                 "--hedge": _run_hedge,
                 "--hedge-threshold": _run_hedge_threshold,
                 "--straggle-factor": _run_straggle_factor,
                 "--elastic": _run_elastic_nodes}


@pytest.mark.parametrize("flags,item", REFUSED,
                         ids=[f[0][0] for f in REFUSED])
def test_cli_refuses_unported_flag_by_name(capsys, tmp_path, monkeypatch,
                                           flags, item):
    """``--transfer-guard`` is refused by name, naming its item; each
    elastic flag, refused until it was ported, runs and its result is
    checked."""
    if item is None:
        _ELASTIC_RUNS[flags[0]](capsys, tmp_path, monkeypatch)
        return
    with pytest.raises(SystemExit):
        tmain(["--serve", "x.jsonl", "--device", "cpu"] + flags)
    err = capsys.readouterr().err
    assert "not ported" in err and item in err


# --------------------------------------------------------- resident sessions

class TickClock:
    """A clock that advances by one second at every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        t = self.t
        self.t += 1.0
        return t


def _view(out, detail=False):
    keys = SERVE_FIELDS if detail else SERVE_FIELDS[:-1]
    return {k: getattr(out, k) for k in keys}


def _counters(m):
    return {k: int(m.counters.get(k, 0)) for k in SERVICE_COUNTERS}


def _pair(cfg_kw=None, svc_kw=None, clock=None):
    """(port session, JAX session) at one rank, each with a registry and
    its own copy of ``clock``'s class."""
    kw = {} if clock is None else {"clock": clock()}
    port = tsvc.JoinSession(JoinConfig(**(cfg_kw or {})),
                            ServiceConfig(**(svc_kw or {})),
                            measurements=Measurements(), device="cpu", **kw)
    kw = {} if clock is None else {"clock": clock()}
    jax_ = jsvc.JoinSession(JConfig(num_nodes=1, **(cfg_kw or {})),
                            JServiceConfig(**(svc_kw or {})),
                            measurements=JMeasurements(), **kw)
    return port, jax_


def _serve(sess, svc, qid, **kw):
    kw.setdefault("tuples_per_node", TPN)
    kw.setdefault("seed", 21)
    sess.submit(svc.QueryRequest(query_id=qid, **kw))
    return sess.run_next()


def test_warm_queries_skip_the_sizing_pass_equal_jax():
    port, jax_ = _pair({"probe_algorithm": "bucket"})
    try:
        got = []
        for sess, svc in ((port, tsvc), (jax_, jsvc)):
            m = sess.measurements
            cold = _serve(sess, svc, "w0")
            jhist = m.times_us.get("JHIST", 0.0)
            warm = _serve(sess, svc, "w1", seed=22)
            got.append((_view(cold), _view(warm), jhist > 0,
                        m.times_us.get("JHIST", 0.0) == jhist,
                        _counters(m)))
        assert got[0] == got[1]
        assert got[0][1]["warm"] and not got[0][0]["warm"]
        assert got[0][2] and got[0][3] and got[0][4]["QWARM"] == 1
    finally:
        port.close()
        jax_.close()


#: a budget of b seconds on a clock that ticks one second a read expires
#: at the (b + 0.5)-th check: the session's three, then the engine's
DEADLINE_PHASES = {0.5: "admitted", 1.5: "generated", 2.5: "placed",
                   3.5: "start", 4.5: "sized", 5.5: "probe"}


@pytest.mark.parametrize("probe", ["sort", "bucket"])
def test_deadline_expires_at_each_phase_boundary_equal_jax(probe):
    port, jax_ = _pair({"probe_algorithm": probe}, clock=TickClock)
    try:
        got = []
        for sess, svc in ((port, tsvc), (jax_, jsvc)):
            outs = [_serve(sess, svc, f"dl{b}", deadline_s=b)
                    for b in DEADLINE_PHASES]
            outs.append(_serve(sess, svc, "after"))
            got.append(([_view(o, detail=True) for o in outs],
                        _counters(sess.measurements)))
        assert got[0] == got[1]
        outs, counters = got[0]
        for o, phase in zip(outs, DEADLINE_PHASES.values()):
            assert o["failure_class"] == "deadline_exceeded"
            assert f"(at phase '{phase}')" in o["detail"]
        assert outs[-1]["status"] == "ok"      # the session survives
        assert counters["QDEADLINE"] == len(DEADLINE_PHASES)
        assert port.measurements.times_us["JTOTAL"] > 0
    finally:
        port.close()
        jax_.close()


def test_breaker_trip_degrade_probe_recover_equal_jax():
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    port, jax_ = _pair(svc_kw={"breaker_threshold": 2,
                               "breaker_cooldown_s": 5.0}, clock=Clock)
    try:
        got = []
        for sess, svc, faults in ((port, tsvc, tfaults),
                                  (jax_, jsvc, jfaults)):
            inj = faults.FaultInjector(seed=5)
            inj.arm(faults.BACKEND_DISPATCH, at=(1, 2),
                    exc=faults.TransientFault)
            with inj:
                outs = [_serve(sess, svc, f"brk{i}") for i in range(3)]
                sess._clock.t += 6.0             # the cooldown elapses
                outs.append(_serve(sess, svc, "probe"))
                outs.append(_serve(sess, svc, "after"))
            events = [e["event"] for e in sess.measurements.meta["events"]
                      if e["event"].startswith(("breaker", "degrade"))]
            got.append(([_view(o) for o in outs],
                        _counters(sess.measurements), events,
                        sess.summary()["breaker_trips"]))
        assert got[0] == got[1]
        outs, counters, events, trips = got[0]
        assert [o["failure_class"] for o in outs[:2]] == [
            "backend_unavailable"] * 2
        assert outs[2]["engine"] == "cpu_fallback" and outs[2]["degraded"]
        assert outs[2]["status"] == "ok" and outs[2]["breaker_state"] == "open"
        assert outs[3]["engine"] == "primary" and outs[3]["status"] == "ok"
        assert outs[3]["breaker_state"] == "closed"
        assert counters["BRKTRIP"] == counters["BRKPROBE"] == 1
        assert counters["QDEGRADED"] == 1 and counters["FINJECT"] == 2
        assert "degrade" in events and trips == 1
        assert port._cpu_engine.device.type == "cpu"
    finally:
        port.close()
        jax_.close()


def test_session_refuses_unported_arguments_and_closes_twice():
    # elastic_grow= and hedge= (refused until ported) thread onto the
    # engine, and a query under them is exact
    for kw in ({"elastic_grow": True}, {"hedge": "on",
                                        "hedge_threshold": 0.3}):
        sess = tsvc.JoinSession(JoinConfig(), device="cpu", **kw)
        try:
            for k, v in kw.items():
                assert getattr(sess.engine, k) == getattr(sess, k) == v
            sess.submit(tsvc.QueryRequest("e", tuples_per_node=256))
            out = sess.run_next()
            assert out.status == "ok" and out.matches == out.expected == 256
        finally:
            sess.close()
    ledger = object()                  # ported: one row an executed query
    manifest = object()                # ported: threaded onto the engine
    sess = tsvc.JoinSession(JoinConfig(), device="cpu", ledger=ledger,
                            partition_manifest=manifest)
    assert sess.ledger is ledger
    assert sess.engine.partition_manifest is manifest
    sess.close()
    sess.close()
    with pytest.raises(RuntimeError):
        sess.submit(tsvc.QueryRequest("late"))
    req = tsvc.QueryRequest.from_json({"query_id": "a", "seed": 3})
    assert req == tsvc.QueryRequest("a", seed=3)
    for bad in ({"seed": 3}, {"query_id": "a", "nope": 1}):
        with pytest.raises(ValueError):
            tsvc.QueryRequest.from_json(bad)
    j = jsvc.QueryOutcome("q", "t", "ok", "ok", 1.23456, matches=3)
    t = tsvc.QueryOutcome("q", "t", "ok", "ok", 1.23456, matches=3)
    assert t.to_json() == j.to_json()


# ----------------------------------------------------------- four ranks

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_serve"),
                      deadline_s=240.0)
    yield pool
    pool.close()


def _jax_serve(cfg_kw, svc_kw, requests, tick_clock=False, arms=()):
    sess = jsvc.JoinSession(JConfig(num_nodes=N, **cfg_kw),
                            JServiceConfig(**svc_kw),
                            measurements=JMeasurements(),
                            **({"clock": TickClock()} if tick_clock else {}))
    inj = jfaults.FaultInjector(seed=5)
    for site, hits in arms:
        inj.arm(site, at=tuple(hits))
    try:
        outs = []
        with inj:
            for req in requests:
                sess.submit(jsvc.QueryRequest(**req))
                outs.append(sess.run_next())
        return ([{k: getattr(o, k) for k in SERVE_FIELDS} for o in outs],
                _counters(sess.measurements))
    finally:
        sess.close()


def _four_rank_case(case):
    """(config, service, requests, tick clock, fault arms) of a case."""
    q = [{"query_id": f"q{i}", "tuples_per_node": TPN, "seed": 7 + i}
         for i in range(3)]
    if case == "smoke":
        return {"probe_algorithm": "bucket"}, {}, q, False, ()
    if case == "delta_chain":
        return {}, {"resident_budget_bytes": 1 << 24}, [
            {"query_id": f"d{i}", "tuples_per_node": TPN,
             "delta_tuples_per_node": 32} for i in range(3)], False, ()
    if case == "deadlines":
        # rank 0's clock decides every rank's deadline at each boundary
        return {"probe_algorithm": "bucket"}, {}, [
            dict(q[0], query_id=f"dl{b}", deadline_s=b)
            for b in DEADLINE_PHASES] + q[:1], True, ()
    # breaker: two outages trip it, two queries degrade onto the CPU
    # engine over the session's own gloo group, then the probe recovers
    return {}, {"breaker_threshold": 2, "breaker_cooldown_s": 5.0}, [
        dict(q[0], query_id=f"b{i}") for i in range(6)], True, [
        ["backend.dispatch", [1, 2]]]


@pytest.mark.parametrize("case", ["smoke", "delta_chain", "deadlines",
                                  "breaker"])
def test_four_rank_sessions_equal_jax(world, case):
    cfg_kw, svc_kw, requests, tick, arms = _four_rank_case(case)
    results = world.run({"kind": "serve", "config": dict(cfg_kw, num_nodes=N),
                         "service": svc_kw, "requests": requests,
                         "tick_clock": tick, "faults": list(arms)})
    want, want_counters = _jax_serve(cfg_kw, svc_kw, requests, tick, arms)
    keys = SERVE_FIELDS if tick else SERVE_FIELDS[:-1]
    for rank, res in enumerate(results):
        got = [{k: o[k] for k in keys} for o in res["outcomes"]]
        assert got == [{k: o[k] for k in keys} for o in want], f"rank {rank}"
        assert {k: int(res["counters"].get(k, 0))
                for k in SERVICE_COUNTERS} == want_counters, f"rank {rank}"
    if case == "smoke":
        assert [o["warm"] for o in want] == [False, True, True]
    elif case == "delta_chain":
        assert [o["served_by"] for o in want] == ["execute", "delta_merge",
                                                  "delta_merge"]
    elif case == "deadlines":
        assert [o["failure_class"] for o in want] == (
            ["deadline_exceeded"] * len(DEADLINE_PHASES) + ["ok"])
    else:
        assert [o["engine"] for o in want] == (
            ["primary"] * 2 + ["cpu_fallback"] * 2 + ["primary"] * 2)
        assert want_counters["BRKTRIP"] == want_counters["BRKPROBE"] == 1


def test_rank_errors_cross_ranks_by_pickle():
    import pickle

    from tpu_radix_join_torch.service.session import RankError, _portable
    plain = ValueError("bad")
    assert _portable(plain) is plain
    fault = tfaults.TransientFault("backend.stall", 1)   # does not pickle
    got = pickle.loads(pickle.dumps(_portable(fault)))
    assert isinstance(got, RankError)
    assert got.failure_class == "backend_unavailable"
    assert "backend.stall" in str(got)
