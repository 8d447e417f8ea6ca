"""The flight recorder, the hang watchdog and the forensics bundles of the
port against the JAX package's (``observability/flightrec.py``,
``watchdog.py``, ``postmortem.py``), on one fake clock both read: the
ring's order, bound, context and idle clock; the registry's mirror into
the ring; the watchdog's trip and no-trip on a stalled registry, its
bundle and its kill; the bundle's schema, round trip, rendering and
merge; a failed served query's bundle.  Every count, key and value is
held exactly, timestamps (``t_s``, ``created_epoch_s``) and the substrate
block (``env``: JAX against torch) excluded.  On the port alone: a
session's watchdog ending a stalled query (``backend.stall``) as
``backend_unavailable`` with the bundle on its outcome, and the next query
exact; over two ranks, rank 0's kill ending every rank's query."""

import os
import time

import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join.observability.flightrec as jfr  # noqa: E402
import tpu_radix_join.observability.postmortem as jpm  # noqa: E402
import tpu_radix_join.observability.watchdog as jwd  # noqa: E402
import tpu_radix_join.performance.measurements as jmeas  # noqa: E402
import tpu_radix_join.service as jsvc  # noqa: E402
from tpu_radix_join.core.config import JoinConfig as JConfig  # noqa: E402

import tpu_radix_join_torch.observability.flightrec as tfr  # noqa: E402
import tpu_radix_join_torch.observability.postmortem as tpm  # noqa: E402
import tpu_radix_join_torch.observability.watchdog as twd  # noqa: E402
import tpu_radix_join_torch.performance.measurements as tmeas  # noqa: E402
import tpu_radix_join_torch.service as tsvc  # noqa: E402
from tpu_radix_join_torch import JoinConfig  # noqa: E402
from tpu_radix_join_torch.robustness import faults as tfaults  # noqa: E402

PKGS = {"port": (tfr, tmeas, twd, tpm), "jax": (jfr, jmeas, jwd, jpm)}


class FakeClock:
    """``time`` for the recorders and registries of both packages: every
    read returns the same instant until the test advances it."""

    def __init__(self, t=100.0):
        self.t = t

    def perf_counter(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def monotonic(self):
        return self.t

    def time_ns(self):
        return int(self.time() * 1e9)

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (tfr, jfr, tmeas, jmeas):
        monkeypatch.setattr(mod, "time", c)
    return c


def _no_t(records):
    return [{k: v for k, v in r.items() if k != "t_s"} for r in records]


# ------------------------------------------------------------ flight recorder

def test_ring_bound_order_and_snapshot_equal_jax(clock):
    snaps = []
    for fr_mod, *_ in PKGS.values():
        clock.t = 100.0
        fr = fr_mod.FlightRecorder(capacity=8)
        for i in range(20):
            clock.advance(0.5)
            fr.record("event", f"e{i}", i=i)
        snaps.append(fr.snapshot())
    assert snaps[0] == snaps[1]           # t_s too: one clock
    snap = snaps[0]
    assert snap["capacity"] == 8 and snap["recorded"] == 20
    assert [r["name"] for r in snap["records"]] == [f"e{i}"
                                                    for i in range(12, 20)]


def test_ring_context_stamps_and_clears_equal_jax(clock):
    got = []
    for fr_mod, *_ in PKGS.values():
        fr = fr_mod.FlightRecorder(capacity=4)
        fr.set_context(query_id="q7", tenant="t")
        fr.record("incr", "X", by=1)
        fr.set_context(trace_id="cafe")
        fr.clear_context("query_id", "tenant")
        fr.record("incr", "Y", by=1)
        ctx = fr.context
        fr.clear_context()
        got.append((fr.records(), ctx, fr.context, len(fr)))
    assert got[0] == got[1]
    recs, ctx, empty, n = got[0]
    assert recs[0]["query_id"] == "q7" and "query_id" not in recs[1]
    assert ctx == {"trace_id": "cafe"} and empty == {} and n == 2


def test_ring_idle_clock_equal_jax(clock):
    idle = []
    for fr_mod, *_ in PKGS.values():
        fr = fr_mod.FlightRecorder()
        clock.advance(2.0)
        before = fr.idle_s()             # seeded at construction
        fr.record("event", "tick")
        clock.advance(0.25)
        idle.append((before, fr.idle_s()))
    assert idle[0] == idle[1] == (2.0, 0.25)


def test_registry_mirrors_into_ring_equal_jax(clock):
    rings = []
    for _, meas_mod, *_ in PKGS.values():
        clock.t = 100.0
        m = meas_mod.Measurements(node_id=0, num_nodes=1)
        m.flightrec.set_context(query_id="q1")
        m.start("JTOTAL")
        clock.advance(0.001)
        m.incr("RETRYN", 2)
        m.event("plan_decision", strategy="x")
        with m.span("grid_pair", i=1, j=2):
            clock.advance(0.002)
        m.record_exchange(1, 64, 64)
        m.stop("JTOTAL")
        rings.append(m.flightrec.snapshot())
    assert rings[0] == rings[1]
    kinds = [r["kind"] for r in rings[0]["records"]]
    assert kinds[:5] == ["begin", "incr", "event", "span", "span_end"]
    assert kinds[-2:] == ["gauge", "end"]
    end = rings[0]["records"][-1]
    assert end["name"] == "JTOTAL" and end["us"] == pytest.approx(3000.0)
    assert all(r["query_id"] == "q1" for r in rings[0]["records"])


def test_dump_all_stacks_sees_this_thread():
    for fr_mod, *_ in PKGS.values():
        stacks = fr_mod.dump_all_stacks()
        assert any("MainThread" in label for label in stacks)
        joined = "\n".join(f for frames in stacks.values() for f in frames)
        assert "test_dump_all_stacks_sees_this_thread" in joined


# ------------------------------------------------------------------ watchdog

def _stalled_registry(meas_mod, clock):
    m = meas_mod.Measurements(node_id=0, num_nodes=1)
    m.start("JTOTAL")
    m.start("JPROC")
    m.incr("FINJECT")
    return m


def _wait(pred, seconds=20.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < seconds, "timed out"
        time.sleep(0.005)


def test_watchdog_trip_bundle_and_kill_equal_jax(clock, tmp_path):
    """A registry with open phases whose ring stays quiet past the timeout
    trips: WDOGTRIP, a ``watchdog_trip`` event, a bundle with every
    thread's stack, and the kill handed a HangDetected."""
    got = {}
    for name, (_, meas_mod, wd_mod, pm_mod) in PKGS.items():
        m = _stalled_registry(meas_mod, clock)
        killed = []
        out = tmp_path / name
        wd = wd_mod.Watchdog(m, timeout_s=30.0, kill=killed.append,
                             bundle_dir=str(out), poll_s=0.005,
                             config={"nodes": 1})
        with wd:
            time.sleep(0.02)
            assert not wd.tripped            # 0 s idle on the fake clock
            clock.advance(31.0)
            _wait(lambda: killed)
        exc = killed[0]
        bundle = pm_mod.load_bundle(pm_mod.list_bundles(str(out))[0])
        got[name] = {
            "tripped": wd.tripped, "exc": type(exc).__name__,
            "failure_class": exc.failure_class,
            "open_phases": exc.open_phases, "idle_s": exc.idle_s,
            "bundle_is_path": exc.bundle == wd.bundle_path,
            "counters": dict(m.counters),
            "events": [{k: v for k, v in e.items()
                        if k not in ("t_s", "t_epoch_s", "path")}
                       for e in m.meta["events"]],
            "reason": bundle["reason"], "bundle_fc": bundle["failure_class"],
            "bundle_open": bundle["open_phases"], "extra": bundle["extra"],
            "config": bundle["config"], "has_stacks": bool(bundle["stacks"]),
            "ring": _no_t(bundle["ring"]["records"])}
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["exc"] == "HangDetected" and g["failure_class"] == (
        "backend_unavailable")
    assert g["counters"]["WDOGTRIP"] == 1 and g["counters"]["PMBUNDLE"] == 1
    assert g["reason"] == "watchdog_trip" and g["has_stacks"]
    assert g["bundle_open"] == ["JPROC", "JTOTAL"]


@pytest.mark.parametrize("case", ["idle_session", "busy_phase"])
def test_watchdog_no_trip_equal_jax(clock, tmp_path, case):
    """No open phase (an idle session between queries) or a ring that keeps
    recording is not a hang."""
    got = []
    for name, (_, meas_mod, wd_mod, pm_mod) in PKGS.items():
        m = meas_mod.Measurements()
        with wd_mod.Watchdog(m, timeout_s=1.0, poll_s=0.005,
                             bundle_dir=str(tmp_path / name)) as wd:
            if case == "busy_phase":
                m.start("JTOTAL")
            for _ in range(8):
                clock.advance(0.5)
                if case == "busy_phase":
                    m.incr("GRIDPAIRS")
                time.sleep(0.01)
        got.append((wd.tripped, dict(m.counters),
                    pm_mod.list_bundles(str(tmp_path / name))))
    assert got[0] == got[1]
    assert got[0][0] is False and got[0][2] == []


def test_watchdog_asks_membership_first_equal_jax(clock, tmp_path):
    """A membership view that explains the stall turns the verdict into its
    RankLost (no WDOGTRIP), bundle reason ``rank_lost``."""

    class Lost(ConnectionError):
        failure_class = "rank_lost"

    class View:
        def suspect(self):
            return Lost("rank 1 lost")

    got = []
    for name, (_, meas_mod, wd_mod, pm_mod) in PKGS.items():
        m = _stalled_registry(meas_mod, clock)
        killed = []
        wd = wd_mod.Watchdog(m, timeout_s=1.0, kill=killed.append,
                             bundle_dir=str(tmp_path / name), poll_s=0.005,
                             membership=View())
        with wd:
            clock.advance(2.0)
            _wait(lambda: killed)
        b = pm_mod.load_bundle(pm_mod.list_bundles(str(tmp_path / name))[0])
        got.append((type(killed[0]).__name__, m.counters.get("WDOGTRIP"),
                    b["reason"], b["failure_class"],
                    killed[0].bundle == wd.bundle_path))
    assert got[0] == got[1] == ("Lost", None, "rank_lost", "rank_lost", True)


def test_engine_killer_rebinds_cancel_equal_jax():
    for _, _, wd_mod, _ in PKGS.values():
        class Engine:
            cancel = None
        eng = Engine()
        exc = wd_mod.HangDetected(3.0, {"JTOTAL"}, None)
        wd_mod.engine_killer(eng)(exc)
        with pytest.raises(wd_mod.HangDetected) as ei:
            eng.cancel("stalled")
        assert ei.value is exc and "JTOTAL" in str(exc)


# ------------------------------------------------------------------- bundles

def _bundle_view(b):
    return {k: v for k, v in b.items()
            if k not in ("created_epoch_s", "env", "stacks", "ring")}


def test_bundle_schema_roundtrip_render_merge_equal_jax(clock, tmp_path):
    views, renders, merges, paths = [], [], [], {}
    for name, (fr_mod, meas_mod, _, pm_mod) in PKGS.items():
        m = meas_mod.Measurements(node_id=3, num_nodes=4)
        m.flightrec.set_context(query_id="q42", worker_incarnation="w0i1",
                                membership_epoch=2)
        m.start("JTOTAL")
        m.incr("RETRYN")
        m.event("rank_lost", ranks=[1], epoch=2)
        m.meta["plan"] = {"strategy": "incore_fused_sort_narrow",
                          "predicted_ms": 2.5, "profile_name": "h100"}
        out = tmp_path / name
        hb = tmp_path / f"{name}.metrics.jsonl"
        hb.write_text('{"t_epoch_s": 1.0}\n{"torn')
        path = pm_mod.write_bundle(
            str(out), m, reason="query_failed",
            failure_class="data_corruption", config={"nodes": 4},
            stacks={"MainThread (1)": ["frame"]}, heartbeat_path=str(hb),
            extra={"note": "unit"})
        b = pm_mod.load_bundle(path)
        views.append(_bundle_view(b) | {"ring": _no_t(b["ring"]["records"]),
                                        "stacks": b["stacks"]})
        renders.append([ln for ln in pm_mod.render_bundle(b).splitlines()
                        if not ln.startswith(("created:", "env:",
                                              "heartbeat:"))])
        merged = pm_mod.merge_bundles([path, str(out / "missing.json")])
        for row in merged["rows"]:
            row.pop("path")
            row.pop("created_epoch_s", None)
        merged.pop("t_first")
        merged.pop("t_last")
        for ev in merged["recovery_timeline"]:
            ev.pop("bundle")
        merges.append(merged)
        paths[name] = path
        assert m.counters["PMBUNDLE"] == 1
        assert b["counters"].get("PMBUNDLE", 0) == 0   # frozen before it
        assert pm_mod.list_bundles(str(out)) == [path]
    # the heartbeat path lands in the bundle: equal apart from its name
    for v in views:
        v["heartbeat"].pop("path")
    assert views[0] == views[1]
    assert renders[0] == renders[1]
    assert merges[0] == merges[1]
    v = views[0]
    assert v["bundle_version"] == 1 and v["query_id"] == "q42"
    assert v["config_fingerprint"] == tpm.config_fingerprint({"nodes": 4})
    assert v["open_phases"] == ["JTOTAL"] and v["heartbeat"][
        "total_samples"] == 1
    mg = merges[0]
    assert mg["by_worker_incarnation"] == {"w0i1": 1}
    assert mg["by_membership_epoch"] == {"2": 1}
    assert mg["rows"][-1]["error"]          # the missing file, named
    # a bundle of one package renders and merges in the other
    assert tpm.render_bundle(jpm.load_bundle(paths["jax"]))
    assert jpm.merge_bundles([paths["port"]])["bundles"] == 1


def test_bundle_without_registry_equal_jax(tmp_path):
    got = []
    for name, (*_, pm_mod) in PKGS.items():
        path = pm_mod.write_bundle(str(tmp_path / name), None,
                                   reason="backend_unavailable",
                                   failure_class="backend_unavailable",
                                   extra={"probe_attempts": 9})
        got.append(_bundle_view(pm_mod.load_bundle(path)))
    assert got[0] == got[1]
    assert "counters" not in got[0] and got[0]["extra"] == {
        "probe_attempts": 9}


def test_bundle_records_the_active_injector_equal_jax(tmp_path):
    from tpu_radix_join.robustness import faults as jfaults
    got = []
    for name, faults_mod in (("port", tfaults), ("jax", jfaults)):
        pm_mod = PKGS[name][3]
        inj = faults_mod.FaultInjector(seed=5)
        inj.arm(faults_mod.BACKEND_DISPATCH, at=(2, 3))
        with inj:
            fired = [faults_mod.fires(faults_mod.BACKEND_DISPATCH)
                     for _ in range(4)]
            b = pm_mod.build_bundle(reason="chaos")
        got.append((fired, b["chaos"]))
    assert got[0] == got[1]
    assert got[0][1]["history"] == [["backend.dispatch", 2],
                                    ["backend.dispatch", 3]]


def test_failed_served_query_bundle_equal_jax(tmp_path):
    """A query whose deadline expires at admission writes a bundle named on
    its outcome, stamped with its query_id through the ring's context,
    which the session clears after the query."""
    got = []
    for name, svc, cfg in (("port", tsvc, JoinConfig()),
                           ("jax", jsvc, JConfig(num_nodes=1))):
        m = PKGS[name][1].Measurements()
        kw = {"device": "cpu"} if name == "port" else {}
        # one still clock for both sessions: the detail's elapsed time is
        # the clock's, not the host's load
        sess = svc.JoinSession(cfg, measurements=m,
                               forensics_dir=str(tmp_path / name),
                               clock=lambda: 1000.0, **kw)
        try:
            sess.submit(svc.QueryRequest(query_id="dead",
                                         tuples_per_node=256,
                                         deadline_s=0.0))
            out = sess.run_next()
            b = PKGS[name][3].load_bundle(out.bundle)
            got.append({
                "status": out.status, "fc": out.failure_class,
                "json_bundle": out.to_json()["bundle"] == out.bundle,
                "in_dir": os.path.dirname(out.bundle) == str(tmp_path / name),
                "reason": b["reason"], "query_id": b["query_id"],
                "extra": b["extra"], "config_keys": sorted(b["config"]),
                "context_after": m.flightrec.context,
                "pmbundle": m.counters["PMBUNDLE"]})
        finally:
            sess.close()
    # the configs differ by the JAX-only knobs; the shared keys line up
    shared = set(got[0].pop("config_keys")) & set(got[1].pop("config_keys"))
    assert {"num_nodes", "network_fanout_bits", "probe_algorithm"} <= shared
    assert got[0] == got[1]
    assert got[0]["reason"] == "deadline_exceeded"
    assert got[0]["query_id"] == "dead" and got[0]["context_after"] == {}


# --------------------------------------------------- the session's watchdog

def test_session_watchdog_ends_a_stalled_query_then_serves(tmp_path,
                                                           monkeypatch):
    """``backend.stall`` spins at the engine's cancel point: the session's
    watchdog trips, its kill outranks the query's deadline, the outcome is
    ``backend_unavailable`` with the bundle (stacks, open JTOTAL) written
    at the trip, the watchdog is re-armed and the next query is exact."""
    monkeypatch.setenv("TPU_RADIX_STALL_CAP_S", "20")
    m = tmeas.Measurements()
    sess = tsvc.JoinSession(JoinConfig(), measurements=m, device="cpu",
                            forensics_dir=str(tmp_path))
    try:
        first = sess.attach_watchdog(0.3, poll_s=0.01)
        inj = tfaults.FaultInjector(seed=1)
        inj.arm(tfaults.BACKEND_STALL, at=1)
        sess.submit(tsvc.QueryRequest("stall", tuples_per_node=512,
                                      deadline_s=60.0))
        t0 = time.monotonic()
        with inj:
            hung = sess.run_next()
        assert time.monotonic() - t0 < 10.0
        assert hung.status == "failed"
        assert hung.failure_class == "backend_unavailable"
        assert "watchdog" in hung.detail
        b = tpm.load_bundle(hung.bundle)
        assert b["reason"] == "watchdog_trip" and b["stacks"]
        assert "JTOTAL" in b["open_phases"] and b["query_id"] == "stall"
        assert m.counters["WDOGTRIP"] == 1
        rearmed = sess._watchdog
        assert rearmed is not first and not rearmed.tripped
        # a loaded host can leave a healthy phase quiet for 0.3 s: the next
        # query runs under a watchdog of 30 s, which replaces the re-armed one
        sess.attach_watchdog(30.0)
        assert not rearmed._thread.is_alive()
        sess.submit(tsvc.QueryRequest("next", tuples_per_node=512))
        ok = sess.run_next()
        assert ok.status == "ok" and ok.matches == ok.expected == 512
        assert m.counters["WDOGTRIP"] == 1 and len(
            tpm.list_bundles(str(tmp_path))) == 1
    finally:
        sess.close()
    assert sess._watchdog is None


def test_session_kill_outranks_the_deadline_and_is_per_query(tmp_path):
    sess = tsvc.JoinSession(JoinConfig(), device="cpu")
    try:
        expired = tsvc.Deadline(0.0)
        sess._deadline = expired
        hang = twd.HangDetected(1.0, ["JTOTAL"], None)
        sess.kill(hang)
        with pytest.raises(twd.HangDetected):
            sess._cancel("probe")            # the hang's verdict first
        with pytest.raises(tsvc.DeadlineExceeded):
            sess._cancel("probe")            # then the budget's
        sess.kill(hang)                      # past the last cancel point
        sess._end_query_watch(tsvc.QueryRequest("q"))
        assert sess._killed is None and sess._deadline is None
    finally:
        sess.close()
    # over two ranks (a gloo world of tests/torch_dist_worker.py) the
    # kill is rank 0's verdict, broadcast at the cancel point: every rank's
    # query ends killed, though only rank 0's watchdog tripped
    from torch_dist_worker import WorkerPool
    pool = WorkerPool(2, tmp_path, deadline_s=120.0)
    try:
        outs = pool.run({"kind": "serve", "config": {"num_nodes": 2},
                         "watchdog_kill_rank0": True,
                         "requests": [{"query_id": "k", "tuples_per_node":
                                       512},
                                      {"query_id": "after",
                                       "tuples_per_node": 512}]})
    finally:
        pool.close()
    for got in outs:
        killed, after = got["outcomes"]
        assert killed["status"] == "failed"
        assert killed["failure_class"] == "backend_unavailable"
        assert after["status"] == "ok" and after["matches"] == 1024
