"""The span tracer, the timeline merge, the metrics sampler, the compile
monitor and the status endpoint of the port against the JAX package's
(``observability/spans.py``, ``timeline.py``, ``metrics.py``,
``compilemon.py``, ``statusz.py``), on one fake clock both read.  A
tracer's Chrome JSON, ``merge_timeline``'s output over the same span
files (either package's mergers over either package's files), the
sampler's records (keys, counters, torn lines, rotation), the status
sections and ``/healthz`` codes are held exactly, timestamps and host
memory values excluded.  The serve command line's ``--statusz`` is
queried over HTTP on port 0 while it serves (a thread, no subprocess), and
its sections are JAX's, ``hedge`` holding the hedge posture and
``critical_paths`` the served query's path."""

import io
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join.observability.metrics as jmet  # noqa: E402
import tpu_radix_join.observability.spans as jspans  # noqa: E402
import tpu_radix_join.observability.statusz as jstz  # noqa: E402
import tpu_radix_join.observability.timeline as jtl  # noqa: E402
import tpu_radix_join.performance.measurements as jmeas  # noqa: E402

import tpu_radix_join_torch.observability.compilemon as tcm  # noqa: E402
import tpu_radix_join_torch.observability.flightrec as tfr  # noqa: E402
import tpu_radix_join_torch.observability.metrics as tmet  # noqa: E402
import tpu_radix_join_torch.observability.spans as tspans  # noqa: E402
import tpu_radix_join_torch.observability.statusz as tstz  # noqa: E402
import tpu_radix_join_torch.observability.timeline as ttl  # noqa: E402
import tpu_radix_join_torch.performance.measurements as tmeas  # noqa: E402
from tpu_radix_join_torch.main import main as tmain  # noqa: E402
from tpu_radix_join_torch.ops.kernels import _build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"port": (tspans, ttl, tmet, tstz, tmeas),
        "jax": (jspans, jtl, jmet, jstz, jmeas)}


class FakeClock:
    def __init__(self, t=50.0):
        self.t = t

    def perf_counter(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (tspans, jspans, tmet, jmet, tmeas, jmeas, tfr):
        monkeypatch.setattr(mod, "time", c)
    import tpu_radix_join.observability.flightrec as jfr
    monkeypatch.setattr(jfr, "time", c)
    return c


def _no_ts(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


# ----------------------------------------------------------------- tracer

def _trace(spans_mod, rank, epoch_s, mono_s, clock):
    tr = spans_mod.SpanTracer(rank=rank, trace_id="cafe", tags={"nodes": 3},
                              epoch_s=epoch_s, mono_s=mono_s)
    tr.begin("JTOTAL")
    clock.advance(0.25)
    tr.begin("JPROC")
    tr.begin("JPROC")                # a retry re-enters the phase
    tr.end("JPROC")
    tr.set_tags(strategy="incore_fused_sort_narrow")
    tr.end("JPROC", attempts=2)
    tr.end("JPROC")                  # a stray stop: dropped
    tr.instant("checkpoint_load", path="x")
    with tr.span("grid_pair", i=1):
        clock.advance(0.5)
    tr.begin("JHIST")                # open at the save: closed, marked
    return tr


def test_tracer_chrome_json_and_save_equal_jax(clock, tmp_path):
    docs = []
    for name, (spans_mod, *_) in PKGS.items():
        clock.t = 50.0
        tr = _trace(spans_mod, 2, 1000.0, 50.0, clock)
        chrome = tr.to_chrome(shift_us=7.0)
        path = tr.save(str(tmp_path / name),
                       device_summary={"plane": "/device:GPU:0",
                                       "busy_us": 3.0, "ops": {}})
        assert os.path.basename(path) == "2.spans.json"
        docs.append((chrome, json.loads(Path(path).read_text())))
    assert docs[0] == docs[1]        # ts too: one clock
    saved = docs[0][1]
    jproc = [e for e in saved["traceEvents"] if e["name"] == "JPROC"]
    assert len(jproc) == 2 and jproc[1]["args"]["attempts"] == 2
    jhist = [e for e in saved["traceEvents"] if e["name"] == "JHIST"][0]
    assert jhist["args"]["unclosed"] is True
    assert saved["metadata"]["device_summary"]["plane"] == "/device:GPU:0"


def test_registry_mirrors_into_tracer_equal_jax(clock):
    got = []
    for _, (*_, meas_mod) in PKGS.items():
        clock.t = 50.0
        m = meas_mod.Measurements(node_id=1, num_nodes=2)
        tr = m.attach_tracer(trace_id="beef", nodes=2)
        m.set_trace_tags(strategy="s", engine="incore")
        m.start("JHIST")
        clock.advance(0.1)
        m.stop("JHIST")
        m.event("checkpoint_load", path="x", done=False)
        with m.span("grid_pair", i=1, j=2):
            clock.advance(0.2)
        got.append((tr.events, tr.epoch_s == m.meta["epoch_s"],
                    m.meta["trace_id"], m.flightrec.context, tr.rank,
                    "grid_pair" in m.times_us))
    assert got[0] == got[1]
    events, same_anchor, tid, ctx, rank, timed = got[0]
    assert {e["name"] for e in events} == {"JHIST", "checkpoint_load",
                                           "grid_pair"}
    assert same_anchor and tid == "beef" and ctx == {"trace_id": "beef"}
    assert rank == 1 and not timed
    assert events[0]["args"] == {"nodes": 2, "strategy": "s",
                                 "engine": "incore"}


# ---------------------------------------------------------------- timeline

def _span_files(spans_mod, out, clock, summary=None, corrupt=False):
    clock.t = 50.0
    for rank, epoch in ((0, 1000.0), (2, 1001.5)):
        tr = _trace(spans_mod, rank, epoch, clock.t, clock)
        tr.save(str(out), device_summary=summary if rank == 0 else None)
    if corrupt:
        (out / "sub").mkdir()
        (out / "sub" / "1.spans.json").write_text('{"traceEv')


SUMMARY = {"plane": "/device:GPU:0", "busy_us": 30.0,
           "ops": {f"k{i}": {"us": float(70 - i), "count": i + 1}
                   for i in range(70)}}


@pytest.mark.parametrize("case", ["plain", "device_summary", "partial"])
def test_merge_timeline_equal_jax(clock, tmp_path, case):
    """Both mergers over either package's span files give one document:
    the clock shift, the grafted device track (64 ops and a tail), the
    missing rank of a world of 3 and the torn file, named."""
    merged = {}
    for name, (spans_mod, *_) in PKGS.items():
        out = tmp_path / name
        out.mkdir()
        _span_files(spans_mod, out, clock,
                    summary=SUMMARY if case != "plain" else None,
                    corrupt=case == "partial")
        for mname, (_, tl_mod, *_) in PKGS.items():
            merged[(name, mname)] = tl_mod.merge_timeline(
                str(out), out_path=str(tmp_path / f"{name}_{mname}.json"))
    docs = list(merged.values())
    assert all(d == docs[0] for d in docs[1:])
    doc = docs[0]
    md = doc["metadata"]
    assert md["ranks"]["2"]["clock_shift_us"] == pytest.approx(1.5e6)
    assert md["missing_ranks"] == [1] and md["partial"]
    dev = [e for e in doc["traceEvents"]
           if e.get("tid") == 1 and e.get("ph") == "X"]
    if case == "plain":
        assert dev == []
    else:
        assert len(dev) == 65 and dev[0]["name"] == "k0"
        assert dev[1]["ts"] == pytest.approx(dev[0]["ts"] + dev[0]["dur"])
    assert md["corrupt_files"] == (["1.spans.json"] if case == "partial"
                                   else [])
    assert json.loads((tmp_path / "port_port.json").read_text()) == doc


def test_merge_timeline_reads_a_profiler_trace(tmp_path, clock):
    """Without an embedded summary the port's merger grafts the device
    track from a ``*.trace.json`` profiler file beside the spans."""
    _span_files(tspans, tmp_path, clock)
    (tmp_path / "0.trace.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "radix_pass", "ts": 0.0,
         "dur": 5.0, "pid": 0, "tid": 7, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "merge_scan", "ts": 5.0,
         "dur": 2.0, "pid": 0, "tid": 7, "args": {"device": 0}}]}))
    doc = ttl.merge_timeline(str(tmp_path))
    dev = [e for e in doc["traceEvents"]
           if e.get("tid") == 1 and e.get("ph") == "X"]
    assert [e["name"] for e in dev] == ["radix_pass", "merge_scan"]
    assert "profiler trace scan" in dev[0]["args"]["source"]
    assert ttl.merge_timeline(str(tmp_path / "none")) is None
    assert ttl.find_span_files(str(tmp_path)) == jtl.find_span_files(
        str(tmp_path))


# ----------------------------------------------------------------- sampler

def _sample_view(rec):
    drop = ("t_epoch_s", "t_rel_s", "host")
    out = {k: v for k, v in rec.items() if k not in drop}
    out["host_keys"] = sorted(rec.get("host", {}))
    return out


def test_metrics_sampler_records_equal_jax(clock, tmp_path, monkeypatch):
    monkeypatch.setattr(jmet, "device_memory", lambda: {})
    got = []
    for name, (_, _, met_mod, _, meas_mod) in PKGS.items():
        m = meas_mod.Measurements()
        m.incr("GRIDPAIRS", 3)
        m.meta["exchange_plan"] = {"pack_ratio_pct": 76.5, "stages": 4,
                                   "wire_bytes": 1024}
        path = str(tmp_path / f"{name}.metrics.jsonl")
        s = met_mod.MetricsSampler(path, interval_s=3600.0, measurements=m,
                                   extra=lambda: {"lease": {"seq": 1}})
        s.start()
        m.start("JTOTAL")
        clock.advance(0.5)
        m.stop("JTOTAL")
        m.start("JPROC")
        m.incr("WIREBYTES", 4096)
        s.sample()
        s.stop()
        with open(path, "a") as f:
            f.write('{"t_epoch_s": 1.0, "trunc')     # a killed run's tail
        samples = met_mod.load_samples(path)
        got.append([_sample_view(r) for r in samples])
        assert s.samples_written == len(samples) == 3
    assert got[0] == got[1]
    last = got[0][-1]
    assert last["counters"] == {"GRIDPAIRS": 3, "WIREBYTES": 4096}
    assert last["open_phases"] == ["JPROC"]
    assert last["times_us"] == {"JTOTAL": 500000.0}
    assert last["exchange"] == {"wirebytes": 4096, "pack_ratio_pct": 76.5,
                                "stages": 4, "planned_wire_bytes": 1024}
    assert last["lease"] == {"seq": 1} and last["devices"] == {}
    assert last["host_keys"] == ["VmRSS", "VmSize"]


def test_metrics_sampler_rotation_and_errors_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jmet, "device_memory", lambda: {})
    got = []
    for name, (_, _, met_mod, *_) in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        calls = []

        def extra():
            calls.append(1)
            if len(calls) == 7:
                raise RuntimeError("provider died")
            return {"n": len(calls)}

        s = met_mod.MetricsSampler(path, interval_s=3600.0, extra=extra,
                                   rotate_bytes=200, rotate_keep=2)
        s.start()
        for _ in range(6):
            s.sample()
        s.stop()
        files = sorted(p.name.replace(name, "x")
                       for p in tmp_path.glob(f"{name}.jsonl*"))
        recs = met_mod.load_samples(path, include_rotated=True)
        got.append((s.rotations, files, [r.get("n") for r in recs],
                    [r.get("error") for r in recs if "error" in r]))
        for bad in ({"interval_s": 0.0}, {"extra": 3},
                    {"rotate_bytes": 0}, {"rotate_keep": 0}):
            with pytest.raises((ValueError, TypeError)):
                met_mod.MetricsSampler(path, **bad)
    assert got[0] == got[1]
    rotations, files, ns, errors = got[0]
    assert rotations > 0 and files == ["x.jsonl", "x.jsonl.1", "x.jsonl.2"]
    assert errors == ["RuntimeError('provider died')"]


def test_device_memory_names_its_device():
    assert tmet.device_memory(None) == {}
    assert tmet.device_memory("cpu") == {}
    assert tmet.device_memory(torch.device("cpu")) == {}


# ----------------------------------------------------------- compile monitor

def test_compile_monitor_counts_first_use_builds(monkeypatch, tmp_path):
    """One count a library's first build and load, its milliseconds
    rounded as JAX rounds a compile's; the build hook leaves with the last
    registry."""
    import tpu_radix_join.observability.compilemon as jcm
    monkeypatch.setattr(_build, "build", lambda names, ptxas_verbose=False:
                        {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name, ptxas_verbose=False: tmp_path / name)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_loaded", {})
    secs = iter([0.0, 0.2504, 1.0, 1.0])
    monkeypatch.setattr(_build, "time",
                        type("T", (), {"perf_counter":
                                       staticmethod(lambda: next(secs))}))
    m, other = tmeas.Measurements(), tmeas.Measurements()
    tcm.install_compile_monitor(m)
    tcm.install_compile_monitor(m)            # idempotent
    tcm.install_compile_monitor(other)
    _build.library("fake")
    _build.library("fake")                    # loaded: no second count
    tcm.uninstall_compile_monitor(other)
    _build.library("other")
    tcm.uninstall_compile_monitor(m)
    assert _build._hooks == []
    assert (m.counters["NCOMPILE"], m.counters["COMPILEMS"]) == (2, 250)
    assert (other.counters["NCOMPILE"], other.counters["COMPILEMS"]) == (
        1, 250)
    jm = jmeas.Measurements()
    jcm._active.append(jm)
    try:
        jcm._on_duration(jcm.BACKEND_COMPILE_EVENT, 0.2504)
    finally:
        jcm._active.remove(jm)
    assert jm.counters["NCOMPILE"] == 1 and jm.counters["COMPILEMS"] == 250


def test_session_recompile_canary(monkeypatch, capsys):
    """A kernel build during a query after the first ticks the canary: a
    ``recompile_storm`` event, the summary's count, the ledger row's
    ``ncompile``; the first query's builds do not."""
    import tpu_radix_join_torch.service as tsvc
    from tpu_radix_join_torch import JoinConfig

    rows = []

    class Ledger:
        def append(self, kind, payload):
            rows.append(payload)

    m = tmeas.Measurements()
    tcm.install_compile_monitor(m)
    sess = tsvc.JoinSession(JoinConfig(), measurements=m, device="cpu",
                            ledger=Ledger())
    real = sess.engine.join_arrays

    def join_with_build(*a, **kw):
        tcm._on_build("radix_sort", 0.5)
        return real(*a, **kw)

    try:
        sess.engine.join_arrays = join_with_build
        for qid in ("q0", "q1"):
            sess.submit(tsvc.QueryRequest(qid, tuples_per_node=256))
            assert sess.run_next().status == "ok"
        summary = sess.summary()
    finally:
        sess.close()
        tcm.uninstall_compile_monitor(m)
    assert summary["ncompile"] == 2 and summary["compile_ms"] == 1000
    assert summary["recompile_storms"] == 1
    assert [r["ncompile"] for r in rows] == [1, 1]
    storms = [d for name, d in m.events if name == "recompile_storm"]
    assert storms == [{"query_id": "q1", "ncompile_delta": 1,
                       "completed": 1}]
    assert "recompile storm: query q1" in capsys.readouterr().err


# ----------------------------------------------------------------- statusz

def test_statusz_snapshot_health_and_http_equal_jax():
    sections = {"ok": lambda: {"x": 1}, "boom": lambda: 1 / 0}
    views = []
    for name, (*_, stz_mod, _) in PKGS.items():
        srv = stz_mod.StatuszServer(port=0, sections=sections)
        snap = srv.snapshot()
        snap.pop("t_epoch_s")
        one = srv.snapshot("nope")
        one.pop("t_epoch_s")
        health = [srv.health()]
        for verdict in ({"ok": False, "reason": "breaker_open"}, True,
                        lambda: 1 / 0):
            srv.set_readiness(verdict if callable(verdict)
                              else (lambda v=verdict: v))
            code, body = srv.health()
            body.pop("t_epoch_s")
            health.append((code, body))
        code, body = health[0]
        body.pop("t_epoch_s")
        views.append((snap, one, health))
    assert views[0] == views[1]
    snap, one, health = views[0]
    assert snap["ok"] == {"x": 1} and "ZeroDivisionError" in snap["boom"][
        "error"]
    assert one["nope"]["sections"] == ["boom", "ok"]
    assert [c for c, _ in health] == [200, 503, 200, 503]
    srv = tstz.StatuszServer(port=0, sections=sections)
    with srv:
        base = f"http://127.0.0.1:{srv.port}"
        assert _get(base + "/statusz")[1]["ok"] == {"x": 1}
        assert "boom" not in _get(base + "/statusz/ok")[1]
        assert _get(base + "/healthz")[0] == 200
        srv.set_readiness(lambda: {"ok": False, "reason": "draining"})
        code, body = _get(base + "/healthz")
        assert code == 503 and body["reason"] == "draining"
        assert _get(base + "/nope")[0] == 404
    assert srv.requests_served == 4


def test_measurements_sections_equal_jax():
    got = []
    for name, (*_, stz_mod, meas_mod) in PKGS.items():
        m = meas_mod.Measurements()
        m.attach_tracer(trace_id="cafe")
        m.incr("MTUPLES", 7)
        m.add_time_us("JPROC", 12.34)
        m.tracer.begin("JPROC")
        secs = stz_mod.measurements_sections(m)
        phase = secs["phase"]()
        phase.pop("idle_s")
        got.append((sorted(secs), phase, secs["counters"]()))
    assert got[0] == got[1]
    assert got[0][1] == {"open_spans": {"JPROC": 1},
                         "context": {"trace_id": "cafe"}}


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body.startswith(b"{") else None)


def _jax_serve_sections():
    """The section names JAX's serve loop registers (tpu_radix_join/
    main.py:722-780), read from its source."""
    src = (ROOT / "tpu_radix_join" / "main.py").read_text()
    body = src[src.index("def _run_serve"):src.index("def _run_fleet")]
    return set(re.findall(r'sections\["(\w+)"\]', body)) | {"phase",
                                                            "counters"}


class _Pipe(io.TextIOBase):
    """stdin for the serve loop: lines fed one at a time by the test."""

    def __init__(self):
        self._lines = []
        self._cv = threading.Condition()
        self._closed = False

    def feed(self, line):
        with self._cv:
            self._lines.append(line)
            self._cv.notify()

    def close_input(self):
        with self._cv:
            self._closed = True
            self._cv.notify()

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            while not self._lines and not self._closed:
                self._cv.wait(5.0)
            if self._lines:
                return self._lines.pop(0)
            raise StopIteration


def test_serve_statusz_live_sections_and_health(tmp_path, monkeypatch,
                                                capsys):
    """``--serve - --statusz 0`` answers while it serves: the service,
    leases, cache, batch, hedge and critical_paths sections (JAX's), the
    hedge posture, the served query's critical path, the lease younger than
    its lapse window, /healthz 200; after the session closes, the lease is
    withdrawn."""
    servers = []

    class Recorded(tstz.StatuszServer):
        def start(self):
            servers.append(self)
            return super().start()

    monkeypatch.setattr(tstz, "StatuszServer", Recorded)
    pipe = _Pipe()
    monkeypatch.setattr("sys.stdin", pipe)
    lease_dir = tmp_path / "leases"
    argv = ["--serve", "-", "--device", "cpu", "--statusz", "0",
            "--elastic", "on", "--lease-dir", str(lease_dir),
            "--rank-lease-s", "30", "--result-cache", "4",
            "--batch-window-ms", "5", "--tuples-per-node", "256",
            "--timeline-dir", str(tmp_path / "tl")]
    rc = []
    worker = threading.Thread(target=lambda: rc.append(tmain(argv)))
    worker.start()
    try:
        t0 = time.monotonic()
        while not servers or servers[0].port == 0:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        base = f"http://127.0.0.1:{servers[0].port}"
        pipe.feed(json.dumps({"query_id": "q0", "tuples_per_node": 256})
                  + "\n")
        while _get(base + "/statusz/service")[1]["service"]["slo"][
                "queries_submitted"] < 1:
            assert time.monotonic() - t0 < 30
            time.sleep(0.02)
        # the query's path joins the section after its outcome
        while not _get(base + "/statusz/critical_paths")[1][
                "critical_paths"]:
            assert time.monotonic() - t0 < 30
            time.sleep(0.02)
        code, body = _get(base + "/statusz")
        assert code == 200
        names = set(body) - {"t_epoch_s"}
        assert names == _jax_serve_sections()
        assert names == {"phase", "counters", "service", "leases", "cache",
                         "batch", "hedge", "critical_paths"}
        assert body["hedge"] == {"mode": "off", "threshold": 0.5,
                                 "elastic_grow": False, "hedged": 0,
                                 "wins": 0, "wasted": 0}
        (path,) = body["critical_paths"]
        assert path["query_id"] == "q0" and path["ranks"] == [0]
        assert "error" not in path and path["path_ms"] > 0
        lease = _get(base + "/statusz/leases")[1]["leases"]["lease"]
        assert lease["rank"] == 0 and lease["status"] == "member"
        on_disk = json.loads((lease_dir / "lease_r0.json").read_text())
        assert time.time() - on_disk["t_epoch_s"] < 60.0
        code, health = _get(base + "/healthz")
        assert code == 200 and health["ok"] is True
        assert body["counters"]["counters"]["QADMIT"] >= 1
    finally:
        pipe.close_input()
        worker.join(60)
    assert rc == [0]
    assert not (lease_dir / "lease_r0.json").exists()
    outs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"event": "outcome"')]
    assert [(o["query_id"], o["matches"], o["expected"]) for o in outs] == [
        ("q0", 256, 256)]
