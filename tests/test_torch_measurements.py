"""Port parity of the measurement registry (performance/measurements.py,
performance/trace.py) against the JAX package's ``Measurements``: the
exchange counters, the rates, the ``.perf`` lines and the rank-0 aggregate
of the same contents; ``.perf``/``.info`` directories written by either
package load in the other; ``_slim_meta``, ``exclude_from_running``, the
kernel-build hook (JCOMPILE), the memory probe, the dispatch floor, the
trace summary, ``gather_all``; the one-rank joins' timer tags and counters
against the JAX engine's; and the command line's ``[RESULTS]`` and
``[PERF]`` lines against the JAX command line's.  Counts and lines are
compared exactly; only timer values are left out."""

import contextlib
import dataclasses
import io
import json

import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.main import main as jax_main  # noqa: E402
from tpu_radix_join.performance import measurements as jmeas  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.main import main as tx_main  # noqa: E402
from tpu_radix_join_torch.ops.kernels import _build  # noqa: E402
from tpu_radix_join_torch.performance import measurements as tmeas  # noqa
from tpu_radix_join_torch.performance import trace as ttrace  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402

#: counters only the JAX package keeps (its backend's fallback and compile
#: monitors) and the rates, which divide host times
JAX_ONLY = {"PARTFALLBACK", "SORTFALLBACK", "NCOMPILE", "COMPILEMS"}
#: the arms' dispatch ticks: JAX's auto arms fall back on the CPU (its
#: *FALLBACK above) and tick no pass; the port's run K2 and K4 (their plain
#: versions here) and tick SORTPASS / PARTPASS a call
ARM_TAGS = {"SORTPASS", "PARTPASS"}
RATES = {"JRATE", "JPROCRATE", "HILOCRATE", "HOLOCRATE"}


def _filled(cls, node=0):
    """A registry of either package with the same timers and counters."""
    m = cls(node_id=node, num_nodes=2)
    for k, us in (("JTOTAL", 1234.4), ("JPROC", 1000.6), ("JHIST", 50.0),
                  ("SWINALLOC", 77.7)):
        m.add_time_us(k, us + node)
    m.incr("RTUPLES", 4096)
    m.incr("STUPLES", 8192)
    m.incr("RESULTS", 777 + node)
    m.record_exchange(4, 1024, 2048, tuple_bytes=12, wire_bytes=1000,
                      pack_ratio_pct=55.5, stages=2)
    m.record_exchange(4, 512, 256)
    m.meta["failure_class"] = "ok" if node == 0 else "capacity_overflow"
    m.meta["fault_sites"] = {"exchange.corrupt_lane": {"hits": 2,
                                                       "fired": node}}
    return m


def test_counters_rates_and_lines_equal_jax():
    got, want = _filled(tmeas.Measurements), _filled(jmeas.Measurements)
    got.derive_rates()
    want.derive_rates()
    assert dict(got.counters) == dict(want.counters)
    assert list(got.lines()) == list(want.lines())
    assert got.summary() == want.summary()


def test_print_results_equals_jax():
    got_out, want_out = io.StringIO(), io.StringIO()
    got = tmeas.print_results([_filled(tmeas.Measurements, i)
                               for i in range(3)], file=got_out)
    want = jmeas.print_results([_filled(jmeas.Measurements, i)
                                for i in range(3)], file=want_out)
    assert got == want
    assert got_out.getvalue() == want_out.getvalue()
    assert "FailureClasses: 2/3 ranks not ok" in got_out.getvalue()


@pytest.mark.parametrize("writer,reader", [
    (jmeas.Measurements, tmeas.Measurements),
    (tmeas.Measurements, jmeas.Measurements)])
def test_perf_directories_load_in_the_other_package(tmp_path, writer,
                                                    reader):
    for node in (0, 1):
        _filled(writer, node).store(str(tmp_path))
    (tmp_path / "notes.perf").write_text("stray\n")
    loaded = reader.load(str(tmp_path))
    assert [m.node_id for m in loaded] == [0, 1]
    for m in loaded:
        src = _filled(writer, m.node_id)
        src.derive_rates()
        assert dict(m.counters) == dict(src.counters)
        assert dict(m.times_us) == {k: float(f"{v:.0f}")
                                    for k, v in src.times_us.items()}
        info = json.loads((tmp_path / f"{m.node_id}.info").read_text())
        assert info["node"] == m.node_id and info["nodes"] == 2
        assert info["failure_class"] == src.meta["failure_class"]


def test_slim_meta_equals_jax():
    metas = []
    for cls in (tmeas.Measurements, jmeas.Measurements):
        m = cls()
        m.meta["failure_class"] = "ok"
        m.meta["bulk"] = "x" * 100_000
        for i in range(3):
            m.event("retry", attempt=i)
        slim = m._slim_meta()
        metas.append((slim.pop("epoch_s") == m.meta["epoch_s"], slim))
    assert metas[0] == metas[1] == (True, {
        "truncated": True, "failure_class": "ok", "events_count": 3})


def test_events_keep_the_jax_layout():
    got, want = tmeas.Measurements(), jmeas.Measurements()
    for m in (got, want):
        m.event("checkpoint_saved", pair=3)
    assert got.events == [("checkpoint_saved", {"pair": 3})]
    g, w = got.meta["events"][0], want.meta["events"][0]
    assert set(g) == set(w) and g["pair"] == w["pair"] == 3


class _Clock:
    """A stand-in for the registry's ``time`` module: a clock that moves
    only when told."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now

    def time(self):
        return 1e9 + self.now


def test_exclude_from_running_shifts_every_running_timer(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tmeas, "time", clock)
    m = tmeas.Measurements()
    m.start("JTOTAL")
    m.start("SWINALLOC")
    clock.now += 0.05
    m.exclude_from_running(40_000)
    m.stop("SWINALLOC")
    clock.now += 0.002
    m.stop("JTOTAL")
    m.start("JPROC")          # started after: not shifted
    clock.now += 0.003
    m.stop("JPROC")
    assert m.times_us["SWINALLOC"] == pytest.approx(10_000)
    assert m.times_us["JTOTAL"] == pytest.approx(12_000)
    assert m.times_us["JPROC"] == pytest.approx(3_000)


def test_kernel_build_is_jcompile_outside_the_join_timers(monkeypatch,
                                                          tmp_path):
    """A first-use build inside a join lands in JCOMPILE and is excluded
    from JTOTAL; a build that fails raises and reports nothing."""
    clock = _Clock()
    monkeypatch.setattr(tmeas, "time", clock)
    monkeypatch.setattr(_build, "time", clock)

    def slow_build(names, ptxas_verbose=False):
        clock.now += 0.2
        if "broken" in names:
            raise RuntimeError("nvcc failed for broken")
        return {}

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "library_path",
                        lambda name, ptxas_verbose=False: tmp_path / name)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_loaded", {})
    m = tmeas.Measurements()
    eng = tx.HashJoin(device="cpu", measurements=m)
    heard = []
    with _build.on_build(lambda name, s: heard.append(name)):
        with eng._measured():
            clock.now += 0.01
            _build.library("fake")
            _build.library("fake")          # loaded: no second build
            with pytest.raises(RuntimeError, match="broken"):
                _build.library("broken")
    assert heard == ["fake"]
    assert m.times_us["JCOMPILE"] == pytest.approx(200_000)
    # JTOTAL holds the failed build's 0.2 s, not the recorded one's
    assert m.times_us["JTOTAL"] == pytest.approx(210_000)
    assert _build._hooks == []


def test_memory_utilization(monkeypatch):
    m = tmeas.Measurements()
    out = m.memory_utilization()
    assert out["VmRSS"] > 0 and out["VmSize"] >= out["VmRSS"]
    assert not any(k.startswith("device") for k in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 10 + i)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i: 100 + i)
    out = m.memory_utilization()
    assert {k: v for k, v in out.items() if k.startswith("device")} == {
        "device0_bytes_in_use": 10, "device0_peak_bytes_in_use": 100,
        "device1_bytes_in_use": 11, "device1_peak_bytes_in_use": 101}
    assert m.meta["memory"] == out


def test_dispatch_floor_on_the_cpu():
    m = tmeas.Measurements()
    us = m.measure_dispatch_floor(iters=5, device="cpu")
    assert m.times_us["SDISPATCH"] == us > 0


def test_trace_on_the_cpu_sets_the_table_and_no_ctotal(tmp_path):
    m = tmeas.Measurements()
    with m.trace(str(tmp_path / "trace")):
        tx.HashJoin(device="cpu", measurements=m).join(
            tx.Relation(2048, 1, "unique", seed=1),
            tx.Relation(2048, 1, "unique", seed=2))
    summary = m.meta["trace"]
    assert summary["plane"] == "/host:CPU" and summary["busy_us"] > 0
    assert "CTOTAL" not in m.times_us and "JTOTAL" in m.times_us
    assert (tmp_path / "trace" / "0.trace.json").exists()
    ops = ttrace.top_ops(summary, 3)
    assert len(ops) == 3 and ops[0][1] >= ops[1][1] >= ops[2][1]


def test_trace_summary_of_a_device_timeline(tmp_path):
    """The device plane: kernels, memsets and copies on two streams; busy
    time is their union, and CTOTAL takes it."""
    def ev(cat, name, ts, dur, stream=7, dev=0):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": dev, "tid": stream,
                "args": {"device": dev, "stream": stream}}

    events = [ev("kernel", "onesweep", 0, 10), ev("kernel", "onesweep", 20, 10),
              ev("gpu_memset", "Memset", 5, 10, stream=9),
              ev("gpu_memcpy", "Memcpy DtoH", 40, 2),
              ev("kernel", "other_card", 0, 1, dev=1),
              {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 0,
               "dur": 1000, "pid": 1, "tid": 1}]
    (tmp_path / "0.trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    summary = ttrace.summarize_trace(str(tmp_path))
    assert summary == {"plane": "/device:GPU:0", "busy_us": 27.0, "ops": {
        "onesweep": {"us": 20.0, "count": 2},
        "Memset": {"us": 10.0, "count": 1},
        "Memcpy DtoH": {"us": 2.0, "count": 1}}}
    assert ttrace.top_ops(summary, 1) == [("onesweep", 20.0, 2)]
    assert ttrace.union_us([(0, 1), (3, 4), (0.5, 2)]) == 3.0
    assert ttrace.summarize_trace(str(tmp_path / "none")) is None


class _TwoRanks:
    """A world of two ranks whose ``all_gather`` returns this rank's slot
    and a given peer's slot, in rank order."""
    size, backend = 2, "gloo"

    def __init__(self, rank, peer):
        self.rank, self.peer = rank, peer

    def all_gather(self, x):
        rows = [x, self.peer] if self.rank == 0 else [self.peer, x]
        return torch.stack(rows)


def test_gather_all_decodes_every_rank():
    ms = [_filled(tmeas.Measurements, i) for i in range(2)]
    ms[1].meta["bulk"] = "x" * 70_000          # too big: slimmed
    assert ms[0].gather_all() == [ms[0]]
    slots = []
    for m in ms:
        class Capture:
            size, backend, rank = 2, "gloo", m.node_id

            def all_gather(self, x):
                slots.append(x.clone())
                return torch.stack([x, x])
        m.gather_all(Capture())
    assert all(s.dtype == torch.uint8 and s.numel() == 1 << 16
               for s in slots)
    got = ms[0].gather_all(_TwoRanks(0, slots[1]))
    assert [g.node_id for g in got] == [0, 1]
    for g, m in zip(got, ms):
        assert dict(g.counters) == dict(m.counters)
        assert dict(g.times_us) == dict(m.times_us)
    assert got[0].meta["fault_sites"] == ms[0].meta["fault_sites"]
    assert got[1].meta["truncated"] and got[1].meta["failure_class"] == \
        "capacity_overflow"


@pytest.mark.parametrize("fields", [
    {}, {"probe_algorithm": "bucket"},
    {"probe_algorithm": "bucket", "measure_phases": True},
    {"two_level": True, "local_fanout_bits": 3, "measure_phases": True},
    {"chunk_size": 700, "measure_phases": True},
    {"chunk_size": 1000, "key_bits": 64}])
def test_one_rank_registry_equals_jax(fields):
    """Timer tags and counters of one join against the JAX engine's."""
    kb = fields.get("key_bits", 32)
    jcfg = jx.JoinConfig(**fields)
    rels = [dict(global_size=4096, num_nodes=1, kind="unique", seed=1,
                 key_bits=kb),
            dict(global_size=4096, num_nodes=1, kind="modulo", seed=2,
                 modulo=700, key_bits=kb)]
    jm = jmeas.Measurements()
    want = jx.HashJoin(jcfg, measurements=jm).join(
        *[jx.Relation(**r) for r in rels])
    m = tmeas.Measurements()
    got = tx.HashJoin(config_from_jax(dataclasses.asdict(jcfg)),
                      device="cpu", measurements=m).join(
        *[tx.Relation(**r) for r in rels])
    assert got.matches == want.matches == 4096
    assert set(m.times_us) == set(jm.times_us) - {"JCOMPILE"}
    assert {k: v for k, v in m.counters.items()
            if k not in RATES | ARM_TAGS} == {
        k: v for k, v in jm.counters.items()
        if k not in RATES | JAX_ONLY | ARM_TAGS}
    assert m.meta.get("key_range") == jm.meta.get("key_range")
    assert m.meta.get("exchange_plan") == jm.meta.get("exchange_plan")


def _report(main, argv, capsys):
    assert main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    results = [ln for ln in lines if ln.startswith(("[RESULTS] Tuples",
                                                     "[RESULTS] Expected",
                                                     "[RESULTS] Conserv"))]
    counters = [ln for ln in lines if ln.startswith("[PERF]")
                and ln.endswith("\tcount")
                and ln.split()[1] not in RATES | JAX_ONLY | ARM_TAGS]
    return lines, results, counters


@pytest.mark.parametrize("flags", [[], ["--probe", "bucket",
                                        "--measure-phases"]])
def test_cli_report_equals_the_jax_cli(tmp_path, capsys, flags):
    argv = ["--tuples-per-node", "4096", "--outer-kind", "modulo", *flags]
    _, want_results, want_counters = _report(
        jax_main, ["--nodes", "1", "--output-dir", str(tmp_path / "jax"),
                   *argv], capsys)
    lines, results, counters = _report(
        tx_main, ["--device", "cpu", "--output-dir", str(tmp_path / "port"),
                  *argv], capsys)
    assert results == want_results and len(results) == 3
    assert counters == want_counters
    assert "[RESULTS] Expected: 4096 (OK)" in results
    assert lines[-2] == f"[PERF] stored {tmp_path / 'port' / '0.perf'}"
    res = json.loads(lines[-1])
    assert res["phases_us"]["JTOTAL"] > 0 and res["counters"]["RESULTS"] == 4096
    assert "SDISPATCH" in res["phases_us"]
    (m,) = tmeas.Measurements.load(str(tmp_path / "port"))
    assert m.times_us["JTOTAL"] > 0
    info = json.loads((tmp_path / "port" / "0.info").read_text())
    assert info["failure_class"] == "ok" and info["memory"]["VmRSS"] > 0


def test_cli_trace_needs_the_output_dir(capsys):
    with contextlib.suppress(SystemExit):
        tx_main(["--device", "cpu", "--trace"])
    assert "--output-dir" in capsys.readouterr().err
