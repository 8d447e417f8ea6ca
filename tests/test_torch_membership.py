"""Lease-based membership of the port against the JAX package's
(``robustness/membership.py``), JAX's own cases
(``tests/test_elastic_recovery.py:38-174`` and ``:437-537``) each run
against both packages on one fake clock: the lease round trip, lapse with
a start-up grace, one missed beat, a torn lease, one epoch bump a batch,
the fence, the watchdog's triage, ``sampler_extra``, admission once a
batch, a lost rank's way back, a stale joining lease, a joiner's epoch
catch-up.  Every observation (leases read back, lapsed ranks, epochs,
counters, events) is held exactly, wall-clock and pid fields excluded.
Then the serve worker's liveness on the port: ``JoinSession(membership=,
elastic=True)`` at one rank and the command line ``--serve - --elastic on
... --device cpu`` serving exact outcomes while it writes the lease, the
metrics lines and the span file, and withdraws the lease at exit."""

import io
import json

import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join.performance.measurements as jmeas  # noqa: E402
import tpu_radix_join.robustness.membership as jmem  # noqa: E402

import tpu_radix_join_torch.performance.measurements as tmeas  # noqa: E402
import tpu_radix_join_torch.robustness.membership as tmem  # noqa: E402
import tpu_radix_join_torch.service as tsvc  # noqa: E402
from tpu_radix_join_torch import JoinConfig  # noqa: E402
from tpu_radix_join_torch.main import main as tmain  # noqa: E402
from tpu_radix_join_torch.observability import (load_samples,  # noqa: E402
                                                merge_timeline)

PKGS = {"port": (tmem, tmeas), "jax": (jmem, jmeas)}


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _lease(lease):
    """A lease read back, its pid and host (this process's) dropped."""
    if lease is None:
        return None
    return {k: getattr(lease, k) for k in ("rank", "epoch", "t_epoch_s",
                                           "seq", "status",
                                           "partitions_done")}


def _events(m):
    return [{k: v for k, v in e.items() if k not in ("t_s", "t_epoch_s")}
            for e in m.meta.get("events", [])]


def both(tmp_path, scenario):
    """``scenario(mem_module, Measurements, directory)`` on both packages;
    asserts the observations equal and returns the port's."""
    got = {name: scenario(mem, meas.Measurements, tmp_path / name)
           for name, (mem, meas) in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_lease_heartbeat_round_trip_equal_jax(tmp_path):
    def scenario(mem, _, d):
        clk = FakeClock()
        board = mem.LeaseBoard(str(d), rank=1, num_ranks=3, lease_s=5.0,
                               clock=clk)
        rec = board.heartbeat(epoch=2)
        first = _lease(board.read(1))
        board.heartbeat(epoch=2)
        return ({k: rec[k] for k in ("rank", "epoch", "t_epoch_s", "seq",
                                     "status", "partitions_done")},
                first, _lease(board.read(1)), board.lapse_window_s,
                board.discover())

    rec, first, second, window, ranks = both(tmp_path, scenario)
    assert rec["rank"] == 1 and rec["epoch"] == 2 and first["seq"] == 1
    assert second["seq"] == 2 and window == 10.0 and ranks == [0, 1, 2]


def test_lapse_detection_and_startup_grace_equal_jax(tmp_path):
    def scenario(mem, _, d):
        clk = FakeClock()
        a = mem.LeaseBoard(str(d), rank=0, num_ranks=2, lease_s=5.0,
                           clock=clk)
        b = mem.LeaseBoard(str(d), rank=1, num_ranks=2, lease_s=5.0,
                           clock=clk)
        b.heartbeat()
        seen = [a.lapsed()]
        for dt in (4.0, 2.0, 5.0):
            clk.t += dt
            seen.append(a.lapsed())
        c = mem.LeaseBoard(str(d / "g"), rank=0, num_ranks=2, lease_s=5.0,
                           clock=clk)
        seen.append(c.lapsed())
        for dt in (6.0, 5.0):
            clk.t += dt
            seen.append(c.lapsed())
        return seen

    assert both(tmp_path, scenario) == [[], [], [], [1], [], [], [1]]


def test_one_missed_beat_never_lapses_equal_jax(tmp_path):
    def scenario(mem, Meas, d):
        clk = FakeClock()
        m = Meas()
        a = mem.LeaseBoard(str(d), rank=0, num_ranks=2, lease_s=5.0,
                           clock=clk)
        b = mem.LeaseBoard(str(d), rank=1, num_ranks=2, lease_s=5.0,
                           clock=clk)
        view = mem.MembershipView(a, measurements=m)
        b.heartbeat()
        seen = []
        for dt, beat in ((7.0, False), (2.9, True), (9.9, False),
                         (0.2, False)):
            clk.t += dt
            if beat:
                b.heartbeat()
            seen.append(view.check())
        c = mem.LeaseBoard(str(d / "one"), rank=0, num_ranks=2, lease_s=5.0,
                           clock=clk, missed_beats=1)
        mem.LeaseBoard(str(d / "one"), rank=1, num_ranks=2, lease_s=5.0,
                       clock=clk).heartbeat()
        clk.t += 5.1
        seen.append(c.lapsed())
        with pytest.raises(ValueError):
            mem.LeaseBoard(str(d), rank=0, num_ranks=2, missed_beats=0)
        with pytest.raises(ValueError):
            mem.LeaseBoard(str(d), rank=0, num_ranks=2, lease_s=0.0)
        return seen, dict(m.counters), _events(m)

    seen, counters, events = both(tmp_path, scenario)
    assert seen == [[], [], [], [1], [1]]
    assert counters == {"MEPOCH": 1, "RANKLOST": 1}
    assert events == [{"event": "rank_lost", "ranks": [1], "epoch": 1,
                       "cause": "lease_lapse", "survivors": 1}]


def test_torn_lease_reads_as_absent_equal_jax(tmp_path):
    def scenario(mem, _, d):
        board = mem.LeaseBoard(str(d), rank=0, num_ranks=2, lease_s=5.0)
        with open(board.lease_path(1), "w") as f:
            f.write('{"rank": 1, "epo')
        (d / "lease_rX.json").write_text("{}")
        return board.read(1), board.discover(), mem.LeaseBoard.next_rank(
            str(d), floor=1)

    assert both(tmp_path, scenario) == (None, [0, 1], 2)


def test_one_epoch_bump_per_batch_equal_jax(tmp_path):
    def scenario(mem, Meas, d):
        clk = FakeClock()
        board = mem.LeaseBoard(str(d), rank=0, num_ranks=4, lease_s=5.0,
                               clock=clk)
        m = Meas()
        view = mem.MembershipView(board, measurements=m)
        for r in (1, 2, 3):
            mem.LeaseBoard(str(d), rank=r, num_ranks=4, lease_s=5.0,
                           clock=clk).heartbeat()
        seen = [view.check()]
        clk.t += 11.0
        seen += [view.check(), view.check()]
        return (seen, view.epoch, dict(m.counters), view.survivors,
                sorted(view.lost), m.flightrec.context)

    seen, epoch, counters, survivors, lost, ctx = both(tmp_path, scenario)
    assert seen == [[], [1, 2, 3], []] and epoch == 1
    assert counters == {"MEPOCH": 1, "RANKLOST": 3} and survivors == [0]
    assert ctx == {"membership_epoch": 1}


def test_epoch_fence_and_require_live_equal_jax(tmp_path):
    def scenario(mem, _, d):
        view = mem.MembershipView(mem.LeaseBoard(str(d), rank=0,
                                                 num_ranks=2, lease_s=5.0))
        view.fence(0)
        epoch = view.declare_lost(1, cause="test")
        with pytest.raises(mem.StaleEpoch) as ei:
            view.fence(0)
        with pytest.raises(mem.RankLost) as lost:
            view.require_live(1)
        return (epoch, ei.value.failure_class, ei.value.stamped,
                ei.value.current, str(ei.value), lost.value.bundle_extra,
                str(lost.value), view.board.read(1))

    got = both(tmp_path, scenario)
    assert got[:4] == (1, "rank_lost", 0, 1) and got[-1] is None


def test_suspect_triage_equal_jax(tmp_path):
    def scenario(mem, _, d):
        clk = FakeClock()
        board = mem.LeaseBoard(str(d), rank=0, num_ranks=2, lease_s=5.0,
                               clock=clk)
        mem.LeaseBoard(str(d), rank=1, num_ranks=2, lease_s=5.0,
                       clock=clk).heartbeat()
        view = mem.MembershipView(board)
        live = view.suspect()
        clk.t += 11.0
        exc = view.suspect()
        return (live, type(exc).__name__, exc.rank, exc.failure_class,
                exc.bundle_extra, str(exc))

    got = both(tmp_path, scenario)
    assert got[0] is None and got[1] == "RankLost" and got[2] == 1
    assert got[4] == {"lost_rank": 1, "membership_epoch": 1}


def test_sampler_extra_heartbeats_equal_jax(tmp_path):
    def scenario(mem, _, d):
        clk = FakeClock()
        board = mem.LeaseBoard(str(d), rank=0, num_ranks=1, lease_s=5.0,
                               clock=clk)
        board.progress_of = lambda: 7
        view = mem.MembershipView(board)
        extra = board.sampler_extra(epoch_of=view.epoch_of,
                                    status_of=view.my_status)
        recs = [extra()["lease"] for _ in range(2)]
        board.progress_of = lambda: 1 / 0       # advisory, never lethal
        recs.append(extra()["lease"])
        for r in recs:
            r.pop("pid")
            r.pop("host")
        return recs, _lease(board.read(0))

    recs, last = both(tmp_path, scenario)
    assert [r["seq"] for r in recs] == [1, 2, 3]
    assert [r["partitions_done"] for r in recs] == [7, 7, -1]
    assert recs[0]["status"] == "member" and last["seq"] == 3


def test_admission_once_per_batch_equal_jax(tmp_path):
    def scenario(mem, Meas, d):
        clk = FakeClock()
        m = Meas()
        board = mem.LeaseBoard(str(d), rank=0, num_ranks=2, lease_s=5.0,
                               clock=clk, measurements=m)
        peer = mem.LeaseBoard(str(d), rank=1, num_ranks=2, lease_s=5.0,
                              clock=clk)
        board.heartbeat(0)
        peer.heartbeat(0)
        view = mem.MembershipView(board, measurements=m)
        for r in (2, 3):
            mem.LeaseBoard(str(d), rank=r, num_ranks=2, lease_s=5.0,
                           clock=clk).heartbeat(0, status="joining")
        seen = [view.check(), sorted(view.joined), view.epoch]
        seen += [view.check(), view.epoch, view.survivors]
        return seen, dict(m.counters), _events(m)

    seen, counters, events = both(tmp_path, scenario)
    assert seen == [[], [2, 3], 1, [], 1, [0, 1, 2, 3]]
    assert counters == {"MEPOCH": 1, "RANKJOIN": 2}
    assert events[0]["event"] == "rank_join" and events[0]["ranks"] == [2, 3]


def test_lost_rank_readmits_only_via_joining_lease_equal_jax(tmp_path):
    def scenario(mem, _, d):
        clk = FakeClock()
        board = mem.LeaseBoard(str(d), rank=0, num_ranks=2, lease_s=5.0,
                               clock=clk)
        peer = mem.LeaseBoard(str(d), rank=1, num_ranks=2, lease_s=5.0,
                              clock=clk)
        board.heartbeat(0)
        peer.heartbeat(0)
        view = mem.MembershipView(board)
        clk.t += 11.0
        board.heartbeat(0)
        seen = [view.check(), view.epoch]
        peer.heartbeat(1)                  # a zombie's member lease
        seen += [view.check(), 1 in view.lost, view.epoch]
        peer.heartbeat(1, status="joining")
        view.check()
        seen += [view.is_live(1), sorted(view.joined), view.epoch]
        return seen

    assert both(tmp_path, scenario) == [[1], 1, [], True, 1, True, [1], 2]


def test_stale_joining_lease_and_sync_epoch_equal_jax(tmp_path):
    def scenario(mem, _, d):
        clk = FakeClock()
        board = mem.LeaseBoard(str(d), rank=0, num_ranks=1, lease_s=5.0,
                               clock=clk)
        board.heartbeat(0)
        view = mem.MembershipView(board)
        joiner = mem.LeaseBoard(str(d), rank=1, num_ranks=1, lease_s=5.0,
                                clock=clk)
        joiner.heartbeat(0, status="joining")
        clk.t += 11.0
        board.heartbeat(0)
        view.check()
        seen = [sorted(view.joined), view.epoch]
        joiner.heartbeat(0, status="joining")
        view.check()
        seen += [sorted(view.joined), view.epoch]
        mem.LeaseBoard(str(d / "s"), rank=0, num_ranks=2,
                       lease_s=5.0).heartbeat(3)
        newcomer = mem.LeaseBoard(str(d / "s"), rank=2, num_ranks=2,
                                  lease_s=5.0)
        newcomer.heartbeat(0, status="joining")
        late = mem.MembershipView(newcomer)
        seen += [late.my_status(), late.sync_epoch(), late.sync_epoch()]
        return seen

    assert both(tmp_path, scenario) == [[], 0, [1], 1, "joining", 3, 3]


# ------------------------------------------------------- the serve worker

def test_session_takes_a_one_rank_membership(tmp_path):
    """``membership=`` and ``elastic=True`` at one rank: the view's epoch
    keys the session (``_epoch``), the heartbeat tick writes the lease and
    carries the membership block; over two ranks (a gloo world of
    tests/torch_dist_worker.py) every rank's session takes a view over both
    and serves exact queries, its block naming both survivors."""
    clk = FakeClock()
    board = tmem.LeaseBoard(str(tmp_path / "leases"), rank=0, num_ranks=1,
                            lease_s=1.0, clock=clk)
    view = tmem.MembershipView(board)
    sess = tsvc.JoinSession(JoinConfig(), membership=view, elastic=True,
                            device="cpu")
    try:
        assert sess._epoch() == 0
        view.epoch = 4
        assert sess._epoch() == 4
        tick = sess.heartbeat_tick()
        assert tick["membership"] == {"epoch": 4, "lost": [],
                                      "survivors": [0]}
        assert tick["lease"]["epoch"] == 4 and board.read(0).seq == 1
        assert "lease" not in sess._heartbeat_extra()
        path = tmp_path / "hb.jsonl"
        sampler = sess.attach_heartbeat(str(path), 3600.0)
        assert sampler.device == sess.device
    finally:
        sess.close()
    recs = load_samples(str(path))
    assert len(recs) == 2 and recs[-1]["lease"]["seq"] == 3
    assert recs[-1]["slo"]["queries_submitted"] == 0
    from torch_dist_worker import WorkerPool
    pool = WorkerPool(2, tmp_path, deadline_s=120.0)
    try:
        outs = pool.run({"kind": "serve", "config": {"num_nodes": 2},
                         "lease_dir": str(tmp_path / "world_leases"),
                         "requests": [{"query_id": f"m{i}",
                                       "tuples_per_node": 512, "seed": i}
                                      for i in range(2)]})
    finally:
        pool.close()
    for rank, got in enumerate(outs):
        assert [(o["status"], o["matches"]) for o in got["outcomes"]] == \
            [("ok", 1024)] * 2
        assert got["membership"] == {"epoch": 0, "lost": [],
                                     "survivors": [0, 1]}


def test_cli_serve_worker_liveness(tmp_path, monkeypatch, capsys):
    """The worker command line as a fleet starts it, on the CPU: exact
    outcomes; the lease written before any work and on every tick, then
    withdrawn; one metrics line a tick; the span file merged into a
    timeline (its queries as spans); a failed query's bundle."""
    reqs = [{"query_id": f"q{i}", "tuples_per_node": 512, "seed": 3 + i}
            for i in range(3)] + [{"query_id": "late", "deadline_s": 0.0}]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in reqs)))
    monkeypatch.setenv("TPU_RJ_WORKER_INCARNATION", "w0i1")
    d, t, f = tmp_path / "D", tmp_path / "T", tmp_path / "F"
    rc = tmain(["--serve", "-", "--elastic", "on", "--lease-dir", str(d),
                "--rank-lease-s", "1", "--rank-missed-beats", "2",
                "--metrics-interval", "0.25", "--timeline-dir", str(t),
                "--statusz", "0", "--forensics-dir", str(f),
                "--watchdog-timeout", "30", "--device", "cpu"])
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    outs = {r["query_id"]: r for r in recs if r["event"] == "outcome"}
    summary = recs[-1]
    assert rc == 1                          # the failed query, as JAX's
    for i in range(3):
        assert outs[f"q{i}"]["matches"] == outs[f"q{i}"]["expected"] == 512
    assert outs["late"]["failure_class"] == "deadline_exceeded"
    assert summary["queries_ok"] == 3 and summary["recompile_storms"] == 0
    assert not (d / "lease_r0.json").exists()         # withdrawn at exit
    samples = load_samples(str(t / "0.metrics.jsonl"))
    leases = [s["lease"] for s in samples if "lease" in s]
    assert len(samples) >= 2 and len(leases) == len(samples)
    assert [x["seq"] for x in leases] == sorted({x["seq"] for x in leases})
    assert leases[0]["seq"] >= 2           # the first lease preceded them
    assert "slo" in samples[-1] and samples[-1]["devices"] == {}
    doc = merge_timeline(str(t))
    queries = [e for e in doc["traceEvents"] if e["name"] == "query"]
    assert [e["args"]["query_id"] for e in queries] == [
        "q0", "q1", "q2", "late"]
    from tpu_radix_join_torch.observability import load_bundle
    b = load_bundle(outs["late"]["bundle"])
    assert b["query_id"] == "late"
    assert b["ring"]["context"] == {
        "worker_incarnation": "w0i1", "query_id": "late",
        "tenant": "default",
        "trace_id": doc["metadata"]["ranks"]["0"]["trace_id"]}
