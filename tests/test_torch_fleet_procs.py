"""The port's crash-only fleet with real worker processes on the CPU
(``--device cpu``, 1024 tuples a node): the cases of the JAX package's
``tests/test_fleet.py:219-333``, each asserting what JAX's asserts, with
every match count held to the oracle.

  * a worker SIGKILLed mid-query through the command line
    (``--fleet 2 --fleet-kill-at 2``): the survivor serves the replayed
    attempt, one outcome a query, ``double_exec == 0``; the supervisor
    makes no CUDA call;
  * a torn journal that the JAX package's ``QueryJournal`` wrote: a
    restarted port supervisor replays its intact intent exactly once;
  * the fixed-seed ``fleet.worker_kill`` mini soak on one supervisor;
  * the SIGTERM drain of ``--fleet 1 --serve -``.

The load stays bounded: at most two workers a fleet, each started with
``OMP_NUM_THREADS=1``, every process reaped in a ``finally`` and every
wait given a timeout."""

import json
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.service.journal import (  # noqa: E402
    QueryJournal as JQueryJournal)

from tpu_radix_join_torch.main import main as tmain  # noqa: E402
from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    Measurements)
from tpu_radix_join_torch.service.fleet import FleetSupervisor  # noqa: E402
from tpu_radix_join_torch.service.journal import QueryJournal  # noqa: E402

TPN = 1 << 10
WORKER_ARGS = ["--nodes", "1", "--verify", "check", "--device", "cpu"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _req(qid, tenant="default", **kw):
    kw.setdefault("tuples_per_node", TPN)
    kw.setdefault("seed", 7)
    return {"query_id": qid, "tenant": tenant, **kw}


def _outcome_lines(out):
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    return ([r for r in recs if r.get("event") == "outcome"],
            next((r for r in recs if r.get("event") == "summary"), None))


@pytest.fixture
def one_thread(monkeypatch):
    """Workers inherit the environment: one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return dict(os.environ)


def _no_cuda(monkeypatch):
    """The supervisor's process may make no CUDA call."""
    def refuse(*a, **k):
        raise AssertionError("the fleet supervisor made a CUDA call")

    for name in ("_lazy_init", "is_available", "current_device",
                 "device_count", "synchronize", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_fleet_cli_kill_mid_query_exactly_once(capsys, tmp_path, one_thread,
                                               monkeypatch):
    """``--fleet 2``: the 2nd dispatched query's worker is SIGKILLed with
    the request on its pipe, and the survivor serves the journal-replayed
    attempt: every query ends with exactly one oracle-exact outcome,
    ``double_exec == 0``, and the supervisor touched no device."""
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(
        json.dumps(_req(f"q{i}")) + "\n" for i in range(3)))
    d = tmp_path / "fleet"
    _no_cuda(monkeypatch)
    rc = tmain(["--fleet", "2", "--serve", str(reqs), *WORKER_ARGS,
                "--fleet-dir", str(d), "--fleet-kill-at", "2",
                "--seed", "7"])
    outcomes, summary = _outcome_lines(capsys.readouterr().out)
    assert rc == 0
    assert [o["query_id"] for o in outcomes] == ["q0", "q1", "q2"]
    assert all(o["status"] == "ok" for o in outcomes)
    assert all(o["matches"] == o["expected"] == TPN for o in outcomes)
    killed = outcomes[1]
    assert killed["fleet"]["attempts"] >= 2 and killed["fleet"]["replayed"]
    assert summary["failover"] >= 1 and summary["replayn"] >= 1
    assert summary["double_exec"] == 0 and summary["unacked"] == 0
    assert summary["drain"]["double_exec"] == 0
    assert summary["drain"]["leases_left"] == []
    aud = QueryJournal(str(d)).audit()
    assert aud.double_exec == 0 and aud.unacked == 0
    assert aud.outcomes == 3
    # each worker ran on the CPU because the supervisor was told so
    for slot in (0, 1):
        lines = (d / f"worker{slot}" / "0.metrics.jsonl").read_text()
        assert lines and all(json.loads(ln)["devices"] == {}
                             for ln in lines.splitlines())


def test_torn_jax_journal_replays_once_after_supervisor_restart(tmp_path,
                                                                one_thread):
    """A journal the JAX package's supervisor wrote, torn mid-append: the
    port's restarted supervisor replays the intact intent exactly once
    (the torn tail is skipped, not resurrected), and a re-submission is
    re-served from the journal without re-execution."""
    d = str(tmp_path / "fleet")
    j = JQueryJournal(d)
    r = _req("torn_q")
    j.append_intent(r, worker=0, incarnation="w0i1")
    with open(j.path, "a") as f:
        f.write('{"schema_version": 1, "kind": "intent", "fp": "dead')
    sup = FleetSupervisor(1, WORKER_ARGS, d, measurements=Measurements())
    try:
        sup.start()
        outs = sup.replay_unacknowledged()
        assert len(outs) == 1
        assert outs[0]["status"] == "ok"
        assert outs[0]["matches"] == outs[0]["expected"] == TPN
        assert outs[0]["fleet"]["replayed"]
        assert sup.replay_unacknowledged() == []
        again = sup.dispatch(r)
        assert again["fleet"].get("served_from_journal")
        assert again["matches"] == TPN
        report = sup.drain()
    finally:
        sup.close()
    assert report["unacked"] == 0 and report["double_exec"] == 0
    aud = QueryJournal(d).audit()
    assert aud.outcomes == 1 and aud.double_exec == 0
    assert JQueryJournal(d).audit().to_json() == aud.to_json()
    assert sup.measurements.counters["REPLAYN"] == 1


def test_fleet_chaos_mini_soak_fixed_seeds(tmp_path, one_thread):
    """Two seeded ``fleet.worker_kill`` schedules through ONE supervisor:
    zero violations, zero double executions, the supervisor survives its
    workers, and every served count is the oracle's."""
    from tpu_radix_join_torch.robustness.chaos import (FleetChaosRunner,
                                                       soak_fleet)
    sup = FleetSupervisor(2, WORKER_ARGS, str(tmp_path / "fleet"),
                          measurements=Measurements(),
                          restart_backoff_s=0.05)
    try:
        runner = FleetChaosRunner(sup, queries=2, size=TPN,
                                  bundle_dir=str(tmp_path / "bundles"))
        outcomes, summary = soak_fleet(2, base_seed=3, runner=runner)
    finally:
        sup.close()
    assert summary["violations"] == 0, [o.detail for o in outcomes]
    assert summary["double_exec"] == 0 and summary["unacked"] == 0
    assert summary["pass"] + summary["classified"] == 2
    assert [o.matches for o in outcomes] == [TPN, TPN]
    assert summary["failovers"] >= 1 and summary["replays"] >= 1
    assert not os.path.exists(tmp_path / "bundles")


def test_fleet_sigterm_drains_gracefully(tmp_path, one_thread):
    """SIGTERM with the request stream still open: admission stops, the
    served query stays answered, the journal drains to zero
    unacknowledged intents, every worker lease is withdrawn, exit 0."""
    d = str(tmp_path / "fleet")
    env = dict(one_thread)
    env["PYTHONPATH"] = (ROOT + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_radix_join_torch.main", "--fleet", "1",
         "--serve", "-", *WORKER_ARGS, "--fleet-dir", d],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, bufsize=1, env=env)
    try:
        proc.stdin.write(json.dumps(_req("drain_q")) + "\n")
        proc.stdin.flush()
        line = proc.stdout.readline()
        out = json.loads(line)
        assert out["event"] == "outcome" and out["status"] == "ok"
        assert out["matches"] == out["expected"] == TPN
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0
    _, summary = _outcome_lines(line + rest)
    assert summary is not None
    assert summary["drain"]["unacked"] == 0
    assert summary["drain"]["double_exec"] == 0
    assert summary["drain"]["leases_left"] == []
    leases = [os.path.join(root, f) for root, _, fs in os.walk(d)
              for f in fs if f.startswith("lease_")]
    assert leases == []
    assert QueryJournal(d).audit().unacked == 0
