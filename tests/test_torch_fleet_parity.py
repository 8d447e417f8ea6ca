"""The port's ``--fleet`` against the JAX package's on one request file:
``main([... "--fleet", "2", ..., "--fleet-kill-at", "2"])`` of each
package, each with its own workers on the CPU (one OpenMP thread each),
gives the same outcome lines, the same summary counters and the same
journal audit."""

import json

import pytest

pytest.importorskip("torch")

from tpu_radix_join.main import main as jmain  # noqa: E402
from tpu_radix_join.service.journal import (  # noqa: E402
    QueryJournal as JQueryJournal)

from tpu_radix_join_torch.main import main as tmain  # noqa: E402
from tpu_radix_join_torch.service.journal import QueryJournal  # noqa: E402

TPN = 1 << 10
OUTCOME_KEYS = ("query_id", "status", "matches", "expected", "failure_class")
SUMMARY_KEYS = ("workers", "queries", "failover", "replayn",
                "worker_restarts", "incarnations", "journal_served",
                "jdepth", "unacked", "double_exec", "cache_hits",
                "quarantined")


def _run(fn, capsys, argv):
    rc = fn(argv)
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    return (rc, [r for r in recs if r.get("event") == "outcome"],
            next(r for r in recs if r.get("event") == "summary"))


def test_fleet_kill_at_equals_jax(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    reqs = tmp_path / "reqs.jsonl"
    lines = [{"query_id": f"q{i}", "tenant": f"t{i % 2}",
              "tuples_per_node": TPN, "seed": 7 + i} for i in range(3)]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in lines))
    flags = ["--fleet", "2", "--serve", str(reqs), "--nodes", "1",
             "--verify", "check", "--fleet-kill-at", "2", "--seed", "7"]
    jd, td = tmp_path / "jax", tmp_path / "port"
    j = _run(jmain, capsys, flags + ["--fleet-dir", str(jd)])
    t = _run(tmain, capsys, flags + ["--fleet-dir", str(td),
                                     "--device", "cpu"])
    assert t[0] == j[0] == 0
    key = [[[(k, o[k]) for k in OUTCOME_KEYS]
            + [("attempts", o["fleet"]["attempts"]),
               ("replayed", o["fleet"]["replayed"]),
               ("worker", o["fleet"]["worker"]),
               ("incarnation", o["fleet"]["incarnation"])]
            for o in outs] for outs in (t[1], j[1])]
    assert key[0] == key[1]
    assert [o["matches"] for o in t[1]] == [TPN] * 3
    assert sum(o["fleet"]["replayed"] for o in t[1]) == 1
    for k in SUMMARY_KEYS:
        assert t[2][k] == j[2][k], k
    assert t[2]["failover"] >= 1 and t[2]["replayn"] >= 1
    for k in ("unacked", "double_exec", "leases_left"):
        assert t[2]["drain"][k] == j[2]["drain"][k], k
    taud = QueryJournal(str(td)).audit().to_json()
    assert taud == JQueryJournal(str(jd)).audit().to_json()
    assert taud == {"intents": 3, "outcomes": 3, "unacked": 0,
                    "double_exec": 0, "replays": 1}
    # the two journals hold the same rows but for the clock
    rows = [[{k: v for k, v in r.items() if k not in ("t_epoch_s",
                                                      "outcome")}
             for r in QueryJournal(str(d)).rows()] for d in (td, jd)]
    assert rows[0] == rows[1]
