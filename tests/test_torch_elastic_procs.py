"""Elastic recovery with real processes: the port's command line as plain
processes of one gloo world (``env://`` rendezvous, no torchrun agent,
which would tear the survivor down with the victim), on the CPU.

  * a SIGKILLed victim (``TPU_RJ_RANK_DEATH_SUICIDE=1 --rank-death-at
    2``): the survivor finds the lapsed lease behind gloo's reset
    connection, recovers host-side and exits 0 with the exact count, a
    ``[RESULTS] recovered:`` line, RANKLOST 1 and MEPOCH 1;
  * a SIGSTOPped victim (``TPU_RJ_RANK_DEATH_SUICIDE=stop``): its sockets
    stay open, so the survivor waits out the elastic group's timeout (the
    ``TPU_RJ_COORD_TIMEOUT_S``, here the lapse window plus 4 s) and no
    longer;
  * a 2 -> 3 growth: a newcomer (``--elastic-join 2``) writes its joining
    lease first, two ``--elastic-grow`` incumbents admit it with one epoch
    bump, and all three exit 0 and exact through the shared manifest;
  * ``--serve`` over two ranks with ``--elastic on`` and a watchdog.

At most three processes a case, each with ``OMP_NUM_THREADS=1``, every
one reaped in a ``finally``."""

import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEASE_S = 0.5
MISSED = 2
GROUP_TIMEOUT_S = LEASE_S * MISSED + 4.0


def _port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _spawn(argv, rank=None, port=None, extra_env=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "TPU_RJ_RANK_DEATH_SUICIDE")}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               TPU_RJ_COORD_TIMEOUT_S=str(GROUP_TIMEOUT_S),
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    if rank is not None:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE="2")
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_radix_join_torch.main"] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        cwd=ROOT)


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        try:
            p.communicate(timeout=20)
        except (subprocess.TimeoutExpired, ValueError):
            pass


def _base(tmp_path, *extra):
    return ["--device", "cpu", "--nodes", "2", "--tuples-per-node", "2048",
            "--network-fanout", "3", "--elastic", "on",
            "--rank-lease-s", str(LEASE_S),
            "--rank-missed-beats", str(MISSED),
            "--lease-dir", str(tmp_path / "leases"), *extra]


def _death_time(out: str) -> float:
    m = re.search(r"\[ELASTIC\] rank_death .*t_epoch_s=([0-9.]+)", out)
    assert m, out
    return float(m.group(1))


def test_sigkilled_rank_survivor_recovers_exact(tmp_path):
    port = _port()
    base = _base(tmp_path)
    procs = [_spawn(base, 0, port),
             _spawn(base + ["--rank-death-at", "2"], 1, port,
                    {"TPU_RJ_RANK_DEATH_SUICIDE": "1"})]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        _reap(procs)
    joined = "\n---- rank boundary ----\n".join(outs)
    assert procs[1].returncode == -signal.SIGKILL, joined
    assert procs[0].returncode == 0, joined
    assert "[RESULTS] recovered: epoch=1 lost_ranks=[1]" in outs[0], joined
    assert "[RESULTS] Expected: 4096 (OK)" in outs[0], joined
    assert "RANKLOST\t1" in outs[0] and "MEPOCH\t1" in outs[0], joined
    assert "RECOVERN\t8" in outs[0], joined
    assert "\"detected_t\"" in outs[0], joined


def test_elastic_group_timeout_yields_to_the_coordinator_timeout(
        monkeypatch):
    """An elastic group's timeout is the lapse window plus the margin
    unless ``timeout_s`` or ``TPU_RJ_COORD_TIMEOUT_S`` sets it; a plain
    group keeps the 300 s default.  Nothing is connected."""
    import torch
    from tpu_radix_join_torch.parallel import multihost
    seen = []
    monkeypatch.setattr(multihost, "resolve_device", torch.device)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(
        multihost.dist, "init_process_group",
        lambda backend, **kw: seen.append(kw["timeout"].total_seconds()))
    monkeypatch.delenv("TPU_RJ_COORD_TIMEOUT_S", raising=False)
    kw = dict(init_method="file:///nonexistent", world_size=2, rank=0,
              device="cpu")
    multihost.initialize(**kw)
    multihost.initialize(elastic_lapse_s=1.0, **kw)
    multihost.initialize(elastic_lapse_s=1.0, timeout_s=7.0, **kw)
    monkeypatch.setenv("TPU_RJ_COORD_TIMEOUT_S", "5")
    multihost.initialize(elastic_lapse_s=1.0, **kw)
    multihost.initialize(**kw)
    assert seen == [multihost.DEFAULT_TIMEOUT_S,
                    1.0 + multihost.ELASTIC_MARGIN_S, 7.0, 5.0, 5.0]
    assert multihost.elastic_timeout_s(1.0) == 31.0


def test_sigstopped_rank_survivor_ends_within_the_group_timeout(tmp_path):
    port = _port()
    base = _base(tmp_path)
    procs = [_spawn(base, 0, port),
             _spawn(base + ["--rank-death-at", "2"], 1, port,
                    {"TPU_RJ_RANK_DEATH_SUICIDE": "stop"})]
    try:
        out0 = procs[0].communicate(timeout=120)[0]
        ended = time.time()
        procs[1].kill()               # the frozen victim never ends alone
        out1 = procs[1].communicate(timeout=20)[0]
    finally:
        _reap(procs)
    joined = out0 + "\n---- rank boundary ----\n" + out1
    assert procs[0].returncode == 0, joined
    assert "[RESULTS] recovered: epoch=1 lost_ranks=[1]" in out0, joined
    assert "[RESULTS] Expected: 4096 (OK)" in out0, joined
    waited = ended - _death_time(out1)
    # the collective in flight times out, the lease confirms the loss
    # within one more lapse window, and the recompute is host-side
    assert (GROUP_TIMEOUT_S * 0.5 < waited
            < GROUP_TIMEOUT_S + LEASE_S * MISSED + 15), \
        (waited, joined)


def test_two_to_three_growth(tmp_path):
    port = _port()
    base = _base(tmp_path, "--checkpoint-dir", str(tmp_path / "ck"))
    joiner = _spawn(base + ["--elastic-join", "2"])
    procs = [joiner]
    try:
        lease = tmp_path / "leases" / "lease_r2.json"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not lease.exists():
            assert joiner.poll() is None, joiner.communicate()[0]
            time.sleep(0.1)
        assert lease.exists(), "the joining lease never appeared"
        procs += [_spawn(base + ["--elastic-grow"], r, port)
                  for r in range(2)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        _reap(procs)
    joined = "\n---- rank boundary ----\n".join(outs)
    assert [p.returncode for p in procs] == [0, 0, 0], joined
    # rank 0 reports (after a regrowth, from its own registry)
    assert "[RESULTS] Expected: 4096 (OK)" in outs[1], joined
    assert "RANKJOIN\t1" in outs[1] and "MEPOCH\t1" in outs[1], joined
    assert "[RESULTS] regrown: joined_ranks=[2]" in outs[1], joined
    assert "\"kind\": \"regrow\"" in outs[2], joined
    assert "[RESULTS] joiner: rank=2 epoch=1" in outs[0], joined
    assert "manifest_partitions=8/8" in outs[0], joined
    assert "[RESULTS] Expected: 4096 (OK)" in outs[0], joined


def test_serve_over_two_ranks_with_a_watchdog(tmp_path):
    """``--serve FILE --nodes 2 --elastic on --watchdog-timeout`` runs (a
    kill would be rank 0's, broadcast): both ranks serve the requests
    exact and exit 0, rank 0 printing the outcomes."""
    import json
    port = _port()
    req = tmp_path / "q.jsonl"
    req.write_text("".join(
        json.dumps({"query_id": f"w{i}", "tuples_per_node": 1024,
                    "seed": 5 + i}) + "\n" for i in range(2)))
    base = _base(tmp_path, "--serve", str(req), "--watchdog-timeout", "60")
    procs = [_spawn(base, r, port) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        _reap(procs)
    joined = "\n---- rank boundary ----\n".join(outs)
    assert [p.returncode for p in procs] == [0, 0], joined
    got = [json.loads(x) for x in outs[0].splitlines()
           if x.startswith('{"event": "outcome"')]
    assert [(o["query_id"], o["status"], o["matches"]) for o in got] == \
        [("w0", "ok", 2048), ("w1", "ok", 2048)], joined
