"""One rank of the port's gloo world for the multi-process tests.

    python tests/torch_dist_worker.py RANK WORLD_SIZE INIT_METHOD

Joins the process group through ``parallel/multihost.initialize`` with
``device="cpu"`` (gloo), then reads one JSON task a line from standard input
and writes one JSON result a line to standard output, until ``{"kind":
"exit"}`` or the end of its input.  Every rank of the world receives the
same task; a task that raises answers ``{"error": ...}``.  Imports torch and
the port only.  :class:`WorkerPool` starts such a world and talks to it
under a deadline.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    """A tensor (int32 lanes as uint32) or an int64 tensor as a list."""
    import torch
    from tpu_radix_join_torch.data.tuples import lane_to_numpy
    if x.dtype == torch.int32:
        return lane_to_numpy(x).tolist()
    return x.cpu().tolist()


def _lane(values):
    """A list of uint32 values as a CPU lane."""
    import numpy as np
    from tpu_radix_join_torch.data.tuples import lane_from_numpy
    return lane_from_numpy(np.asarray(values, np.uint32), "cpu")


def _shard(lanes, rank, size):
    """This rank's contiguous shard of global uint32 lanes [key, rid,
    key_hi or None], as a CPU TupleBatch (the JAX mesh's sharding)."""
    from tpu_radix_join_torch.data.tuples import TupleBatch
    n = len(lanes[0]) // size
    return TupleBatch(*(None if lane is None
                        else _lane(lane[rank * n:(rank + 1) * n])
                        for lane in lanes))


def _join(task, world_group):
    """One join of the task's relations (``"inner"``/``"outer"`` specs, or
    ``"lanes"``: global lanes each rank shards); with ``"measure"`` the
    engine records into a registry, whose counters, timers, ``retry``
    events and ``gather_all`` (every rank's registry: node, RESULTS, timer
    tags) come back too; with ``"plan"`` the sizing pass's capacities and
    skew plan, measured before the join; with ``"materialize"`` the join is
    ``join_materialize_arrays`` and its rid pairs come back; with
    ``"fault"`` the site ``exchange.corrupt_lane`` is armed once on every
    rank (the registry's ``exchange_plan``, ``data_corruption`` and
    ``repair`` events come back with ``"measure"``)."""
    import torch
    import tpu_radix_join_torch as tx
    from tpu_radix_join_torch.performance import Measurements
    cfg = tx.JoinConfig(**task["config"])
    meas = (Measurements(node_id=torch.distributed.get_rank(),
                         num_nodes=cfg.num_nodes)
            if task.get("measure") else None)
    eng = tx.HashJoin(cfg, device="cpu", group=world_group,
                      measurements=meas)
    out, bound = {}, None
    if "lanes" in task:
        rank, size = eng.world.rank, eng.world.size
        r, s = (_shard(task["lanes"][k], rank, size) for k in ("r", "s"))
    else:
        inner, outer = (tx.Relation(**task[k]) for k in ("inner", "outer"))
        r, s = eng.place(inner), eng.place(outer)
        if task.get("flip"):
            # this rank's shards with bit 31 of every key set, as raw lanes
            r, s = (b._replace(key=torch.bitwise_xor(b.key, -(1 << 31)))
                    for b in (r, s))
        else:   # HashJoin.join: the relations' static key bound
            bound = max(inner.key_bound(), outer.key_bound())
    if task.get("plan"):
        cap_r, cap_s, skew = eng._measure_capacities(
            r, s, eng._shuffle_plan(r, s))
        out["plan"] = [cap_r, cap_s] + (
            [None, None] if skew is None else [skew.hot_bits, skew.hot_cap])
    from tpu_radix_join_torch.robustness import faults
    injector = faults.FaultInjector()
    if task.get("fault"):
        injector.arm(faults.EXCHANGE_CORRUPT, at=1)
    # an active injector stamps fault_sites into the diagnostics
    with injector if task.get("fault") else contextlib.nullcontext():
        if task.get("materialize"):
            res = eng.join_materialize_arrays(r, s)
            out.update({"r_rid": res.r_rid.tolist(),
                        "s_rid": res.s_rid.tolist()})
        else:
            res = eng.join_arrays(r, s, key_bound=bound)
            out["partition_counts"] = res.partition_counts.tolist()
    out.update({"matches": res.matches, "ok": res.ok,
                "diagnostics": res.diagnostics, "retries": res.retries,
                "collectives": dict(eng.world.counts)})
    if meas is not None:
        out["counters"] = dict(meas.counters)
        out["times_us"] = dict(meas.times_us)
        out["retry_events"] = [
            {k: v for k, v in e.items() if k not in ("t_s", "t_epoch_s")}
            for e in meas.meta.get("events", []) if e["event"] == "retry"]
        out["verify_events"] = [
            {k: v for k, v in e.items() if k not in ("t_s", "t_epoch_s")}
            for e in meas.meta.get("events", [])
            if e["event"] in ("data_corruption", "repair")]
        out["exchange_plan"] = meas.meta.get("exchange_plan")
        out["gathered"] = [[m.node_id, m.counters.get("RESULTS"),
                            sorted(m.times_us)]
                           for m in meas.gather_all(eng.world)]
    return out


def _distribute(task, world):
    """``parallel/distribute.distribute`` of this rank's lanes, in the
    task's ``"mode"`` (fused by default)."""
    from tpu_radix_join_torch.data.tuples import TupleBatch
    from tpu_radix_join_torch.parallel.distribute import distribute
    lanes = task["lanes"][world.rank]
    batch = TupleBatch(*(None if lane is None else _lane(lane)
                         for lane in lanes))
    got = distribute(batch, world, seed=task["seed"],
                     mode=task.get("mode", "fused"))
    return {"lanes": [None if lane is None else _np(lane) for lane in got]}


def _offsets(task, world):
    from tpu_radix_join_torch.histograms import compute_offsets
    offs = compute_offsets(_lane(task["local_hists"][world.rank]),
                           _lane(task["global_hist"]),
                           _lane(task["assignment"]), world)
    return {k: _np(v) for k, v in offs._asdict().items()}


def _collectives(task, world):
    import torch
    rank, n = world.rank, world.size
    x = torch.tensor([rank + 1, 10 * rank, -rank], dtype=torch.int64)
    blocks = torch.arange(n * 3, dtype=torch.int32) + 100 * rank
    return {"sum": _np(world.all_reduce(x)),
            "max": _np(world.all_reduce(x, op="max")),
            "gather": _np(world.all_gather(x)),
            "to_all": _np(world.all_to_all(blocks, 3)),
            "input_kept": _np(x)}


def _exchange(task, world):
    """``network_partition`` of this rank's lanes, with the skew split's
    ``exclude`` or ``override`` (``"exclude"``: bool lists, ``"override"``:
    [mask lists, destination lists], one a rank) when the task has them,
    through a window of the task's ``"window"`` keywords (codec, mode,
    bounds), and with ``"checksums"`` the ``receive_checksums`` of what
    arrived."""
    import torch
    from tpu_radix_join_torch.parallel.network_partitioning import (
        network_partition)
    from tpu_radix_join_torch.parallel.window import Window
    from tpu_radix_join_torch.data.tuples import TupleBatch
    from tpu_radix_join_torch.parallel.network_partitioning import (
        receive_checksums)
    rank = world.rank
    hi = task.get("key_hi")
    batch = TupleBatch(key=_lane(task["key"][rank]),
                       rid=_lane(task["rid"][rank]),
                       key_hi=None if hi is None else _lane(hi[rank]))
    assignment = _lane(task["assignment"])
    win = Window(world, task["capacity"], task["side"],
                 **task.get("window", {}))
    kw = {}
    if task.get("exclude"):
        kw["exclude"] = torch.tensor(task["exclude"][rank])
    if task.get("override"):
        mask, dest = task["override"]
        kw["override"] = (torch.tensor(mask[rank]), _lane(dest[rank]))
    res = network_partition(batch, task["fanout"], assignment, win, **kw)
    ghist = _lane(task["global_hist"])
    lost, bad = win.diagnostics(res, ghist, assignment)
    extra = {"counts": dict(world.counts)}
    if hi is not None:
        extra["key_hi"] = _np(res.batch.key_hi)
    if task.get("checksums"):
        extra["checksums"] = _np(receive_checksums(res, 1 << task["fanout"],
                                                   world).reshape(-1))
    return {**extra, "key": _np(res.batch.key), "rid": _np(res.batch.rid),
            "valid": res.valid.tolist(), "pid": _np(res.pid),
            "recv_counts": _np(res.recv_counts),
            "send_overflow": int(res.send_overflow), "lost": int(lost),
            "bad": bool(bad),
            "all_written": bool(win.assert_all_tuples_written(
                res, ghist, assignment))}


def _hierarchical(task, group):
    """One block exchange of this rank's int32 blocks (``"blocks"``: one
    list a rank) through the hierarchical route of ``num_hosts`` hosts and
    through the flat route; with ``"modes"`` also ``block_all_to_all`` in
    each mode over both routes."""
    from tpu_radix_join_torch.parallel.window import block_all_to_all
    from tpu_radix_join_torch.parallel.world import (
        hierarchical_block_all_to_all, make_world)
    hier = make_world(task["num_nodes"], group, task["num_hosts"])
    flat = make_world(task["num_nodes"], group)
    n = hier.size
    x = _lane(task["blocks"][hier.rank])
    block = x.numel() // n
    out = {"hier": _np(hier.all_to_all(x, block)),
           "flat": _np(flat.all_to_all(x, block)),
           "direct": _np(hierarchical_block_all_to_all(
               x, n, block, *hier._hier, hier.num_hosts)),
           "counts": dict(hier.counts)}
    for mode in task.get("modes", []):
        before = flat.counts["all_to_all"]
        out[f"flat {mode}"] = _np(block_all_to_all(flat, x, block, mode))
        out[f"hier {mode}"] = _np(block_all_to_all(hier, x, block, mode))
        out[f"collectives {mode}"] = flat.counts["all_to_all"] - before
    return out


def _checksums(task, world):
    """``global_partition_checksums`` of this rank's lanes."""
    import torch
    from tpu_radix_join_torch.robustness.verify import (
        global_partition_checksums)
    rank = world.rank
    hi = task.get("key_hi")
    valid = task.get("valid")
    got = global_partition_checksums(
        _lane(task["key"][rank]), _lane(task["pid"][rank]),
        task["num_partitions"], world,
        valid=None if valid is None else torch.tensor(valid[rank]),
        key_hi=None if hi is None else _lane(hi[rank]))
    return {"checksums": _np(got.reshape(-1))}


#: the outcome fields a ``serve`` task returns (latency varies)
SERVE_FIELDS = ("query_id", "tenant", "status", "failure_class", "matches",
                "expected", "warm", "served_by", "engine", "degraded",
                "breaker_state", "detail")


def _serve(task, world_group):
    """The task's ``"requests"`` (QueryRequest fields) through one
    ``JoinSession`` of ``"config"`` and ``"service"`` over the world, each
    request submitted and served in turn (``"drain"``: all submitted, then
    drained).  ``"tick_clock"`` gives every rank's session a clock that
    advances one second a read (the session reads rank 0's); ``"faults"``
    (``[[site, [hits]], ...]``) arms those sites on every rank;
    ``"lease_dir"`` gives the session a membership view over the world's
    ranks (``elastic=True``); ``"watchdog_kill_rank0"`` attaches a watchdog
    on every rank and hands rank 0's a hang verdict.  Returns every
    outcome's fields, the registry's counters, the session's summary and
    its heartbeat's membership block."""
    import torch
    import tpu_radix_join_torch as tx
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults
    from tpu_radix_join_torch.service import JoinSession, QueryRequest

    class TickClock:
        t = 0.0

        def __call__(self):
            self.t += 1.0
            return self.t - 1.0

    cfg = tx.JoinConfig(**task["config"])
    rank = torch.distributed.get_rank()
    meas = Measurements(node_id=rank, num_nodes=cfg.num_nodes)
    kw = {"clock": TickClock()} if task.get("tick_clock") else {}
    if task.get("lease_dir"):
        from tpu_radix_join_torch.robustness.membership import (
            LeaseBoard, MembershipView)
        board = LeaseBoard(task["lease_dir"], rank=rank,
                           num_ranks=cfg.num_nodes, lease_s=30.0)
        board.heartbeat(0)
        kw.update(membership=MembershipView(board), elastic=True)
    sess = JoinSession(cfg, ServiceConfig(**task.get("service", {})),
                       measurements=meas, device="cpu", group=world_group,
                       **kw)
    if task.get("watchdog_kill_rank0"):
        # every rank's watchdog, and a hang verdict on rank 0's alone
        from tpu_radix_join_torch.observability.watchdog import HangDetected
        sess.attach_watchdog(3600.0)
        if rank == 0:
            sess.kill(HangDetected(1.0, ["JTOTAL"], None))
    injector = faults.FaultInjector(seed=5)
    for site, hits in task.get("faults", []):
        injector.arm(site, at=tuple(hits))
    try:
        outs = []
        with injector:
            for req in task["requests"]:
                sess.submit(QueryRequest(**req))
                if not task.get("drain"):
                    outs.append(sess.run_next())
            outs += sess.drain()
        return {"outcomes": [{k: getattr(o, k) for k in SERVE_FIELDS}
                             for o in outs],
                "counters": dict(meas.counters),
                "summary": sess.summary(),
                "membership": sess.heartbeat_tick().get("membership")}
    finally:
        sess.close()


def _elastic(task, world_group):
    """One elastic ``join_arrays`` of the task's global ``"lanes"`` (each
    rank joins its shard; ``elastic_inputs`` hands recovery the whole
    lanes): ``"engine"`` sets engine attributes (``elastic``, ``hedge``,
    ``elastic_grow``, ``straggle_factor``, ``straggle_unit_s``);
    ``"membership"`` gives each rank a one-lease board of its own (lease
    300 s, a fresh directory); ``"manifest"`` (``{partition: count}``
    lines owned by ``p % 4``, possibly empty) a fresh manifest of its own;
    ``"faults"`` (``[[site, at], ...]``) are armed on one injector of
    ``"seed"``.  Returns the result (or the raised exception's class and
    failure class), the counters and the manifest's audit."""
    import numpy as np
    import torch
    import tpu_radix_join_torch as tx
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults
    from tpu_radix_join_torch.robustness.checkpoint import PartitionManifest
    from tpu_radix_join_torch.robustness.membership import (LeaseBoard,
                                                            MembershipView)
    cfg = tx.JoinConfig(**task["config"])
    meas = Measurements(node_id=torch.distributed.get_rank(),
                        num_nodes=cfg.num_nodes)
    eng = tx.HashJoin(cfg, device="cpu", group=world_group,
                      measurements=meas)
    for k, v in task.get("engine", {}).items():
        setattr(eng, k, v)
    glanes = {k: [np.asarray(x, np.uint32) for x in task["lanes"][k]]
              for k in ("r", "s")}
    eng.elastic_inputs = lambda: (glanes["r"][0], None, glanes["s"][0], None)
    rank, size = eng.world.rank, eng.world.size
    r, s = (_shard(task["lanes"][k] + [None], rank, size)
            for k in ("r", "s"))
    with tempfile.TemporaryDirectory() as tmp:
        if task.get("membership"):
            board = LeaseBoard(os.path.join(tmp, "leases"), rank=0,
                               num_ranks=1, lease_s=300.0, measurements=meas)
            board.heartbeat(0)
            eng.membership = MembershipView(board, measurements=meas)
        man = None
        if task.get("manifest") is not None:
            man = PartitionManifest(os.path.join(tmp, "m"),
                                    fingerprint={"t": 1}, measurements=meas)
            man.mark_many({int(p): int(c)
                           for p, c in task["manifest"].items()},
                          owner_of=lambda p: p % 4)
            eng.partition_manifest = man
        injector = faults.FaultInjector(seed=task.get("seed", 0),
                                        measurements=meas)
        for site, at in task.get("faults", []):
            injector.arm(site, at=at)
        out = {}
        try:
            with injector:
                res = eng.join_arrays(r, s)
            out.update({"matches": res.matches, "ok": res.ok,
                        "partition_counts": res.partition_counts.tolist(),
                        "diagnostics": res.diagnostics})
        except Exception as e:      # the class is the test's verdict
            out.update({"raised": type(e).__name__,
                        "failure_class": getattr(e, "failure_class", None)})
        out["counters"] = dict(meas.counters)
        if man is not None:
            aud = man.audit()
            out["audit_total"] = aud["total"]
    return out


def _soak(task, world_group):
    """``robustness/chaos``'s ``"which"`` soak (``"join"`` or
    ``"recovery"``) of ``"runs"`` schedules from ``"base_seed"`` over the
    world, its runner built with ``"runner"``'s keywords on the CPU:
    every outcome and the summary."""
    from tpu_radix_join_torch.robustness import chaos
    kw = dict(task.get("runner", {}), device="cpu", group=world_group)
    if task["which"] == "recovery":
        runner = chaos.RecoveryChaosRunner(**kw)
        try:
            outs, summary = chaos.soak_recovery(
                task["runs"], base_seed=task["base_seed"], runner=runner)
        finally:
            runner.close()
    else:
        runner = chaos.ChaosRunner(**kw)
        outs, summary = chaos.soak(task["runs"], base_seed=task["base_seed"],
                                   runner=runner)
    return {"outcomes": [o.to_json() for o in outs], "summary": summary}


def worker(rank: int, world_size: int, init_method: str) -> None:
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist
    from tpu_radix_join_torch.parallel import multihost
    from tpu_radix_join_torch.parallel.world import DistWorld
    multihost.initialize(init_method=init_method, world_size=world_size,
                         rank=rank, device="cpu", timeout_s=120)
    group = dist.group.WORLD
    kinds = {"join": lambda t: _join(t, group),
             "offsets": lambda t: _offsets(t, DistWorld(group)),
             "collectives": lambda t: _collectives(t, DistWorld(group)),
             "exchange": lambda t: _exchange(t, DistWorld(group)),
             "distribute": lambda t: _distribute(t, DistWorld(group)),
             "checksums": lambda t: _checksums(t, DistWorld(group)),
             "hierarchical": lambda t: _hierarchical(t, group),
             "serve": lambda t: _serve(t, group),
             "elastic": lambda t: _elastic(t, group),
             "soak": lambda t: _soak(t, group)}
    for line in sys.stdin:
        task = json.loads(line)
        if task["kind"] == "exit":
            break
        try:
            out = kinds[task["kind"]](task)
        except Exception as e:   # reported to the test, which fails on it
            out = {"error": repr(e), "traceback": traceback.format_exc()}
        print(json.dumps(out), flush=True)
    multihost.shutdown()


class WorkerPool:
    """``size`` worker processes forming one gloo world, rendezvous through
    a file under ``tmp_dir``.  :meth:`run` sends a task to every rank and
    returns their results in rank order, or kills the world and raises
    ``AssertionError`` when ``deadline_s`` passes; the next :meth:`run`
    then starts a new world."""

    def __init__(self, size: int, tmp_dir, deadline_s: float = 180.0):
        self.size = size
        self.tmp_dir = Path(tmp_dir)
        self.deadline_s = deadline_s
        self.procs = []
        self.generation = 0

    def _start(self) -> None:
        self.generation += 1
        rendezvous = self.tmp_dir / f"rendezvous_{self.generation}"
        env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        self.queues = []
        self.logs = []
        for rank in range(self.size):
            log = tempfile.TemporaryFile(mode="w+", dir=self.tmp_dir)
            proc = subprocess.Popen(
                [sys.executable, __file__, str(rank), str(self.size),
                 f"file://{rendezvous}"], cwd=ROOT, env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
                text=True)
            q = queue.Queue()
            threading.Thread(target=self._pump, args=(proc.stdout, q),
                             daemon=True).start()
            self.procs.append(proc)
            self.queues.append(q)
            self.logs.append(log)

    @staticmethod
    def _pump(stream, q) -> None:
        for line in stream:
            q.put(line)
        q.put(None)

    def _stderr(self, rank: int) -> str:
        log = self.logs[rank]
        log.seek(0)
        return log.read()[-3000:]

    def run(self, task: dict) -> list:
        if not self.procs:
            self._start()
        line = json.dumps(task) + "\n"
        for proc in self.procs:
            proc.stdin.write(line)
            proc.stdin.flush()
        end = time.monotonic() + self.deadline_s
        out = []
        for rank, q in enumerate(self.queues):
            try:
                got = q.get(timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                got = "deadline"
            if got is None or got == "deadline":
                why = ("passed its deadline" if got == "deadline"
                       else "exited")
                err = self._stderr(rank)
                self.close()
                raise AssertionError(f"rank {rank} {why} on {task['kind']}:"
                                     f"\n{err}")
            out.append(json.loads(got))
        for rank, res in enumerate(out):
            if "error" in res:
                raise AssertionError(f"rank {rank}: {res['traceback']}")
        return out

    def close(self) -> None:
        """Ask every rank to exit; kill any still running after 20 s."""
        for proc in self.procs:
            try:
                proc.stdin.write(json.dumps({"kind": "exit"}) + "\n")
                proc.stdin.close()
            except (BrokenPipeError, ValueError, OSError):
                pass
        end = time.monotonic() + 20
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.1, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for log in self.logs if self.procs else []:
            log.close()
        self.procs = []


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
