"""The port stands alone: it imports neither JAX nor the JAX package (every
module of it, the distributed ones, the native host library, the chunk
streams and the critical path included, and ``chip_smoke.py``), and an
entry point given no device runs on the card or raises — it never falls
back to the CPU, or to gloo, on its own; only the opt-in
``engine_with_cpu_fallback`` (``--cpu-fallback``) builds on the host."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tpu_radix_join_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import tpu_radix_join_torch as tx
walked = []
for m in pkgutil.walk_packages(tx.__path__, "tpu_radix_join_torch."):
    importlib.import_module(m.name)
    walked.append(m.name)
res = tx.HashJoin(tx.JoinConfig(), device="cpu").join(
    tx.Relation(3000, 1, "unique", seed=1),
    tx.Relation(3000, 1, "zipf", seed=2, zipf_theta=0.75))
bucket = tx.HashJoin(tx.JoinConfig(probe_algorithm="bucket"), device="cpu").join(
    tx.Relation(3000, 1, "unique", seed=1),
    tx.Relation(3000, 1, "modulo", seed=2, modulo=700))
from tpu_radix_join_torch.data.streaming import stream_chunks_device
from tpu_radix_join_torch.ops.chunked import chunked_join_grid
from tpu_radix_join_torch.parallel import multihost
grid = chunked_join_grid(
    stream_chunks_device(tx.Relation(3000, 1, "unique", seed=1), 0, 1000,
                         "cpu"),
    lambda: stream_chunks_device(tx.Relation(3000, 1, "modulo", seed=2,
                                             modulo=700), 0, 1000, "cpu"),
    512, pipeline="on")
degraded = tx.HashJoin(tx.JoinConfig(two_level=True, fallback="chunked"),
                       device="cpu").join(
    tx.Relation(3000, 1, "unique", seed=1),
    tx.Relation(3000, 1, "zipf", seed=2, zipf_theta=0.75))
from tpu_radix_join_torch.parallel.distribute import distribute
from tpu_radix_join_torch.parallel.world import OneRankWorld
from tpu_radix_join_torch.performance import Measurements
meas = Measurements()
chunked = tx.HashJoin(tx.JoinConfig(chunk_size=1000), device="cpu",
                      measurements=meas).join(
    tx.Relation(3000, 1, "unique", seed=1),
    tx.Relation(3000, 1, "zipf", seed=2, zipf_theta=0.75))
rel = tx.Relation(3000, 1, "unique", seed=1).generate("cpu")
shuffled = distribute(rel, OneRankWorld(), seed=3)
from tpu_radix_join_torch.data.streaming import stream_chunks
host_grid = chunked_join_grid(
    stream_chunks(tx.Relation(3000, 1, "unique", seed=1), 0, 1000,
                  device="cpu"),
    lambda: stream_chunks(tx.Relation(3000, 1, "modulo", seed=2,
                                      modulo=700), 0, 1000, device="cpu"),
    512)
import warnings
from tpu_radix_join_torch.robustness.degrade import engine_with_cpu_fallback
with warnings.catch_warnings():
    warnings.simplefilter("ignore", RuntimeWarning)
    fb_engine, fb_info = engine_with_cpu_fallback(tx.JoinConfig())
fallback = [fb_info["degraded"], fb_engine.device.type,
            fb_engine.join(tx.Relation(3000, 1, "unique", seed=1),
                           tx.Relation(3000, 1, "unique", seed=2)).matches]
from tpu_radix_join_torch.observability.critpath import (
    critical_path_from_tracer)
traced = Measurements()
traced.attach_tracer(nodes=1)
tx.HashJoin(tx.JoinConfig(), device="cpu", measurements=traced).join(
    tx.Relation(3000, 1, "unique", seed=1),
    tx.Relation(3000, 1, "unique", seed=2))
critpath = critical_path_from_tracer(traced.tracer)["top_phase"]["name"]
from tpu_radix_join_torch.robustness import recovery
rk, _ = recovery.host_keys(tx.Relation(3000, 1, "unique", seed=1))
sk, _ = recovery.host_keys(tx.Relation(3000, 1, "unique", seed=2))
rplan = recovery.plan_recovery(num_nodes=2, num_partitions=32,
                               lost_ranks=[1], epoch=1)
recovered = recovery.execute_recovery(rplan, rk, sk, device="cpu")[0]
from tpu_radix_join_torch.core.config import ServiceConfig
from tpu_radix_join_torch.service import JoinSession, QueryRequest
session = JoinSession(tx.JoinConfig(),
                      ServiceConfig(result_cache_max=2, batch_window_ms=1.0,
                                    resident_budget_bytes=1 << 20),
                      device="cpu")
for q in (QueryRequest("s0", tuples_per_node=512),
          QueryRequest("s1", tuples_per_node=512, delta_tuples_per_node=8),
          QueryRequest("s2", tuples_per_node=512, delta_tuples_per_node=8),
          QueryRequest("s3", tuples_per_node=256, seed=1),
          QueryRequest("s4", tuples_per_node=256, seed=2)):
    session.submit(q)
served = [(o.served_by, o.matches == o.expected) for o in session.drain()]
session.close()
raised = {}
for name, call in [
        ("HashJoin", lambda: tx.HashJoin()),
        ("Relation.generate", lambda: tx.Relation(64).generate()),
        ("batch_from_numpy", lambda: tx.batch_from_numpy([1], [2])),
        ("main", lambda: tx.main.main(["--tuples-per-node", "64"])),
        ("main --probe bucket", lambda: tx.main.main(
            ["--probe", "bucket", "--tuples-per-node", "64"])),
        ("HashJoin fallback", lambda: tx.HashJoin(
            tx.JoinConfig(fallback="chunked"))),
        ("HashJoin num_nodes=2", lambda: tx.HashJoin(
            tx.JoinConfig(num_nodes=2))),
        ("HashJoin chunk_size", lambda: tx.HashJoin(
            tx.JoinConfig(chunk_size=1000), measurements=Measurements())),
        ("main --chunk-size --measure-phases", lambda: tx.main.main(
            ["--chunk-size", "16", "--measure-phases",
             "--tuples-per-node", "64"])),
        ("multihost.initialize", lambda: multihost.initialize(
            init_method="tcp://127.0.0.1:1", world_size=2, rank=0)),
        ("stream_chunks_device", lambda: next(stream_chunks_device(
            tx.Relation(64), 0, 16))),
        ("stream_chunks", lambda: next(stream_chunks(
            tx.Relation(64), 0, 16))),
        ("main --grid-chunk-tuples", lambda: tx.main.main(
            ["--grid-chunk-tuples", "16", "--tuples-per-node", "64"])),
        ("JoinSession", lambda: JoinSession(tx.JoinConfig())),
        ("main --serve", lambda: tx.main.main(["--serve", "absent.jsonl"])),
        ("execute_recovery", lambda: recovery.execute_recovery(
            rplan, rk, sk))]:
    try:
        call()
        raised[name] = None
    except RuntimeError as e:
        raised[name] = str(e)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "tpu_radix_join"))
print(json.dumps({"matches": res.matches, "ok": res.ok, "leaked": leaked,
                  "raised": raised, "grid": grid,
                  "host_grid": host_grid, "fallback": fallback,
                  "critpath": critpath, "walked": walked,
                  "recovered": recovered,
                  "degraded": [degraded.matches, degraded.ok,
                               degraded.diagnostics["degraded"]],
                  "bucket": [bucket.matches, bucket.ok,
                             len(bucket.partition_counts)],
                  "chunked": [chunked.matches, chunked.ok,
                              sorted(meas.times_us)],
                  "shuffled": [sorted(shuffled.key.tolist())
                               == sorted(rel.key.tolist()),
                               shuffled.key.tolist() != rel.key.tolist()],
                  "served": served}))
"""


def _run(args):
    """Run Python with ``args`` in the repo root, with no card visible."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_never_falls_back_to_the_cpu():
    got = _run(["-c", _PROBE])
    assert got["leaked"] == []
    assert got["ok"] and got["matches"] == 3000
    assert got["bucket"] == [3000, True, 32]
    assert got["grid"] == got["host_grid"] == 3000
    # the opt-in fallback, and only it, takes the host when no card is there
    assert got["fallback"] == [True, "cpu", 3000]
    assert got["critpath"] == "JPROC"
    # the recovery's recompute: the masked grids on the host when asked,
    # and on its default device, the card, a raise without one
    assert got["recovered"] == 3000
    for name in ("native.build", "memory.pool", "observability.critpath",
                 "data.streaming", "robustness.degrade",
                 "robustness.recovery", "robustness.straggler"):
        assert f"tpu_radix_join_torch.{name}" in got["walked"]
    assert got["degraded"] == [3000, True, "chunked"]
    assert got["chunked"] == [3000, True, ["JHIST", "JPROC", "JTOTAL",
                                           "SWINALLOC"]]
    assert got["shuffled"] == [True, True]
    assert got["served"] == [["execute", True], ["execute", True],
                             ["delta_merge", True], ["batched", True],
                             ["batched", True]]
    for name, msg in got["raised"].items():
        assert msg is not None and "no CUDA device" in msg, name


def test_main_cli_runs_on_the_cpu_when_asked():
    got = _run(["-m", "tpu_radix_join_torch.main", "--device", "cpu",
                "--tuples-per-node", "4096", "--outer-kind", "modulo"])
    assert got["matches"] == got["expected"] == 4096 and got["ok"]
    assert got["device"] == "cpu"


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "tpu_radix_join"), (
                    f"{path.relative_to(ROOT)} imports {name}")
