"""The distributed port's set-up, without a world of workers: multi-rank
relation shards against the JAX package's ``shard_np``, the opt-in
process-group bootstrap (``parallel/multihost``) and its
``coordinator_timeout`` failure class, the engine's group checks, and a
torchrun launch of the command line over two gloo ranks."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data import relation as jrel  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.data import relation as trel  # noqa: E402
from tpu_radix_join_torch.data.tuples import lane_to_numpy  # noqa: E402
from tpu_radix_join_torch.parallel import multihost  # noqa: E402
from tpu_radix_join_torch.robustness import faults  # noqa: E402
from tpu_radix_join_torch.robustness.retry import (  # noqa: E402
    COORDINATOR_TIMEOUT, RetryPolicy)
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@pytest.mark.parametrize("nodes", [2, 4])
@pytest.mark.parametrize("kind,extra,key_bits", [
    ("unique", {}, 32), ("modulo", {"modulo": 333}, 32),
    ("zipf", {"zipf_theta": 0.75}, 32), ("zipf", {"zipf_theta": 1.1,
                                                  "key_domain": 1 << 20}, 32),
    ("unique", {}, 64), ("modulo", {"modulo": 333}, 64)])
def test_shards_equal_jax_shard_np(nodes, kind, extra, key_bits):
    spec = dict(global_size=6000, num_nodes=nodes, kind=kind, seed=17,
                key_bits=key_bits, **extra)
    t, j = trel.Relation(**spec), jrel.Relation(**spec)
    whole = t.generate("cpu")
    for rank in range(nodes):
        got = t.shard(rank, "cpu")
        want = j.shard_np(rank)
        np.testing.assert_array_equal(lane_to_numpy(got.key), want[0])
        np.testing.assert_array_equal(lane_to_numpy(got.rid), want[-1])
        if key_bits == 64:
            np.testing.assert_array_equal(lane_to_numpy(got.key_hi), want[1])
        lo = rank * t.local_size
        np.testing.assert_array_equal(
            lane_to_numpy(got.key),
            lane_to_numpy(whole.key[lo:lo + t.local_size]))
    with pytest.raises(ValueError, match="node"):
        t.shard(nodes, "cpu")


def test_initialize_without_configuration_is_a_no_op(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.process_info() == (0, 1)
    multihost.shutdown()   # nothing joined: nothing to leave


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_connect_that_never_succeeds_is_a_coordinator_timeout():
    """Rank 1 of 2 dials a rendezvous nobody serves: every attempt times
    out, and the last raises the coordinator_timeout class, not a hang."""
    slept = []
    policy = RetryPolicy(max_attempts=2, base_delay_s=0.01)
    with pytest.raises(multihost.CoordinatorTimeout) as err:
        multihost.initialize(
            init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=2,
            rank=1, device="cpu", retry_policy=policy, timeout_s=1,
            _sleep=slept.append)
    assert err.value.failure_class == COORDINATOR_TIMEOUT
    assert err.value.attempts == 2 and slept == [policy.delay_s(0)]
    assert not torch.distributed.is_initialized()


def test_an_injected_connect_fault_retries_then_times_out(tmp_path):
    with faults.FaultInjector(seed=3).arm(faults.COORD_CONNECT) as inj:
        with pytest.raises(multihost.CoordinatorTimeout) as err:
            multihost.initialize(
                init_method=f"file://{tmp_path / 'rendezvous'}",
                world_size=1, rank=0, device="cpu",
                retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0),
                _sleep=lambda s: None)
    assert inj.hits(faults.COORD_CONNECT) == 3
    assert err.value.attempts == 3
    assert not torch.distributed.is_initialized()


def test_initialize_on_the_card_needs_a_card():
    """No card: the default device raises instead of taking gloo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize(init_method="tcp://127.0.0.1:1", world_size=2,
                             rank=0)


def test_a_one_rank_gloo_group_runs_both_bodies(tmp_path):
    """A process group of one rank: the engine takes its group, refuses a
    size or backend that does not fit, and both bodies answer as the
    one-rank world does."""
    assert multihost.initialize(
        init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
        rank=0, device="cpu", timeout_s=60) is False
    try:
        group = torch.distributed.group.WORLD
        assert multihost.process_info() == (0, 1)
        with pytest.raises(ValueError, match="2 but the process group"):
            tx.HashJoin(tx.JoinConfig(num_nodes=2), device="cpu",
                        group=group)
        inner = tx.Relation(3000, 1, "unique", seed=1)
        outer = tx.Relation(3000, 1, "modulo", seed=2, modulo=700)
        for cfg in (tx.JoinConfig(), tx.JoinConfig(probe_algorithm="bucket")):
            alone = tx.HashJoin(cfg, device="cpu")
            eng = tx.HashJoin(cfg, device="cpu", group=group)
            want = alone.join(inner, outer)
            r, s = eng.place(inner), eng.place(outer)
            for got in (eng.join(inner, outer), eng.join_shuffled(r, s),
                        alone.join_shuffled(r, s)):
                assert got.matches == want.matches == 3000
                np.testing.assert_array_equal(got.partition_counts,
                                              want.partition_counts)
                assert got.diagnostics == want.diagnostics
            assert eng.world.counts["all_to_all"] >= 6
    finally:
        multihost.shutdown()


def test_num_nodes_without_a_group_raises_naming_initialize():
    cfg = config_from_jax(dataclasses.asdict(jx.JoinConfig(num_nodes=4)))
    assert cfg.num_nodes == 4
    with pytest.raises(ValueError, match="multihost.initialize"):
        tx.HashJoin(cfg, device="cpu")


@pytest.mark.parametrize("field,value,item", [
    ("num_hosts", 2, "A10"), ("chunk_size", 4096, "A7b")])
def test_distributed_settings_outside_the_slice_raise(field, value, item,
                                                      tmp_path):
    """Both are ported now: ``num_hosts`` (A10, the hierarchical
    exchange) and ``chunk_size`` (A7b) carry across, and a torchrun launch
    of the command line (``--hosts 2`` or ``--chunk-size``) joins with it
    over two gloo ranks exactly, as the JAX engine does over two
    devices."""
    d = dataclasses.asdict(jx.JoinConfig(num_nodes=2))
    d[field] = value
    assert getattr(config_from_jax(d), field) == value
    flag = "--hosts" if field == "num_hosts" else "--chunk-size"
    out = _torchrun(tmp_path, flag, str(value))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    inner = jx.Relation(2 * 4096, 2, "unique", seed=1234)
    outer = jx.Relation(2 * 4096, 2, "modulo", seed=1235, modulo=2048)
    want = jx.HashJoin(jx.JoinConfig(num_nodes=2, **{field: value})).join(
        inner, outer)
    assert res["matches"] == want.matches == inner.expected_matches(outer)
    assert res["ok"] and want.ok
    assert res["pipeline"] == ("chunked_probe" if field == "chunk_size"
                               else "shuffled_sort_probe")
    assert "[RESULTS] Expected: 8192 (OK)" in out.stdout


def _torchrun(cwd, *extra):
    """The command line over two gloo ranks under torchrun, 4096 unique
    tuples a rank against a modulo outer relation; fails the test unless
    it exits 0 within its deadline."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    for name in TORCHRUN_ENV:
        env.pop(name, None)
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "tpu_radix_join_torch.main",
            "--nodes", "2", "--device", "cpu", "--tuples-per-node", "4096",
            "--outer-kind", "modulo", *extra]
    try:
        out = subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=240)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"torchrun passed its deadline: {e.stderr}")
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_torchrun_launches_the_command_line_over_two_gloo_ranks(tmp_path):
    out = _torchrun(tmp_path)
    # rank 0's aggregate over both ranks' gathered registries
    assert "[RESULTS] Nodes: 2" in out.stdout
    assert "[RESULTS] Expected: 8192 (OK)" in out.stdout
    lines = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1   # rank 0 prints the result
    got = lines[0]
    assert got["matches"] == got["expected"] == 8192 and got["ok"]
    assert got["nodes"] == 2 and got["pipeline"] == "shuffled_sort_probe"
    assert got["device"] == "cpu"
