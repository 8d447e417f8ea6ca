"""Port parity of the out-of-core grid: ``chunked_join_grid`` (synchronous
and pipelined, on lists and factories) against the JAX grid on the same
chunks, totals and counters exactly; checkpoints written by one package
resumed by the other after a ``GRID_KILL``; fingerprint and extent
mismatches; retries; the pause-file handshake."""

import json
import os
import subprocess
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.data.relation import Relation as JRelation  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.ops.chunked import (  # noqa: E402
    chunked_join_grid as jax_grid)
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402

from tpu_radix_join_torch.data.tuples import (TupleBatch,  # noqa: E402
                                              lane_from_numpy)
from tpu_radix_join_torch.ops import chunked  # noqa: E402
from tpu_radix_join_torch.ops.chunked import chunked_join_grid  # noqa: E402
from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    CKPTLOAD, CKPTSAVE, GRIDPAIRS, PREFETCH, RETRYN, SORTREUSE, Measurements)
from tpu_radix_join_torch.robustness import faults  # noqa: E402
from tpu_radix_join_torch.robustness.checkpoint import (  # noqa: E402
    CheckpointManager, CheckpointMismatch)
from tpu_radix_join_torch.robustness.faults import (  # noqa: E402
    FaultInjector, InjectedKill, TransientFault)
from tpu_radix_join_torch.robustness.retry import (  # noqa: E402
    RetriesExhausted, RetryPolicy)

COUNTERS = (GRIDPAIRS, SORTREUSE, PREFETCH, CKPTSAVE, CKPTLOAD)


@pytest.fixture(autouse=True)
def _own_lock_files(tmp_path, monkeypatch):
    """Keep the grid's pause and presence files out of the shared tree."""
    monkeypatch.setenv("TPU_RJ_PAUSE_FILE", str(tmp_path / "BENCH_RUNNING"))
    monkeypatch.setenv("TPU_RJ_GRID_FILE", str(tmp_path / "GRID_RUNNING"))


def _chunks(keys_list, wide_hi=None):
    """The same chunks for both packages: (JAX batches, port batches)."""
    jb, tb = [], []
    for i, k in enumerate(keys_list):
        rid = np.arange(len(k), dtype=np.uint32)
        hi = None if wide_hi is None else wide_hi[i]
        jb.append(JBatch(key=jnp.asarray(k), rid=jnp.asarray(rid),
                         key_hi=None if hi is None else jnp.asarray(hi)))
        tb.append(TupleBatch(key=lane_from_numpy(k, "cpu"),
                             rid=lane_from_numpy(rid, "cpu"),
                             key_hi=None if hi is None
                             else lane_from_numpy(hi, "cpu")))
    return jb, tb


def _random(seed, n_chunks, size=1 << 10, hi=1 << 12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hi, size).astype(np.uint32)
            for _ in range(n_chunks)]


def _oracle(r_keys, s_keys):
    from collections import Counter
    cnt = Counter(np.concatenate(r_keys).tolist())
    return sum(cnt[k] for k in np.concatenate(s_keys).tolist())


def _counters(m):
    return {k: m.counters.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("pipeline", ["off", "on", "auto"])
@pytest.mark.parametrize("outer", ["list", "factory"])
def test_grid_equals_jax_totals_and_counters(pipeline, outer, tmp_path):
    """A duplicate-heavy 3 x 4 grid with a ragged last outer chunk and a
    checkpoint: the same total as the JAX grid and the oracle, and the same
    GRIDPAIRS, SORTREUSE, PREFETCH and CKPTSAVE."""
    r_keys = _random(1, 3)
    s_keys = _random(2, 3) + [_random(3, 1, size=300)[0]]
    jr, tr = _chunks(r_keys)
    js, ts = _chunks(s_keys)
    got_m, want_m = Measurements(), JMeasurements()
    kw = dict(slab_size=256, pipeline=pipeline, checkpoint_tag="t")
    want = jax_grid(jr, (lambda: iter(js)) if outer == "factory" else js,
                    checkpoint_path=str(tmp_path / "jax.ckpt"),
                    measurements=want_m, **kw)
    got = chunked_join_grid(tr, (lambda: iter(ts)) if outer == "factory"
                            else ts, checkpoint_path=str(tmp_path / "t.ckpt"),
                            measurements=got_m, **kw)
    assert got == want == _oracle(r_keys, s_keys)
    got_c, want_c = _counters(got_m), _counters(want_m)
    if pipeline != "off":
        # write-behind saves coalesce (the newest queued state wins), so
        # their count depends on timing; the final done save always lands
        assert 1 <= got_c.pop(CKPTSAVE) <= 13
        assert 1 <= want_c.pop(CKPTSAVE) <= 13
        assert got_m.counters[SORTREUSE] == 3 * 3
    assert got_c == want_c
    assert got_m.counters[GRIDPAIRS] == 12
    saved = json.load(open(tmp_path / "t.ckpt"))
    assert saved == json.load(open(tmp_path / "jax.ckpt"))


@pytest.mark.parametrize("key_range", ["auto", "narrow", "full"])
@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_grid_key_ranges_equal_jax(key_range, pipeline):
    """Keys in [2**30, 2**31): every discipline gives the JAX total (the
    full count and the presorted probe take every key below the pads)."""
    r_keys = [k | np.uint32(1 << 30) for k in _random(4, 2)]
    s_keys = [k | np.uint32(1 << 30) for k in _random(5, 2)]
    jr, tr = _chunks(r_keys)
    js, ts = _chunks(s_keys)
    want = jax_grid(jr, js, 512, key_range=key_range, pipeline=pipeline)
    got = chunked_join_grid(tr, ts, 512, key_range=key_range,
                            pipeline=pipeline)
    assert got == want == _oracle(r_keys, s_keys)


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_wide_grid_equals_jax(pipeline):
    """64-bit chunks (two lanes): keys equal in lo and different in hi must
    not match, in either engine."""
    rng = np.random.default_rng(9)
    lo = [rng.integers(0, 64, 700).astype(np.uint32) for _ in range(4)]
    hi = [rng.integers(0, 3, 700).astype(np.uint32) for _ in range(4)]
    jr, tr = _chunks(lo[:2], hi[:2])
    js, ts = _chunks(lo[2:], hi[2:])
    got_m, want_m = Measurements(), JMeasurements()
    want = jax_grid(jr, js, 256, pipeline=pipeline, measurements=want_m)
    got = chunked_join_grid(tr, ts, 256, pipeline=pipeline,
                            measurements=got_m)
    keys = [(h.astype(np.uint64) << np.uint64(32)) | l
            for l, h in zip(lo, hi)]
    assert got == want == _oracle(keys[:2], keys[2:])
    assert _counters(got_m) == _counters(want_m)


def test_pipeline_auto_resolution():
    """"auto" is the synchronous loop for a 1 x 1 grid (no prefetch) and
    the pipeline for anything larger; an unknown mode raises."""
    keys = _random(6, 1)
    _, (r,) = _chunks(keys)
    m = Measurements()
    assert chunked_join_grid([r], [r], 1 << 10, pipeline="auto",
                             measurements=m) == _oracle(keys, keys)
    assert m.counters.get(PREFETCH, 0) == 0
    m = Measurements()
    chunked_join_grid([r, r], [r], 1 << 10, pipeline="auto", measurements=m)
    assert m.counters[PREFETCH] == 2 + 2 * 1     # both inner, one outer a row
    with pytest.raises(ValueError, match="pipeline"):
        chunked_join_grid([r], [r], 1 << 10, pipeline="maybe")
    with pytest.raises(ValueError, match="checkpoint_tag"):
        chunked_join_grid([r], [r], 1 << 10, checkpoint_path="x")


def _kill_run(grid, fmod, ckpt, r, s, pipeline, at):
    """Run ``grid`` under ``fmod``'s injector with GRID_KILL at hit
    ``at``; returns the pairs it probed."""
    m = JMeasurements() if grid is jax_grid else Measurements()
    with fmod.FaultInjector() as inj:
        inj.arm(fmod.GRID_KILL, at=at, exc=fmod.InjectedKill)
        with pytest.raises(fmod.InjectedKill):
            grid(r, s, 1 << 10, checkpoint_path=ckpt, checkpoint_tag="t",
                 measurements=m, pipeline=pipeline)
    return m.counters[GRIDPAIRS]


def _quarters(seed, n=1 << 12):
    keys = JRelation(n, 1, "unique", seed=seed).shard_np(0)[0]
    return [keys[i * (n // 4):(i + 1) * (n // 4)] for i in range(4)]


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("direction", ["jax_then_port", "port_then_jax"])
def test_kill_in_one_package_resume_in_the_other(direction, pipeline,
                                                 tmp_path):
    """A grid killed after some pairs in one package resumes in the other:
    the same total, and only the unclaimed pairs probed (zero recompute)."""
    jr, tr = _chunks(_quarters(1))
    ckpt = str(tmp_path / "grid.ckpt")
    grid1, fmod, chunks1, meas2, grid2, chunks2 = (
        (jax_grid, jfaults, jr, Measurements, chunked_join_grid, tr)
        if direction == "jax_then_port" else
        (chunked_join_grid, faults, tr, JMeasurements, jax_grid, jr))
    dispatched = _kill_run(grid1, fmod, ckpt, chunks1, chunks1, pipeline, 5)
    assert dispatched == 4
    state = json.load(open(ckpt))
    assert not state["done"]
    claimed = state["i"] * state["cols"] + state["j"]
    assert claimed == (4 if pipeline == "off" else 2)
    m2 = meas2()
    total = grid2(chunks2, chunks2, 1 << 10, checkpoint_path=ckpt,
                  checkpoint_tag="t", measurements=m2, pipeline=pipeline)
    assert total == 1 << 12
    assert m2.counters[CKPTLOAD] == 1
    assert m2.counters[GRIDPAIRS] == 16 - claimed
    assert json.load(open(ckpt))["done"]


def test_checkpoint_mismatches_raise(tmp_path):
    """Another tag, another slab or another grid extent is refused."""
    _, tr = _chunks(_quarters(2))
    ckpt = str(tmp_path / "grid.ckpt")
    assert chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=ckpt,
                             checkpoint_tag="a") == 1 << 12
    with pytest.raises(CheckpointMismatch):
        chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=ckpt,
                          checkpoint_tag="b")
    with pytest.raises(CheckpointMismatch):
        chunked_join_grid(tr, tr, 1 << 9, checkpoint_path=ckpt,
                          checkpoint_tag="a")
    # a generator-fed grid has no rows in its fingerprint: the saved extent
    # catches a resume over another chunking
    CheckpointManager(ckpt, {"slab": 1024, "tag": "g", "rows": None,
                             "cols": None}).save(
        {"i": 1, "j": 0, "total": 5, "cols": 3})
    with pytest.raises(CheckpointMismatch, match="outer chunk"):
        chunked_join_grid(iter(tr), lambda: iter(tr), 1 << 10,
                          checkpoint_path=ckpt, checkpoint_tag="g")
    assert CheckpointMismatch("x").failure_class == "checkpoint_mismatch"


def test_done_checkpoint_short_circuits_and_corrupt_restarts(tmp_path):
    _, tr = _chunks(_quarters(3))
    ckpt = tmp_path / "grid.ckpt"
    chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=str(ckpt),
                      checkpoint_tag="t")
    m = Measurements()
    assert chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=str(ckpt),
                             checkpoint_tag="t", measurements=m) == 1 << 12
    assert m.counters.get(GRIDPAIRS, 0) == 0 and m.counters[CKPTLOAD] == 1
    ckpt.write_text('{"i": 1, "j"')        # torn: restart from zero
    m = Measurements()
    assert chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=str(ckpt),
                             checkpoint_tag="t", measurements=m) == 1 << 12
    assert m.counters[GRIDPAIRS] == 16


def test_checkpoint_faults_never_kill_the_grid(tmp_path):
    """A failed save loses a resume point; a failed load restarts."""
    _, tr = _chunks(_quarters(4))
    ckpt = str(tmp_path / "grid.ckpt")
    m = Measurements()
    with FaultInjector(measurements=m) as inj:
        inj.arm(faults.CKPT_SAVE, at=(1, 2), exc=OSError)
        assert chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=ckpt,
                                 checkpoint_tag="t",
                                 measurements=m) == 1 << 12
    assert m.counters[CKPTSAVE] == 15
    assert sum(name == "checkpoint_save_failed" for name, _ in m.events) == 2
    with FaultInjector() as inj:
        inj.arm(faults.CKPT_LOAD, exc=OSError)
        m = Measurements()
        assert chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=ckpt,
                                 checkpoint_tag="t",
                                 measurements=m) == 1 << 12
    assert m.counters[GRIDPAIRS] == 16


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_transient_fault_costs_one_retry(pipeline):
    _, tr = _chunks(_quarters(5))
    m = Measurements()
    slept = []
    policy = RetryPolicy(max_attempts=3, base_delay_s=0.0)
    with FaultInjector() as inj:
        inj.arm(faults.GRID_TRANSIENT, at=2, exc=TransientFault)
        assert chunked_join_grid(tr, tr, 1 << 10, retry_policy=policy,
                                 measurements=m,
                                 pipeline=pipeline) == 1 << 12
    assert m.counters[RETRYN] == 1 and m.counters[GRIDPAIRS] == 16
    del slept
    with FaultInjector() as inj:
        inj.arm(faults.GRID_TRANSIENT, exc=TransientFault)
        with pytest.raises(RetriesExhausted):
            chunked_join_grid(tr, tr, 1 << 10, retry_policy=policy,
                              pipeline=pipeline)


def test_pause_file_handshake(tmp_path, monkeypatch, capsys):
    """A pause file of a dead process is removed at once; one of a live
    process parks the grid, which marks itself parked, until it goes."""
    _, (r,) = _chunks([np.random.default_rng(1).permutation(1024)
                       .astype(np.uint32)])
    pause = tmp_path / "BENCH_RUNNING"
    grid_f = tmp_path / "GRID_RUNNING"
    proc = subprocess.Popen(["true"])
    proc.wait()
    pause.write_text(str(proc.pid))
    t0 = time.perf_counter()
    assert chunked_join_grid([r], [r], 1024) == 1024
    assert time.perf_counter() - t0 < 4.0 and not pause.exists()
    pause.write_text(str(os.getpid()))
    seen = {}

    def observe_then_release():
        time.sleep(1.0)
        seen["grid"] = grid_f.exists()
        seen["parked"] = (tmp_path / "GRID_RUNNING.parked").exists()
        pause.unlink()

    threading.Thread(target=observe_then_release).start()
    assert chunked_join_grid([r], [r], 1024) == 1024
    assert seen == {"grid": True, "parked": True}
    assert not grid_f.exists()
    assert not (tmp_path / "GRID_RUNNING.parked").exists()
    out = capsys.readouterr().out
    assert "paused" in out and "resumed" in out


def test_resume_progress_lines(tmp_path, capsys):
    _, tr = _chunks(_quarters(6))
    ckpt = str(tmp_path / "grid.ckpt")
    with FaultInjector() as inj:
        inj.arm(faults.GRID_KILL, at=7, exc=InjectedKill)
        with pytest.raises(InjectedKill):
            chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=ckpt,
                              checkpoint_tag="t")
    capsys.readouterr()
    chunked_join_grid(tr, tr, 1 << 10, checkpoint_path=ckpt,
                      checkpoint_tag="t", progress=True)
    out = capsys.readouterr().out
    assert "resume: skipping 6 completed pair(s)" in out
    assert "pairs/s" in out and "eta=" in out


def test_unknown_fault_site_warns_with_a_suggestion():
    with pytest.warns(RuntimeWarning, match="did you mean 'grid.mid_chunk_kill'"):
        FaultInjector().arm("grid.mid_chunk_kil")
    assert faults.active() is None


def test_prefetch_threads_lose_nothing_under_a_short_switch_interval(
        monkeypatch):
    """The prefetch threads and the consumer share the queues and the
    counters: with threads switching every microsecond (and a one-slot
    outer queue) no chunk and no count is lost."""
    import sys
    monkeypatch.setattr(chunked, "_PREFETCH_DEPTH", 1)
    keys = _random(7, 6, size=256, hi=64)
    _, chunks = _chunks(keys)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        m = Measurements()
        total = chunked_join_grid(chunks[:3], chunks[3:], 64, pipeline="on",
                                  measurements=m)
    finally:
        sys.setswitchinterval(old)
    assert total == _oracle(keys[:3], keys[3:])
    assert m.counters[PREFETCH] == 3 + 3 * 3
    assert m.counters[GRIDPAIRS] == 9 and m.counters[SORTREUSE] == 3 * 2
    assert m.span_n["prefetch_wait"] == 3 + 1 + 3 * (3 + 1)
