"""Port parity of the chunked count, the device chunk stream, the chunked
fallback and the grid CLI: ``chunked_join_count`` for every key range,
``key_bound`` and 64-bit keys, with the same raises as the JAX function;
``stream_chunks_device`` chunk for chunk; ``HashJoin(fallback="chunked")``
against the JAX engine; ``python -m tpu_radix_join_torch.main
--grid-chunk-tuples``.  Every comparison is exact."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data.relation import host_join_count  # noqa: E402
from tpu_radix_join.data.streaming import (  # noqa: E402
    stream_chunks_device as jax_stream)
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.ops.chunked import (  # noqa: E402
    chunked_join_count as jax_count)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.data.streaming import (  # noqa: E402
    stream_chunks_device)
from tpu_radix_join_torch.data.tuples import (TupleBatch,  # noqa: E402
                                              lane_from_numpy, lane_to_numpy)
from tpu_radix_join_torch.main import main as tx_main  # noqa: E402
from tpu_radix_join_torch.ops.chunked import chunked_join_count  # noqa: E402
from tpu_radix_join_torch.ops.merge_count import MAX_MERGE_KEY  # noqa: E402
from tpu_radix_join_torch.robustness import faults  # noqa: E402
from tpu_radix_join_torch.robustness.verify import (  # noqa: E402
    DataCorruption)

ROOT = Path(__file__).resolve().parents[1]


def _pair(r, s, r_hi=None, s_hi=None):
    """(JAX batches, port batches) over the same uint32 lanes."""
    def both(k, hi):
        rid = np.arange(len(k), dtype=np.uint32)
        return (JBatch(key=jnp.asarray(k), rid=jnp.asarray(rid),
                       key_hi=None if hi is None else jnp.asarray(hi)),
                TupleBatch(key=lane_from_numpy(k, "cpu"),
                           rid=lane_from_numpy(rid, "cpu"),
                           key_hi=None if hi is None
                           else lane_from_numpy(hi, "cpu")))
    (jr, tr), (js, ts) = both(r, r_hi), both(s, s_hi)
    return (jr, js), (tr, ts)


def _keys(case, rng):
    if case == "duplicates":
        return (rng.integers(0, 300, 3000).astype(np.uint32),
                rng.integers(0, 300, 2500).astype(np.uint32))
    if case == "high":         # above the 31-bit packing, below the pads
        r = rng.integers(1 << 31, 0xFFFFFFFE, 3000,
                         dtype=np.uint64).astype(np.uint32)
        return r, np.concatenate([r[:1000], r[:700]])
    if case == "near_max_merge_key":
        r = np.uint32(MAX_MERGE_KEY) - rng.integers(0, 50, 3000).astype(
            np.uint32)
        return r, np.uint32(MAX_MERGE_KEY) - rng.integers(0, 60, 2000).astype(
            np.uint32)
    raise ValueError(case)


@pytest.mark.parametrize("key_range", ["auto", "narrow", "full"])
@pytest.mark.parametrize("case", ["duplicates", "high", "near_max_merge_key"])
@pytest.mark.parametrize("slab", [1 << 10, 777])
def test_chunked_join_count_equals_jax(case, key_range, slab):
    """Every discipline, ragged slabs; "narrow" on keys above the packing
    raises in both packages instead of undercounting."""
    r, s = _keys(case, np.random.default_rng(len(case) + slab))
    (jr, js), (tr, ts) = _pair(r, s)
    if case == "high" and key_range == "narrow":
        with pytest.raises(ValueError, match="31-bit packing"):
            jax_count(jr, js, slab, key_range=key_range)
        with pytest.raises(ValueError, match="31-bit packing"):
            chunked_join_count(tr, ts, slab, key_range=key_range)
        return
    want = jax_count(jr, js, slab, key_range=key_range)
    got = chunked_join_count(tr, ts, slab, key_range=key_range)
    assert got == want == host_join_count(r, s)


@pytest.mark.parametrize("key_range", ["auto", "narrow", "full"])
def test_key_bound_replaces_the_device_probe(key_range):
    r, s = _keys("duplicates", np.random.default_rng(3))
    (jr, js), (tr, ts) = _pair(r, s)
    bound = int(max(r.max(), s.max()))
    want = jax_count(jr, js, 512, key_range=key_range, key_bound=bound)
    got = chunked_join_count(tr, ts, 512, key_range=key_range,
                             key_bound=bound)
    assert got == want == host_join_count(r, s)
    # a bound above the packing routes "auto" to the full count
    assert chunked_join_count(tr, ts, 512, key_bound=MAX_MERGE_KEY + 1) == want


def test_same_raises_as_jax():
    """A bound or a key in the pad range: the classified DataCorruption; a
    narrow bound above the packing: ValueError; mixed widths and an
    unknown mode: ValueError; a window that could wrap: OverflowError."""
    r, s = _keys("duplicates", np.random.default_rng(4))
    (jr, js), (tr, ts) = _pair(r, s)
    for kw, exc in (({"key_bound": 0xFFFFFFFE}, "data_corruption"),
                    ({"key_range": "narrow", "key_bound": MAX_MERGE_KEY + 1},
                     ValueError),
                    ({"key_range": "sideways"}, ValueError)):
        for fn, a, b in ((jax_count, jr, js), (chunked_join_count, tr, ts)):
            with pytest.raises(Exception) as info:
                fn(a, b, 512, **kw)
            if exc == "data_corruption":
                assert info.value.failure_class == "data_corruption"
                assert isinstance(info.value, ValueError)
            else:
                assert type(info.value) is exc
    # a sentinel key in the lanes under "auto"
    bad = s.copy()
    bad[7] = 0xFFFFFFFF
    (jr2, js2), (tr2, ts2) = _pair(r, bad)
    with pytest.raises(ValueError) as want:
        jax_count(jr2, js2, 512)
    with pytest.raises(DataCorruption) as got:
        chunked_join_count(tr2, ts2, 512)
    assert got.value.failure_class == want.value.failure_class
    # 70,000 inner copies of one key in a window of 2**16 can wrap
    heavy = np.full(70000, 5, np.uint32)
    (jr3, js3), (tr3, ts3) = _pair(heavy, np.array([5, 6], np.uint32))
    with pytest.raises(OverflowError):
        jax_count(jr3, js3, 1 << 16)
    with pytest.raises(OverflowError, match="overflow risk"):
        chunked_join_count(tr3, ts3, 1 << 16)
    # mixed widths
    (_, _), (tw, _) = _pair(r, s, r_hi=np.ones_like(r))
    with pytest.raises(ValueError, match="mixed key widths"):
        chunked_join_count(tw, ts, 512)


def test_wide_count_equals_jax():
    """64-bit lanes: equal lo with different hi must not match."""
    rng = np.random.default_rng(5)
    r, s = (rng.integers(0, 40, n).astype(np.uint32) for n in (2000, 2500))
    r_hi, s_hi = (rng.integers(0, 3, n).astype(np.uint32)
                  for n in (2000, 2500))
    (jr, js), (tr, ts) = _pair(r, s, r_hi, s_hi)
    want = jax_count(jr, js, 600)
    got = chunked_join_count(tr, ts, 600)
    wide = lambda lo, hi: (hi.astype(np.uint64) << np.uint64(32)) | lo  # noqa
    assert got == want == host_join_count(wide(r, r_hi), wide(s, s_hi))


@pytest.mark.parametrize("kind,kw", [
    ("unique", {}), ("modulo", {"modulo": 977}),
    ("zipf", {"zipf_theta": 0.75}), ("unique", {"key_bits": 64})])
def test_stream_chunks_device_equal_jax(kind, kw):
    """Chunk for chunk (ragged last chunk included), every lane bit for bit."""
    n, chunk = 5000, 2048
    jrel = jx.Relation(n, 1, kind, seed=11, **kw)
    trel = tx.Relation(n, 1, kind, seed=11, **kw)
    want = list(jax_stream(jrel, 0, chunk))
    got = list(stream_chunks_device(trel, 0, chunk, "cpu"))
    assert [b.size for b in got] == [2048, 2048, 904]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for lane in ("key", "rid", "key_hi"):
            gl, wl = getattr(g, lane), getattr(w, lane)
            if wl is None:
                assert gl is None
            else:
                np.testing.assert_array_equal(lane_to_numpy(gl),
                                              np.asarray(wl))
    with pytest.raises(ValueError):
        next(stream_chunks_device(trel, 0, 0, "cpu"))


def test_stream_corruption_is_caught_loudly():
    """``stream.corrupt_lane`` puts the pad into a chunk's first key; the
    auto count raises DataCorruption, and only the armed hit is damaged."""
    rel = tx.Relation(4096, 1, "unique", seed=1)
    with faults.FaultInjector() as inj:
        inj.arm(faults.STREAM_CORRUPT, at=2)
        chunks = list(stream_chunks_device(rel, 0, 1024, "cpu"))
    assert (inj.hits(faults.STREAM_CORRUPT), inj.fired(faults.STREAM_CORRUPT)
            ) == (4, 1)
    assert [int(lane_to_numpy(c.key)[0]) == 0xFFFFFFFF for c in chunks] == [
        False, True, False, False]
    with pytest.raises(DataCorruption):
        chunked_join_count(chunks[0], chunks[1], 512)
    # the JAX injector never fires in the port, nor the reverse
    with jfaults.FaultInjector() as jinj:
        jinj.arm(jfaults.STREAM_CORRUPT)
        clean = next(stream_chunks_device(rel, 0, 1024, "cpu"))
    assert int(lane_to_numpy(clean.key).max()) < 4096


def _jax_join(cfg, r, s):
    return jx.HashJoin(cfg).join(r, s)


@pytest.mark.parametrize("outer", ["zipf", "unique"])
def test_chunked_fallback_equals_jax(outer):
    """A two-level join short of capacity with no retries degrades to the
    out-of-core count: the same matches, ok, diagnostics and partition
    counts as the JAX engine; a join that fits never degrades."""
    n = 1 << 12
    kw = {"zipf_theta": 0.75} if outer == "zipf" else {}
    jcfg = jx.JoinConfig(two_level=True, fallback="chunked", max_retries=0)
    want = _jax_join(jcfg, jx.Relation(n, 1, "unique", seed=1),
                     jx.Relation(n, 1, outer, seed=2, **kw))
    got = tx.HashJoin(tx.JoinConfig(two_level=True, fallback="chunked"),
                      device="cpu").join(
        tx.Relation(n, 1, "unique", seed=1),
        tx.Relation(n, 1, outer, seed=2, **kw))
    assert got.matches == want.matches == n
    assert got.ok == want.ok
    assert got.diagnostics == want.diagnostics
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    if outer == "zipf":
        assert got.diagnostics["degraded"] == "chunked"
        assert got.diagnostics["failure_class"] == "capacity_overflow"
        assert "fallback_error" not in got.diagnostics
    else:
        assert "degraded" not in got.diagnostics


def test_fallback_error_is_reported_not_raised():
    """An error of the degraded count lands in ``fallback_error`` with the
    ``retries_exhausted`` class, in both packages."""
    n = 70000
    r = np.full(n, 5, np.uint32)
    s = np.arange(n, dtype=np.uint32)
    jcfg = jx.JoinConfig(two_level=True, fallback="chunked", max_retries=0)
    engine = jx.HashJoin(jcfg)
    want = engine.join_arrays(
        JBatch(key=jnp.asarray(r), rid=jnp.arange(n, dtype=jnp.uint32)),
        JBatch(key=jnp.asarray(s), rid=jnp.arange(n, dtype=jnp.uint32)))
    got = tx.HashJoin(tx.JoinConfig(two_level=True, fallback="chunked"),
                      device="cpu").join_arrays(
        tx.batch_from_numpy(r, np.arange(n, dtype=np.uint32), device="cpu"),
        tx.batch_from_numpy(s, np.arange(n, dtype=np.uint32), device="cpu"))
    assert not got.ok and not want.ok and got.matches == want.matches == 0
    for d in (got.diagnostics, dict(want.diagnostics)):
        assert d["failure_class"] == "retries_exhausted"
        assert d["degraded"] == "chunked"
        assert d["fallback_error"].startswith("OverflowError(")
    assert got.partition_counts.shape == (1,)


def test_grid_cli_on_the_cpu(tmp_path, capsys):
    """``--device cpu --grid-chunk-tuples``: the oracle total through the
    pipelined grid, a checkpoint the rerun resumes from, and --resume
    without a directory refused."""
    args = ["--device", "cpu", "--grid-chunk-tuples", "4096",
            "--tuples-per-node", "16384", "--outer-kind", "modulo",
            "--checkpoint-dir", str(tmp_path)]
    assert tx_main(args) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["matches"] == got["expected"] == 16384 and got["ok"]
    assert got["pairs"] == 16 and got["counters"]["SORTREUSE"] == 12
    assert got["device"] == "cpu"
    saved = json.load(open(tmp_path / "grid.ckpt"))
    assert saved["done"] and saved["total"] == 16384
    assert saved["fingerprint"]["tag"] == "modulo:16384:1234:4096:auto"
    assert tx_main(args + ["--resume", "--grid-pipeline", "off"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["matches"] == 16384 and got["pairs"] == 0
    with pytest.raises(SystemExit):
        tx_main(["--device", "cpu", "--grid-chunk-tuples", "64", "--resume"])


def test_grid_cli_needs_a_card_unless_asked():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "tpu_radix_join_torch.main",
         "--grid-chunk-tuples", "64", "--tuples-per-node", "256"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_fallback_cli_on_the_cpu(capsys):
    assert tx_main(["--device", "cpu", "--two-level", "--outer-kind", "zipf",
                    "--fallback", "chunked", "--tuples-per-node", "4096"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["matches"] == 4096 and got["degraded"] == "chunked"
