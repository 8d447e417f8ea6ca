"""The host-fed chunk stream (``data/streaming.stream_chunks``) against the
JAX package's ``stream_chunks``, chunk for chunk and bit for bit, for
unique, modulo, Zipf and 64-bit relations, ragged last chunks and a
bounded pool; the grid fed from it (synchronous and pipelined) against the
oracle and JAX's grid; the ``stream.corrupt_lane`` fault as JAX raises
it; buffer reuse under a slowed fill thread; and the pipelined grid's
prefetcher staging a chunk as it is.  On the CPU a chunk's lanes are
copies of the pool's buffers (the card's copies, asynchronous from the
pinned pool, are held by ``chip_smoke.py``)."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.data.relation import Relation as JRelation  # noqa: E402
from tpu_radix_join.data.streaming import (  # noqa: E402
    stream_chunks as jstream_chunks)
from tpu_radix_join.ops.chunked import (  # noqa: E402
    chunked_join_grid as jgrid)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402

import tpu_radix_join_torch.data as tdata  # noqa: E402
from tpu_radix_join_torch.data.relation import Relation  # noqa: E402
from tpu_radix_join_torch.data.streaming import (  # noqa: E402
    pool_bytes, stream_chunks, stream_chunks_device)
from tpu_radix_join_torch.data.tuples import lane_to_numpy  # noqa: E402
from tpu_radix_join_torch.memory import Pool  # noqa: E402
from tpu_radix_join_torch.ops import chunked  # noqa: E402
from tpu_radix_join_torch.robustness import faults as tfaults  # noqa: E402
from tpu_radix_join_torch.robustness.verify import (  # noqa: E402
    DataCorruption)

SPECS = {
    "unique": dict(global_size=1 << 14, num_nodes=2, kind="unique", seed=5),
    "modulo": dict(global_size=1 << 13, num_nodes=1, kind="modulo",
                   modulo=257, seed=3),
    "zipf": dict(global_size=1 << 13, num_nodes=1, kind="zipf",
                 zipf_theta=0.75, key_domain=1 << 20, seed=3),
    "wide": dict(global_size=1 << 13, num_nodes=2, kind="unique",
                 key_bits=64, seed=11),
}


def _lanes(batch):
    return [None if lane is None else np.asarray(lane).astype(np.uint32)
            for lane in (batch.key, batch.rid, batch.key_hi)]


def _tlanes(batch):
    return [None if lane is None else lane_to_numpy(lane)
            for lane in (batch.key, batch.rid, batch.key_hi)]


@pytest.mark.parametrize("chunk", [1 << 10, 1500])
@pytest.mark.parametrize("case", list(SPECS))
def test_stream_chunks_equals_jax_chunk_for_chunk(case, chunk):
    spec = SPECS[case]
    node = spec["num_nodes"] - 1
    want = list(jstream_chunks(JRelation(**spec), node, chunk))
    stats = {}
    got = list(stream_chunks(Relation(**spec), node, chunk, device="cpu",
                             num_threads=3, stats=stats))
    assert len(got) == len(want) == -(-(spec["global_size"]
                                        // spec["num_nodes"]) // chunk)
    for g, w in zip(got, want):
        for gl, wl in zip(_tlanes(g), _lanes(w)):
            assert (gl is None) == (wl is None)
            if gl is not None:
                np.testing.assert_array_equal(gl, wl)
        assert g.key.dtype == torch.int32
    assert len(stats["fill_ms"]) == len(stats["wait_ms"]) == len(got)
    assert "h2d_ms" not in stats                  # no card, no copy events


def test_stream_chunks_equals_shard_and_device_stream():
    rel = Relation(**SPECS["unique"])
    key, rid = np.concatenate([_tlanes(b)[0] for b in
                               stream_chunks(rel, 1, 1500, device="cpu")]), \
        np.concatenate([_tlanes(b)[1] for b in
                        stream_chunks(rel, 1, 1500, device="cpu")])
    ref_key, ref_rid = rel.shard_np(1)
    np.testing.assert_array_equal(key, ref_key)
    np.testing.assert_array_equal(rid, ref_rid)
    for h, d in zip(stream_chunks(rel, 0, 1500, device="cpu"),
                    stream_chunks_device(rel, 0, 1500, "cpu")):
        assert torch.equal(h.key, d.key) and torch.equal(h.rid, d.rid)
    assert tdata.stream_chunks is stream_chunks


def test_stream_bounded_pool_is_reused_and_left_open():
    rel = Relation(1 << 14, 1, "unique", seed=5)
    chunk = 1 << 10
    pool = Pool(pool_bytes(chunk))
    got = list(stream_chunks(rel, 0, chunk, pool=pool, device="cpu"))
    assert len(got) == 16
    assert pool.used() <= pool_bytes(chunk)      # only the two pairs
    assert pool.native                           # the caller's to close
    want = list(jstream_chunks(JRelation(1 << 14, 1, "unique", seed=5), 0,
                               chunk))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_tlanes(g)[0], _lanes(w)[0])
    pool.close()
    with pytest.raises(ValueError, match="chunk_tuples"):
        next(stream_chunks(rel, 0, 0, device="cpu"))


def test_buffer_reuse_under_a_slow_fill_thread(monkeypatch):
    """Chunks held by the consumer stay equal to ``shard_np``'s slices
    while the fill thread is slowed and every buffer is refilled twice."""
    rel = Relation(1 << 13, 1, "zipf", zipf_theta=0.75, seed=21)
    fill = Relation.fill_np
    threads = set()

    def slow_fill(self, *a, **kw):
        threads.add(threading.get_ident())
        time.sleep(0.01)
        return fill(self, *a, **kw)

    monkeypatch.setattr(Relation, "fill_np", slow_fill)
    held = list(stream_chunks(rel, 0, 1000, device="cpu"))
    assert threading.get_ident() not in threads   # filled off the consumer
    monkeypatch.setattr(Relation, "fill_np", fill)
    key, rid = rel.shard_np(0)
    for i, b in enumerate(held):
        np.testing.assert_array_equal(lane_to_numpy(b.key),
                                      key[i * 1000:(i + 1) * 1000])
        np.testing.assert_array_equal(lane_to_numpy(b.rid),
                                      rid[i * 1000:(i + 1) * 1000])


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_host_fed_grid_equals_oracle_and_jax(pipeline):
    size = 1 << 13
    specs = (dict(global_size=size, kind="unique", seed=1),
             dict(global_size=size, kind="zipf", zipf_theta=0.75, seed=2))
    want = jgrid(list(jstream_chunks(JRelation(**specs[0]), 0, 3000)),
                 lambda: jstream_chunks(JRelation(**specs[1]), 0, 1500),
                 slab_size=1024)
    r, s = Relation(**specs[0]), Relation(**specs[1])
    got = chunked.chunked_join_grid(
        stream_chunks(r, 0, 3000, device="cpu"),
        lambda: stream_chunks(s, 0, 1500, device="cpu"), 1024,
        pipeline=pipeline)
    assert got == want == size     # the outer keys lie in [0, size)


def test_host_fed_64bit_grid_equals_jax():
    spec = dict(global_size=1 << 12, kind="unique", key_bits=64)
    want = jgrid(list(jstream_chunks(JRelation(seed=1, **spec), 0, 1000)),
                 lambda: jstream_chunks(JRelation(seed=2, **spec), 0, 1500),
                 slab_size=512)
    got = chunked.chunked_join_grid(
        stream_chunks(Relation(seed=1, **spec), 0, 1000, device="cpu"),
        lambda: stream_chunks(Relation(seed=2, **spec), 0, 1500,
                              device="cpu"), 512, pipeline="on")
    assert got == want == 1 << 12


def test_stream_corrupt_lane_raises_as_in_jax():
    spec = dict(global_size=1 << 10, num_nodes=1, kind="unique", seed=5)
    with jfaults.FaultInjector() as jinj:
        jinj.arm(jfaults.STREAM_CORRUPT, at=1)
        jchunks = list(jstream_chunks(JRelation(**spec), 0, 1 << 10))
    with tfaults.FaultInjector() as inj:
        inj.arm(tfaults.STREAM_CORRUPT, at=1)
        chunks = list(stream_chunks(Relation(**spec), 0, 1 << 10,
                                    device="cpu"))
    assert inj.fired(tfaults.STREAM_CORRUPT) == jinj.fired(
        jfaults.STREAM_CORRUPT) == 1
    assert int(lane_to_numpy(chunks[0].key)[0]) == int(
        np.asarray(jchunks[0].key)[0]) == 0xFFFFFFFF
    clean = next(stream_chunks(Relation(**spec), 0, 1 << 10, device="cpu"))
    with pytest.raises(DataCorruption):
        chunked.chunked_join_grid([clean], [chunks[0]], 256)
    with pytest.raises(ValueError, match="key contract violation"):
        chunked.chunked_join_count(clean, chunks[0], 256, key_range="narrow")


def test_prefetcher_stages_the_chunk_itself():
    """The pipelined grid's stager hands the stream's own batch over: no
    second copy of a chunk already on the device."""
    rel = Relation(1 << 12, 1, "unique", seed=3)
    made = list(stream_chunks(rel, 0, 1000, device="cpu"))
    pf = chunked._Prefetcher(iter(made), 2, None, "outer")
    staged = list(pf)
    pf.close()
    assert [c for c, _ in staged] == made
    assert all(c is m for (c, _), m in zip(staged, made))
    assert [b for _, b in staged] == [int(lane_to_numpy(m.key).max())
                                      for m in made]


def test_pinned_private_pools_are_kept_for_the_next_stream(monkeypatch):
    """A finished stream's private pool, once pinned, is rewound and taken
    by the next stream of its size (at most ``MAX_CACHED_POOLS`` kept);
    an unpinned one is closed.  (Pinning needs the card: the flag is set
    by hand and dropped again before a pool is freed.)"""
    from tpu_radix_join_torch.data import streaming

    closed = []

    class Recorded(Pool):
        def close(self):
            if self._handle is not None:
                closed.append(id(self))
            self._pinned = False
            super().close()

    monkeypatch.setattr(streaming, "Pool", Recorded)
    monkeypatch.setattr(streaming, "_cached_pools", {})
    a, b, c = (streaming._take_pool(4096) for _ in range(3))
    for p in (a, b, c):
        p._pinned = True
    a.get_array((10,))
    for p in (a, b, c):
        streaming._give_back(p)
    assert closed == [id(c)]                     # two kept, one closed
    assert streaming._take_pool(4096) is b
    assert streaming._take_pool(4096) is a
    assert a.used() == 0                         # rewound
    other = streaming._take_pool(8192)
    assert other not in (a, b, c)
    unpinned = streaming._take_pool(4096)
    streaming._give_back(unpinned)
    assert closed[-1] == id(unpinned)
    streaming._give_back(a)
    streaming.release_staging_pools()
    assert closed[-1] == id(a) and streaming._cached_pools == {}
    for p in (b, other):
        p.close()
