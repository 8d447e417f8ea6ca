"""Chunked relation streams: fed from the host, or generated on the device.

The port's ``tpu_radix_join/data/streaming.py``: one node's shard as
``TupleBatch`` chunks of ``chunk_tuples`` (the last may be short),
bit-identical to the JAX package's for the same relation.  They feed
``ops/chunked.chunked_join_grid``.

  * :func:`stream_chunks` (``:50-104``) is the host-fed stream, the CUDA
    form of hpcjoin's large-data path (pinned host staging, H2D copies
    that overlap compute, ``small_data.cu:85-159``): two (key, rid) buffer
    pairs from one page-locked ``memory.Pool`` region, filled by the
    native generators (``Relation.fill_np``) on a one-thread executor
    while the previous chunk is copied; each copy is ``non_blocking`` on
    a side stream, and the consumer's stream waits on its event, so the
    chunk's device lanes are ready in stream order without a host sync.
    A buffer is refilled only after the event of the copy that last read
    it has completed (the JAX package's ``copy=True`` plus
    ``block_until_ready`` fence, ``:86-94``).  Page-locking a pool costs
    about 0.45 s a 512 MiB on the card's host (``chip_smoke.py`` (x1)), so
    a finished stream's private pool stays pinned and the next stream of
    its size takes it (at most :data:`MAX_CACHED_POOLS` kept;
    :func:`release_staging_pools` frees them), as PyTorch's caching host
    allocator keeps pinned blocks.
  * :func:`stream_chunks_device` (``:107-137``) computes each chunk on
    the device from its global index range (``Relation.keys_range``), so
    the host materialises and transfers nothing.

64-bit relations add the hi lane, a function of the lo lane computed on
the device.  ``_maybe_corrupt`` (``:39-47``) is the ``stream.corrupt_lane``
fault site of both.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tpu_radix_join_torch.core.device import resolve_device
from tpu_radix_join_torch.data.relation import Relation, key_hi_lane
from tpu_radix_join_torch.data.tuples import (S_PAD_KEY, TupleBatch, narrow,
                                              widen)
from tpu_radix_join_torch.memory.pool import Pool
from tpu_radix_join_torch.robustness import faults as _faults


def _maybe_corrupt(key: torch.Tensor) -> torch.Tensor:
    """Fault site ``stream.corrupt_lane``: when armed, set the chunk's first
    key to the reserved sentinel 0xFFFFFFFF, the damage a flipped bit or a
    torn read would do; the grid's key-contract checks must catch it."""
    if _faults.fires(_faults.STREAM_CORRUPT):
        key = key.clone()
        key[0] = int(narrow(torch.tensor(S_PAD_KEY)))
    return key


#: pinned private pools of finished streams kept for the next streams
MAX_CACHED_POOLS = 2
_cached_pools: Dict[int, List[Pool]] = {}
_cache_lock = threading.Lock()


def _take_pool(nbytes: int) -> Pool:
    """A private pool of ``nbytes``: a cached pinned one, rewound, else a
    new one."""
    with _cache_lock:
        free = _cached_pools.get(nbytes)
        pool = free.pop() if free else None
    if pool is None:
        return Pool(nbytes)
    pool.reset()
    return pool


def _give_back(pool: Pool) -> None:
    """Keep a pinned private pool for the next stream (up to
    :data:`MAX_CACHED_POOLS`), else close it."""
    if pool.pinned:
        with _cache_lock:
            if sum(map(len, _cached_pools.values())) < MAX_CACHED_POOLS:
                _cached_pools.setdefault(pool.capacity, []).append(pool)
                return
    pool.close()


def release_staging_pools() -> None:
    """Unpin and free the cached pools of finished streams."""
    with _cache_lock:
        pools = [p for free in _cached_pools.values() for p in free]
        _cached_pools.clear()
    for pool in pools:
        pool.close()


def pool_bytes(chunk_tuples: int) -> int:
    """Bytes a pool needs for :func:`stream_chunks`' four buffers of
    ``chunk_tuples`` uint32 each, with the 64-byte alignment headroom."""
    return 2 * 2 * chunk_tuples * 4 + 4 * 64


def stream_chunks(rel: Relation, node: int, chunk_tuples: int,
                  pool: Optional[Pool] = None, num_threads: int = 0,
                  device="cuda", stats: Optional[dict] = None
                  ) -> Iterator[TupleBatch]:
    """Yield node ``node``'s shard of ``rel`` as chunks of
    ``chunk_tuples`` on ``device`` (cuda unless the caller asks for cpu),
    generated on the host with double-buffered prefetch.

    ``pool``: a ``memory.Pool`` to draw the four chunk buffers from (at
    least :func:`pool_bytes` bytes; on the card it is pinned); default a
    private pool of exactly that, which on the card stays pinned for the
    next stream when this one ends (see the module docstring).
    ``num_threads`` is the native generators' thread count (0: one a core,
    up to 16).  ``stats``, when given, receives lists ``fill_ms`` (each
    chunk's host fill), ``wait_ms`` (the consumer's wait for it, so the
    fill time not hidden under the previous chunk) and, on the card,
    ``h2d_ms`` (each chunk's two copies, by CUDA events on the side
    stream)."""
    if chunk_tuples < 1:
        raise ValueError("chunk_tuples must be >= 1")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    local = rel.local_size
    base = node * local
    num_chunks = -(-local // chunk_tuples)
    own_pool = pool is None
    if own_pool:
        pool = _take_pool(pool_bytes(chunk_tuples))
    if cuda:
        pool.pin()
    bufs = [(pool.get_array((chunk_tuples,)), pool.get_array((chunk_tuples,)))
            for _ in range(2)]
    copied = [None, None]      # the event of the copy that last read a pair
    copy_events = []           # (begin, done) of each copy, when timed
    side = torch.cuda.Stream(dev) if cuda else None
    if stats is not None:
        for k in ("fill_ms", "wait_ms") + (("h2d_ms",) if cuda else ()):
            stats.setdefault(k, [])

    def fill(i: int) -> int:
        start = base + i * chunk_tuples
        n = min(chunk_tuples, base + local - start)
        if copied[i % 2] is not None:
            copied[i % 2].synchronize()   # its last copy has read it
        key_buf, rid_buf = bufs[i % 2]
        t0 = time.perf_counter()
        rel.fill_np(start, n, num_threads=num_threads,
                    out_key=key_buf[:n], out_rid=rid_buf[:n])
        if stats is not None:
            stats["fill_ms"].append((time.perf_counter() - t0) * 1e3)
        return n

    def to_device(host: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(host.view(np.int32))
        if not cuda:
            return src.clone()     # independent of the buffer before refill
        out = torch.empty(src.shape, dtype=torch.int32, device=dev)
        out.copy_(src, non_blocking=True)
        return out

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(fill, 0)
        for i in range(num_chunks):
            t0 = time.perf_counter()
            n = fut.result()
            if stats is not None:
                stats["wait_ms"].append((time.perf_counter() - t0) * 1e3)
            key_buf, rid_buf = bufs[i % 2]
            if not cuda:
                key, rid = to_device(key_buf[:n]), to_device(rid_buf[:n])
            else:
                consumer = torch.cuda.current_stream(dev)
                timed = stats is not None
                begin = torch.cuda.Event(enable_timing=timed)
                done = torch.cuda.Event(enable_timing=timed)
                # the lanes are the side stream's allocations; after
                # record_stream the allocator reuses them only once the
                # consumer's work on them is done
                with torch.cuda.stream(side):
                    begin.record(side)
                    key, rid = to_device(key_buf[:n]), to_device(rid_buf[:n])
                    done.record(side)
                copied[i % 2] = done
                consumer.wait_event(done)
                key.record_stream(consumer)
                rid.record_stream(consumer)
                if timed:
                    copy_events.append((begin, done))
            if i + 1 < num_chunks:
                # fill(i + 1) writes the other pair, once its last copy
                # (chunk i - 1) has completed: generation overlaps this
                # chunk's copy and the consumer's work on it
                fut = ex.submit(fill, i + 1)
            hi = (narrow(key_hi_lane(widen(key))) if rel.key_bits == 64
                  else None)
            yield TupleBatch(key=_maybe_corrupt(key), rid=rid, key_hi=hi)
    finally:
        ex.shutdown(wait=True)
        for ev in copied:
            if ev is not None:
                ev.synchronize()    # no copy still reads the region
        if copy_events:
            stats["h2d_ms"].extend(b.elapsed_time(e) for b, e in copy_events)
        if own_pool:
            _give_back(pool)


def stream_chunks_device(rel: Relation, node: int, chunk_tuples: int,
                         device="cuda") -> Iterator[TupleBatch]:
    """Yield node ``node``'s shard of ``rel`` as chunks of ``chunk_tuples``
    generated on ``device`` (cuda unless the caller asks for cpu)."""
    if chunk_tuples < 1:
        raise ValueError("chunk_tuples must be >= 1")
    dev = resolve_device(device)
    local = rel.local_size
    base = node * local
    for start in range(base, base + local, chunk_tuples):
        n = min(chunk_tuples, base + local - start)
        key = rel.keys_range(start, n, dev)
        rid = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        hi = narrow(key_hi_lane(key)) if rel.key_bits == 64 else None
        yield TupleBatch(key=_maybe_corrupt(narrow(key)), rid=narrow(rid),
                         key_hi=hi)
