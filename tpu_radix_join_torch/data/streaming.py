"""Chunked relation streams generated on the device.

The port's ``stream_chunks_device`` and ``_maybe_corrupt`` of
``tpu_radix_join/data/streaming.py`` (``:39-47``, ``:107-137``): one node's
shard as ``TupleBatch`` chunks of ``chunk_tuples`` (the last may be short),
each computed on the device from its global index range with
``Relation.keys_range``, so the host materialises and transfers nothing.
Chunks are bit-identical to the JAX package's: unique keys walk the same
Feistel permutation, modulo keys are ``rid % modulo``, Zipf keys come from
the same integer tables, and 64-bit relations add the hi lane of each key.
They feed ``ops/chunked.chunked_join_grid``.  The host-pool stream
(``stream_chunks``) waits for the pool allocator (ROADMAP A18).
"""

from __future__ import annotations

from typing import Iterator

import torch

from tpu_radix_join_torch.core.device import resolve_device
from tpu_radix_join_torch.data.relation import Relation, key_hi_lane
from tpu_radix_join_torch.data.tuples import S_PAD_KEY, TupleBatch, narrow
from tpu_radix_join_torch.robustness import faults as _faults


def _maybe_corrupt(key: torch.Tensor) -> torch.Tensor:
    """Fault site ``stream.corrupt_lane``: when armed, set the chunk's first
    key to the reserved sentinel 0xFFFFFFFF, the damage a flipped bit or a
    torn read would do; the grid's key-contract checks must catch it."""
    if _faults.fires(_faults.STREAM_CORRUPT):
        key = key.clone()
        key[0] = int(narrow(torch.tensor(S_PAD_KEY)))
    return key


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
