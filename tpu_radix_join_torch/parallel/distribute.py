"""Pre-join redistribution: the ``Relation::distribute`` analog.

Counterpart of ``tpu_radix_join/parallel/distribute.py``.  The reference's
pre-shuffle (``data/Relation.cpp:99-141``) swaps equal sections pairwise
over ``MPI_Send/Recv`` so each rank ends up with a slice of the whole key
space, then shuffles locally.  Here, as in the JAX package, the section
exchange is one all_to_all of every lane over the world (block ``j`` of
every rank lands on rank ``j``; ``DistWorld.all_to_all``), and the local
shuffle is a key-value sort (K2) by a seeded hash of each slot.  The hash
is a bijection on uint32, so its keys are distinct and the order is the
same whichever sort ran: the result equals the JAX function's bit for bit,
in the fused and the staged exchange alike.
"""

from __future__ import annotations

import torch

from tpu_radix_join_torch.data.tuples import TupleBatch, narrow
from tpu_radix_join_torch.ops.sorting import sort_kv_unstable
from tpu_radix_join_torch.parallel.window import block_all_to_all
from tpu_radix_join_torch.utils.hashing import mul32

_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finalizer of the JAX ``_mix32``, on int64 values
    in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def shuffle_keys(n: int, rank: int, seed: int, device) -> torch.Tensor:
    """The local shuffle's sort keys, int32 lane of uint32 bits:
    ``mix32(arange(n) ^ mix32(rank + seed * 0x9E3779B9))`` in uint32
    arithmetic."""
    salt = _mix32(torch.tensor((rank + seed * _GOLDEN) & _U32,
                               dtype=torch.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return narrow(_mix32(idx ^ int(salt)))


def distribute(batch: TupleBatch, world, seed: int = 0,
               mode: str = "fused", sort_impl: str = "auto") -> TupleBatch:
    """Redistribute so every rank holds a uniform slice of the whole data:
    this rank's shard is cut into ``world.size`` equal blocks, block ``j``
    travels to rank ``j`` with every lane (``key_hi`` included), and the
    received tuples are sorted by :func:`shuffle_keys`.  ``world`` is the
    engine's world (``HashJoin.world``); every rank must call it.  The
    shard's size must divide by ``world.size`` (the reference's equal
    sections, ``Relation.cpp:106``).  ``mode`` is the staged-exchange knob
    ("fused" | "staged:<k>" | "auto" | k, ``window.block_all_to_all``):
    redistribution moves the whole relation at once, so it gains first from
    bounding the live exchange buffer to about 1/k.  The received tuples
    are the same in every mode.  ``sort_impl`` is the sort's arm
    (``ops/sorting``)."""
    n = batch.size
    if n % world.size != 0:
        raise ValueError(f"local size {n} must divide by {world.size} nodes")
    block = n // world.size
    received = [None if lane is None
                else block_all_to_all(world, lane, block, mode)
                for lane in batch]
    h = shuffle_keys(n, world.rank, seed, batch.key.device)
    out = sort_kv_unstable(h, *[lane for lane in received if lane is not None],
                           impl=sort_impl)
    return TupleBatch(key=out[1], rid=out[2],
                      key_hi=out[3] if batch.key_hi is not None else None)
