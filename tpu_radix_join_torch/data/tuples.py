"""Tuple layout of the port: structure-of-arrays batches of uint32 lanes.

Counterpart of ``tpu_radix_join/data/tuples.py`` (``TupleBatch``,
``CompressedBatch``, the pad sentinels, ``_sentinel_lane``,
``partition_ids``, ``compress``, ``decompress``, ``probe_key``,
``pad_sentinel``, ``valid_mask``, ``make_padding_like``, ``make_padding``,
``effective_key_bits``).  The wire codec (``WireSpec``, ``pack_blocks``,
``unpack_blocks``) is ROADMAP A13.

**Lane dtype.**  A lane is a 1-D ``torch.int32`` tensor that holds the uint32
bit pattern of each value: 4 bytes a lane, as on the TPU, and the CUDA
kernels reinterpret it as ``uint32_t*``.  PyTorch's uint32 lacks shifts,
additions, comparisons, ``bincount``, ``searchsorted`` and ``max`` on the
CPU, and signed int32 order is wrong for uint32 values (with fanout 5 every
partition id >= 16 sets bit 31 of a packed value).  So plain PyTorch code
widens a lane with :func:`widen` (int64 in [0, 2**32)) before any shift,
compare, add, sum or sort, and stores results back with :func:`narrow`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Sentinel key values for padded (invalid) slots, per relation side.
R_PAD_KEY = 0xFFFFFFFE   # inner/build side
S_PAD_KEY = 0xFFFFFFFF   # outer/probe side
PAD_RID = 0xFFFFFFFF

U32_MASK = 0xFFFFFFFF


def widen(lane: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) of a uint32 lane (int32 bit patterns)."""
    return lane.to(torch.int64) & U32_MASK


def narrow(values: torch.Tensor) -> torch.Tensor:
    """The int32 lane holding the low 32 bits of int64 ``values``."""
    return (((values & U32_MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def lane_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A uint32 numpy array as a lane on ``device`` (bits unchanged)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def lane_to_numpy(lane: torch.Tensor) -> np.ndarray:
    """A lane as a uint32 numpy array (bits unchanged)."""
    return lane.detach().cpu().contiguous().numpy().view(np.uint32)


def umax(lane: torch.Tensor) -> torch.Tensor:
    """0-d int64: the largest uint32 value of an int32 lane (0 if empty).
    Flipping the sign bit makes signed order the unsigned one (``max`` of
    the int32 lane itself is a signed max, which misreads keys >= 2**31)."""
    if lane.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=lane.device)
    return torch.bitwise_xor(lane, -(1 << 31)).max().to(torch.int64) + (1 << 31)


def check_lane(x: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` is a contiguous 1-D int32 lane."""
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            f"{what} wants a contiguous 1-D int32 lane (uint32 bits), got "
            f"{x.dtype} rank {x.dim()} contiguous={x.is_contiguous()}")


class TupleBatch(NamedTuple):
    """SoA batch of full tuples (analog of ``Tuple[]``, data/Tuple.h)."""

    key: torch.Tensor                       # int32 lane [n] — low 32 key bits
    rid: torch.Tensor                       # int32 lane [n]
    key_hi: Optional[torch.Tensor] = None   # upper key lane (64-bit keys)

    @property
    def size(self) -> int:
        return self.key.shape[-1]


class CompressedBatch(NamedTuple):
    """SoA batch of compressed tuples (analog of ``CompressedTuple[]``):
    ``key_rem`` holds ``key >> network_fanout_bits``, the key bits the
    probe compares (BuildProbe.cpp:98-106); ``key_rem_hi`` the upper lane
    of 64-bit keys."""

    key_rem: torch.Tensor                       # int32 lane [n]
    rid: torch.Tensor                           # int32 lane [n]
    key_rem_hi: Optional[torch.Tensor] = None   # int32 lane [n]

    @property
    def size(self) -> int:
        return self.key_rem.shape[-1]


# TupleBatch and CompressedBatch keep the JAX package's positional layout:
# field 0 = primary key lane, field 1 = rid, field 2 = optional high key lane.
def _sentinel_lane(batch) -> torch.Tensor:
    return batch[2] if batch[2] is not None else batch[0]


def partition_ids(batch: TupleBatch, fanout_bits: int) -> torch.Tensor:
    """Radix partition id = low ``fanout_bits`` of the key
    (LocalHistogram.cpp:20,44-47): an int32 lane of values in
    [0, 1 << fanout_bits)."""
    return torch.bitwise_and(batch.key, (1 << fanout_bits) - 1)


def _shr(lane: torch.Tensor, bits: int) -> torch.Tensor:
    """Logical right shift of a uint32 lane (``>>`` on int32 is
    arithmetic, so the shifted-in sign bits are masked)."""
    if not bits:
        return lane
    return (lane >> bits) & ((1 << (32 - bits)) - 1)


def _shl(lane: torch.Tensor, bits: int) -> torch.Tensor:
    """Left shift of a uint32 lane; the bits shifted out are masked off
    first, so no int32 product overflows."""
    if not bits:
        return lane
    return (lane & ((1 << (32 - bits)) - 1)) << bits


def compress(batch: TupleBatch, fanout_bits: int) -> CompressedBatch:
    """Drop the partition bits from the key (NetworkPartitioning.cpp:
    128-129); :func:`decompress` restores them from the partition id.  A
    64-bit key shifts across both lanes."""
    f = fanout_bits
    if batch.key_hi is None:
        return CompressedBatch(key_rem=_shr(batch.key, f), rid=batch.rid)
    if f == 0:
        return CompressedBatch(batch.key, batch.rid, batch.key_hi)
    lo = _shr(batch.key, f) | _shl(batch.key_hi, 32 - f)
    return CompressedBatch(key_rem=lo, rid=batch.rid,
                           key_rem_hi=_shr(batch.key_hi, f))


def decompress(comp: CompressedBatch, pid: torch.Tensor,
               fanout_bits: int) -> TupleBatch:
    """Full keys from remainder and partition id (inverse of
    :func:`compress`)."""
    f = fanout_bits
    pid = pid.to(torch.int32)
    if comp.key_rem_hi is None:
        return TupleBatch(key=_shl(comp.key_rem, f) | pid, rid=comp.rid)
    if f == 0:
        return TupleBatch(comp.key_rem, comp.rid, comp.key_rem_hi)
    lo = _shl(comp.key_rem, f) | pid
    hi = _shl(comp.key_rem_hi, f) | _shr(comp.key_rem, 32 - f)
    return TupleBatch(key=lo, rid=comp.rid, key_hi=hi)


def probe_key(comp: CompressedBatch) -> torch.Tensor:
    """The key material the probe compares (``value >> keyShift``,
    BuildProbe.cpp:98-106): the remainder lane, or for 64-bit keys a
    [n, 2] (hi, lo) stack whose lexicographic order is the numeric one."""
    if comp.key_rem_hi is None:
        return comp.key_rem
    return torch.stack([comp.key_rem_hi, comp.key_rem], dim=-1)


def pad_sentinel(side: str) -> int:
    """The uint32 key of a padding slot on ``side``."""
    if side == "inner":
        return R_PAD_KEY
    if side == "outer":
        return S_PAD_KEY
    raise ValueError(f"side must be 'inner' or 'outer', got {side!r}")


def valid_mask(batch, side: str) -> torch.Tensor:
    """True for real tuples, False for padding slots."""
    return _sentinel_lane(batch) != int(narrow(torch.tensor(pad_sentinel(side))))


def make_padding_like(batch, n: int, side: str):
    """A block of n invalid tuples with the same structure as ``batch``."""
    dev = batch[0].device
    sent = narrow(torch.full((n,), pad_sentinel(side), dtype=torch.int64,
                             device=dev))
    rid = narrow(torch.full((n,), PAD_RID, dtype=torch.int64, device=dev))
    return type(batch)(sent, rid, sent if batch[2] is not None else None)


def make_padding(n: int, side: str, wide: bool = False,
                 device="cpu") -> CompressedBatch:
    """A block of n invalid compressed tuples; ``wide`` pads both key lanes
    with the sentinel (0x00000000_FFFFFFFF would be a real 64-bit key)."""
    sent = narrow(torch.full((n,), pad_sentinel(side), dtype=torch.int64,
                             device=device))
    rid = narrow(torch.full((n,), PAD_RID, dtype=torch.int64, device=device))
    return CompressedBatch(key_rem=sent, rid=rid,
                           key_rem_hi=sent if wide else None)


def effective_key_bits(key_bound: Optional[int], fanout_bits: int = 0,
                       key_bits: int = 32) -> int:
    """Bits a key can occupy given its exclusive upper bound ``key_bound``
    (None = the full lane width), after the caller dropped ``fanout_bits``
    partition bits.  The radix sort skips the digit passes this proves
    constant: a 16-bit-bounded key needs 2 of the 4 uint32 passes."""
    if not 0 <= fanout_bits < key_bits:
        raise ValueError(
            f"fanout_bits must be in [0, {key_bits}), got {fanout_bits}")
    if key_bound is None:
        return key_bits - fanout_bits
    if key_bound < 1:
        raise ValueError(f"key_bound must be >= 1, got {key_bound}")
    kb = max(1, ((int(key_bound) - 1) >> fanout_bits).bit_length())
    return min(kb, key_bits - fanout_bits)
