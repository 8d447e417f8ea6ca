"""Tuple layout of the port: structure-of-arrays batches of uint32 lanes.

Counterpart of ``tpu_radix_join/data/tuples.py`` (``TupleBatch``,
``CompressedBatch``, the pad sentinels, ``_sentinel_lane``,
``partition_ids``, ``compress``, ``decompress``, ``probe_key``,
``pad_sentinel``, ``valid_mask``, ``make_padding_like``, ``make_padding``,
``effective_key_bits``) and the packed wire codec (``WireSpec``,
``make_wire_spec``, ``pack_blocks``, ``unpack_blocks``, ``data/tuples.py:
160-391``), whose words equal the JAX package's bit for bit.

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


# ------------------------------------------------------------- wire codec
#
# Block layout (uint32 words), one block per (sender, destination) pair, as
# in the JAX package:
#
#   [ header: 2**fanout_bits words — per-partition valid counts ]
#   [ payload: ceil(capacity * tuple_bits / 32) + 1 words        ]
#
# The payload is a little-endian bitstream: slot ``s`` occupies bits
# ``[s*T, (s+1)*T)`` with ``T = key_rem_bits + rid_bits``, ``key_rem`` (the
# key with its fanout bits dropped) at offset 0 and ``rid`` after it.  A
# block's valid tuples sit at its front sorted by partition id, so the
# header counts give every slot its pid back, and their sum is the count
# the fused exchange ships in a second collective.  Slots at or past a
# block's count unpack to the side's pad sentinels.


class WireSpec(NamedTuple):
    """Static geometry of the packed exchange."""

    fanout_bits: int        # radix bits dropped from keys (pid width)
    num_sub: int            # 2**fanout_bits — header words per block
    capacity: int           # tuple slots per block
    wide: bool              # 64-bit keys (key_hi lane present)
    key_rem_bits: int       # bits kept per key after dropping fanout bits
    rid_bits: int           # bits per rid
    tuple_bits: int         # key_rem_bits + rid_bits
    header_words: int       # == num_sub
    payload_words: int      # bitstream words incl. the spill-guard word
    block_words: int        # header_words + payload_words

    @property
    def bytes_per_block(self) -> int:
        return 4 * self.block_words

    @property
    def bytes_per_tuple(self) -> float:
        """Wire bytes per tuple slot (header amortized over the block)."""
        return self.bytes_per_block / self.capacity


def make_wire_spec(capacity: int, fanout_bits: int, wide: bool = False,
                   key_bound: Optional[int] = None,
                   rid_bound: Optional[int] = None) -> WireSpec:
    """The packed-block geometry from exclusive bounds on the keys and
    rids; ``None`` is the full lane width."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    kb = effective_key_bits(key_bound, fanout_bits, 64 if wide else 32)
    if rid_bound is None:
        rb = 32
    else:
        if rid_bound < 1:
            raise ValueError(f"rid_bound must be >= 1, got {rid_bound}")
        rb = min(32, max(1, (int(rid_bound) - 1).bit_length()))
    t = kb + rb
    num_sub = 1 << fanout_bits
    # +1 spill-guard word: the last slot's high field may cross one word
    # past ceil(capacity * T / 32)
    payload = (capacity * t + 31) // 32 + 1
    return WireSpec(fanout_bits=fanout_bits, num_sub=num_sub,
                    capacity=capacity, wide=wide, key_rem_bits=kb,
                    rid_bits=rb, tuple_bits=t, header_words=num_sub,
                    payload_words=payload, block_words=num_sub + payload)


def _width_mask(width: int) -> int:
    return U32_MASK if width >= 32 else (1 << width) - 1


def _wire_fields(spec: WireSpec):
    """(offset in the tuple, width, lane) triples: lane 0 the key
    remainder's low 32 bits, lane 1 its high bits (wide keys only), lane 2
    the rid.  Every field is at most 32 bits wide."""
    kb = spec.key_rem_bits
    fields = [(0, kb, 0)] if kb <= 32 else [(0, 32, 0), (32, kb - 32, 1)]
    fields.append((kb, spec.rid_bits, 2))
    return fields


def _slot_geometry(spec: WireSpec, nb: int, device):
    """int64 (slot within its block, the block's first payload word) of
    every slot of ``nb`` blocks."""
    slot = torch.arange(nb * spec.capacity, dtype=torch.int64, device=device)
    s_in_blk = slot % spec.capacity
    base = (slot // spec.capacity) * spec.block_words + spec.header_words
    return s_in_blk, base


def _header_index(spec: WireSpec, nb: int, device) -> torch.Tensor:
    """int64 [nb, num_sub]: the word of each block's header entry."""
    return (torch.arange(nb, dtype=torch.int64, device=device)[:, None]
            * spec.block_words
            + torch.arange(spec.num_sub, dtype=torch.int64,
                           device=device)[None, :])


def pack_blocks(spec: WireSpec, blocks: TupleBatch,
                group_counts: torch.Tensor) -> torch.Tensor:
    """Pack scattered blocks into the wire words (``pack_blocks``,
    ``data/tuples.py:275-327``).

    ``blocks``: [num_blocks * capacity] lanes, each block's valid tuples
    at its front sorted by partition id (``ops/radix.
    scatter_to_blocks_grouped``); ``group_counts``: [num_blocks, num_sub]
    clipped per-(block, pid) counts.  Returns an int32 lane [num_blocks *
    block_words] of uint32 words.  JAX's scatter-add stands in for an OR
    because the fields' bit ranges are disjoint; here the words accumulate
    in int64 (``index_add_``, exact on every device) and keep their low 32
    bits.  A field shifted by ``boff`` spills its top ``boff`` bits into
    the next word; with ``boff == 0`` the spill is 0."""
    nb = group_counts.shape[0]
    dev = blocks.key.device
    gc = widen(group_counts.reshape(nb, spec.num_sub))
    s_in_blk, base = _slot_geometry(spec, nb, dev)
    ok = s_in_blk < gc.sum(dim=1).repeat_interleave(spec.capacity)
    f = spec.fanout_bits
    key = widen(blocks.key)
    if spec.wide:
        hi_full = widen(blocks.key_hi)
        lo = ((key >> f) | (hi_full << (32 - f))) & U32_MASK if f else key
        hi = hi_full >> f
    else:
        lo, hi = key >> f, None
    lanes = (lo, hi, widen(blocks.rid))
    words = torch.zeros(nb * spec.block_words, dtype=torch.int64, device=dev)
    words.index_add_(0, _header_index(spec, nb, dev).reshape(-1),
                     gc.reshape(-1))
    for off, width, lane_i in _wire_fields(spec):
        v = torch.where(ok, lanes[lane_i] & _width_mask(width), 0)
        bitpos = s_in_blk * spec.tuple_bits + off
        widx = base + bitpos // 32
        shifted = v << (bitpos % 32)          # < 2**63: v < 2**32, boff < 32
        words.index_add_(0, widx, shifted & U32_MASK)
        words.index_add_(0, widx + 1, shifted >> 32)
    return narrow(words)


def unpack_blocks(spec: WireSpec, words: torch.Tensor, side: str):
    """Exact inverse of :func:`pack_blocks` on received words
    (``unpack_blocks``, ``data/tuples.py:330-391``): (TupleBatch with
    [num_blocks * capacity] lanes, int32 lane [num_blocks] of the valid
    counts).  A valid slot's pid is the first partition whose cumulative
    header count passes the slot (a batched ``searchsorted``, clamped to
    ``num_sub - 1``); slots at or past a block's count hold the side's pad
    sentinels and ``PAD_RID``."""
    if words.shape[0] % spec.block_words:
        raise ValueError(
            f"wire buffer of {words.shape[0]} words is not a multiple of "
            f"block_words={spec.block_words}")
    nb = words.shape[0] // spec.block_words
    cap, f = spec.capacity, spec.fanout_bits
    dev = words.device
    w = widen(words)
    gc = w[_header_index(spec, nb, dev)]                      # [nb, P]
    counts = gc.sum(dim=1)
    slot_in_blk = torch.arange(cap, dtype=torch.int64,
                               device=dev).expand(nb, cap).contiguous()
    pid = torch.searchsorted(torch.cumsum(gc, dim=1), slot_in_blk,
                             right=True)
    pid = torch.clamp(pid, max=spec.num_sub - 1).reshape(-1)
    s_in_blk, base = _slot_geometry(spec, nb, dev)
    ok = s_in_blk < counts.repeat_interleave(cap)
    last = words.shape[0] - 1
    lanes = [None, None, None]
    for off, width, lane_i in _wire_fields(spec):
        bitpos = s_in_blk * spec.tuple_bits + off
        widx = base + bitpos // 32
        # the field's two candidate words as one 64-bit value: the
        # arithmetic shift is exact on every bit at or below 62, and the
        # field ends at bit boff + width <= 63
        pair = w[widx] | (w[torch.clamp(widx + 1, max=last)] << 32)
        lanes[lane_i] = (pair >> (bitpos % 32)) & _width_mask(width)
    lo, hi, rid = lanes
    sent = pad_sentinel(side)
    if spec.wide:
        hi = torch.zeros_like(lo) if hi is None else hi
        if f:
            key = (lo << f) | pid
            key_hi = (hi << f) | (lo >> (32 - f))
        else:
            key, key_hi = lo, hi
        key_hi = narrow(torch.where(ok, key_hi, sent))
    else:
        key = (lo << f) | pid if f else lo
        key_hi = None
    return (TupleBatch(key=narrow(torch.where(ok, key, sent)),
                       rid=narrow(torch.where(ok, rid, PAD_RID)),
                       key_hi=key_hi), narrow(counts))
