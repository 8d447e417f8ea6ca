"""K3: fused merge-weight scan — ``csrc/merge_scan.cu`` and its plain version.

Counterpart of ``tpu_radix_join/ops/pallas/merge_scan.py::
merge_scan_partitions``: per-partition uint32 match counts and the largest
single weight over a sorted partition-major packed union (see
``ops/merge_count._pack_pm``).  Unlike the TPU kernel it takes any length:
the tile multiple was Mosaic's requirement.  Up to :data:`NARROW_FANOUT_BITS`
the card's shared bins hold every partition (launches counted as
``merge_scan``); past them the same kernel bins relative to each tile's
first partition (counted as ``merge_scan_fanout``), up to
:data:`MAX_FANOUT_BITS`, the partition id's bits in the kernel's word.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from tpu_radix_join_torch.data.tuples import U32_MASK, check_lane, narrow, widen
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check

NARROW_FANOUT_BITS = 7   # 128 partitions: the kernel's shared bins
MAX_FANOUT_BITS = 30     # pid << 2 | run start << 1 | side in 32 bits
#: positions a tile of the card's kernel holds (kTile in
#: csrc/merge_scan_partitions.cuh, shared with K5)
SCAN_TILE = 256 * 39
#: bytes of one look-back word (a 2-bit flag, R and B + 1 in 31 bits each)
LOOKBACK_WORD_BYTES = 8


def _run_weights(is_s: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """Per-position match weights of a sorted sequence: at every S position
    the number of R tuples in its equal-key run.  ``is_s``: int64 0/1 side
    tags in sort order (R before S within a run); ``run_start``: bool, True
    where a new equal-key run begins.  int64 throughout, so nothing wraps."""
    is_r = 1 - is_s
    c_r = torch.cumsum(is_r, 0)
    # c_r before the run start, carried across the run by cummax (c_r is
    # non-decreasing, so the cummax of the starts is exact)
    base_at_start = torch.where(run_start, c_r - is_r, torch.zeros_like(c_r))
    base_run = torch.cummax(base_at_start, 0).values
    return is_s * (c_r - base_run)


def _weights(packed_sorted: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 weight per position, int64 key per position) of a sorted
    packed lane."""
    p = widen(packed_sorted)
    key = p >> 1
    is_s = p & 1
    prev_key = torch.cat([key.new_full((1,), U32_MASK), key[:-1]])
    return _run_weights(is_s, key != prev_key), key


def scan_fanout_bits(num_partitions: int, length: int) -> int:
    """log2 of ``num_partitions`` for a merge scan of ``length`` positions;
    raises unless the partitions are a power of two whose id fits the
    kernels' word and the positions count in 32 bits."""
    if num_partitions < 1 or num_partitions & (num_partitions - 1):
        raise ValueError("num_partitions must be a power of two")
    fanout_bits = num_partitions.bit_length() - 1
    if fanout_bits > MAX_FANOUT_BITS:
        raise ValueError(f"num_partitions {num_partitions} > "
                         f"{1 << MAX_FANOUT_BITS}")
    if length >= 1 << 31:
        raise ValueError("the merge scan counts in 32 bits: length must "
                         "stay below 2**31")
    return fanout_bits


def merge_scan_plain(packed_sorted: torch.Tensor, fanout_bits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3: int64 cumsum/cummax weights, an integer per-partition sum,
    then the low 32 bits (the kernel's wrap)."""
    weight, _ = _weights(packed_sorted)
    if fanout_bits:
        pid = widen(packed_sorted) >> (32 - fanout_bits)
    else:
        pid = torch.zeros_like(weight)
    counts = torch.zeros(1 << fanout_bits, dtype=torch.int64,
                         device=packed_sorted.device)
    counts.index_add_(0, pid, weight)
    maxw = weight.max() if weight.numel() else weight.new_zeros(())
    return narrow(counts), narrow(maxw)


class ScratchLayout(NamedTuple):
    """The one scratch block of a K3 or K5 call over ``m`` positions, zeroed
    by one memset, in int32 words: the look-back table (``tiles`` words of
    ``word_bytes``), the tile counter, the max weight and the ``bins``
    partition counts."""

    tiles: int
    lookback_words: int
    word_bytes: int
    bins: int

    @property
    def counter_offset(self) -> int:
        return self.lookback_words * self.word_bytes // 4

    @property
    def max_offset(self) -> int:
        return self.counter_offset + 1

    @property
    def counts_offset(self) -> int:
        return self.counter_offset + 2

    @property
    def words(self) -> int:
        return self.counts_offset + self.bins

    @property
    def bytes(self) -> int:
        return 4 * self.words


def scratch_layout(m: int, fanout_bits: int) -> ScratchLayout:
    """The scratch of K3 (and K5) over ``m`` positions and ``2**fanout_bits``
    partitions: one tile per :data:`SCAN_TILE` positions, one look-back word
    a tile.  The C entry refuses any other size."""
    if not 0 <= m < 1 << 31 or not 0 <= fanout_bits <= MAX_FANOUT_BITS:
        raise ValueError(f"the merge scan takes 0 <= m < 2**31 and 0 <= "
                         f"fanout_bits <= {MAX_FANOUT_BITS}, got {m}, "
                         f"{fanout_bits}")
    tiles = -(-m // SCAN_TILE)
    return ScratchLayout(tiles=tiles, lookback_words=tiles,
                         word_bytes=LOOKBACK_WORD_BYTES,
                         bins=1 << fanout_bits)


def _merge_scan_cuda(packed_sorted: torch.Tensor, fanout_bits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = packed_sorted.numel()
    lay = scratch_layout(m, fanout_bits)
    fn = c_function("merge_scan", "rj_merge_scan",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    dev = packed_sorted.device
    scratch = torch.empty(lay.words, dtype=torch.int32, device=dev)
    err = fn(packed_sorted.data_ptr(), m, fanout_bits, scratch.data_ptr(),
             lay.bytes, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "merge scan kernel")
    LAUNCHES["merge_scan_fanout" if fanout_bits > NARROW_FANOUT_BITS
             else "merge_scan"] += 1
    return (scratch[lay.counts_offset:lay.words],
            scratch[lay.max_offset].reshape(()))


def merge_scan_partitions(packed_sorted: torch.Tensor, *,
                          num_partitions: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(counts, max_weight)``: int32 lane [num_partitions] of uint32
    per-partition match counts, and a 0-d int32 holding the uint32 largest
    single-outer-tuple weight, over a sorted partition-major packed lane
    (pid in the top log2(num_partitions) bits, then the key remainder, then
    the side tag).  CPU: plain; CUDA: K3."""
    check_lane(packed_sorted, "merge scan")
    fanout_bits = scan_fanout_bits(num_partitions, packed_sorted.numel())
    dev = packed_sorted.device
    if dev.type == "cpu":
        return merge_scan_plain(packed_sorted, fanout_bits)
    if dev.type == "cuda":
        return _merge_scan_cuda(packed_sorted, fanout_bits)
    raise ValueError(f"merge scan runs on cpu or cuda, not {dev}")
