"""K3: fused merge-weight scan — ``csrc/merge_scan.cu`` and its plain version.

Counterpart of ``tpu_radix_join/ops/pallas/merge_scan.py::
merge_scan_partitions``: per-partition uint32 match counts and the largest
single weight over a sorted partition-major packed union (see
``ops/merge_count._pack_pm``).  Unlike the TPU kernel it takes any length:
the tile multiple was Mosaic's requirement.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tpu_radix_join_torch.data.tuples import U32_MASK, check_lane, narrow, widen
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check

MAX_FANOUT_BITS = 7   # 128 partitions: the kernel's shared bins


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
    raises unless the partitions are a power of two the kernels' shared
    bins hold and the positions count in 32 bits."""
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


def _merge_scan_cuda(packed_sorted: torch.Tensor, fanout_bits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = packed_sorted.numel()
    num_tiles = c_function("merge_scan", "rj_merge_scan_num_tiles",
                           [ctypes.c_longlong], ctypes.c_longlong)(m)
    fn = c_function("merge_scan", "rj_merge_scan",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p])
    dev = packed_sorted.device
    counts = torch.empty(1 << fanout_bits, dtype=torch.int32, device=dev)
    maxw = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, 4 * num_tiles), dtype=torch.int32, device=dev)
    err = fn(packed_sorted.data_ptr(), m, fanout_bits, counts.data_ptr(),
             maxw.data_ptr(), scratch.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    check(err, "merge scan kernel")
    LAUNCHES["merge_scan"] += 1
    return counts, maxw


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
