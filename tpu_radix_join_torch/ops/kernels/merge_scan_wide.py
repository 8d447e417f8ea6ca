"""K5: wide merge-weight scan — ``csrc/merge_scan_wide.cu`` and its plain version.

Counterpart of ``tpu_radix_join/ops/pallas/merge_scan.py::
merge_scan_partitions_wide``: per-partition uint32 match counts and the
largest single weight over the sorted three-lane order ``(lo_rot, hi, tag)``
of the full-range and 64-bit sort probes (``ops/merge_count``).  ``lo_rot``
is the low key lane rotated so the partition id sits in its top bits, ``hi``
the upper key lane, ``tag`` 0 for inner (R) and 1 for outer (S) tuples; a
run is a stretch of equal (lo, hi) pairs, and every S position weighs the R
tuples before it in its run.  ``hi=None`` means an all-zero hi lane (the
full-range uint32 probe), which is never materialised.  Unlike the TPU
kernel it takes any length: the tile multiple and its all-ones pad triple
were Mosaic's requirements.  Past 128 partitions the card bins relative to
each tile's first partition (K3's wide bins; launches counted as
``merge_scan_wide_fanout``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_radix_join_torch.data.tuples import U32_MASK, check_lane, narrow, widen
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check
# K5 shares K3's tile and scratch layout (csrc/merge_scan_partitions.cuh)
from tpu_radix_join_torch.ops.kernels.merge_scan import (  # noqa: F401
    NARROW_FANOUT_BITS, SCAN_TILE, _run_weights, scan_fanout_bits,
    scratch_layout)


def merge_scan_wide_plain(lo_rot: torch.Tensor, hi: Optional[torch.Tensor],
                          tag: torch.Tensor, fanout_bits: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K5: int64 run starts on (lo, hi), cumsum/cummax weights, an
    integer per-partition sum, then the low 32 bits (the kernel's wrap)."""
    lo = widen(lo_rot)
    # position 0 starts a run whatever it is compared with: its base is 0
    # either way, so the all-ones previous key gives the TPU kernel's counts
    run_start = lo != torch.cat([lo.new_full((1,), U32_MASK), lo[:-1]])
    if hi is not None:
        h = widen(hi)
        run_start |= h != torch.cat([h.new_full((1,), U32_MASK), h[:-1]])
    weight = _run_weights(widen(tag), run_start)
    pid = lo >> (32 - fanout_bits) if fanout_bits else torch.zeros_like(lo)
    counts = torch.zeros(1 << fanout_bits, dtype=torch.int64,
                         device=lo_rot.device)
    counts.index_add_(0, pid, weight)
    maxw = weight.max() if weight.numel() else weight.new_zeros(())
    return narrow(counts), narrow(maxw)


def _merge_scan_wide_cuda(lo_rot: torch.Tensor, hi: Optional[torch.Tensor],
                          tag: torch.Tensor, fanout_bits: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = lo_rot.numel()
    lay = scratch_layout(m, fanout_bits)
    fn = c_function("merge_scan_wide", "rj_merge_scan_wide",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_void_p])
    dev = lo_rot.device
    scratch = torch.empty(lay.words, dtype=torch.int32, device=dev)
    err = fn(lo_rot.data_ptr(), None if hi is None else hi.data_ptr(),
             tag.data_ptr(), m, fanout_bits, scratch.data_ptr(), lay.bytes,
             torch.cuda.current_stream(dev).cuda_stream)
    check(err, "wide merge scan kernel")
    LAUNCHES["merge_scan_wide_fanout" if fanout_bits > NARROW_FANOUT_BITS
             else "merge_scan_wide"] += 1
    return (scratch[lay.counts_offset:lay.words],
            scratch[lay.max_offset].reshape(()))


def merge_scan_partitions_wide(lo_rot_sorted: torch.Tensor,
                               hi_sorted: Optional[torch.Tensor],
                               tag_sorted: torch.Tensor, *,
                               num_partitions: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(counts, max_weight)`` as ``merge_scan_partitions`` returns them,
    over the sorted lanes ``(lo_rot, hi, tag)`` (``hi_sorted=None``: an
    all-zero hi lane).  CPU: plain; CUDA: K5."""
    lanes = [lo_rot_sorted, tag_sorted]
    if hi_sorted is not None:
        lanes.append(hi_sorted)
    for lane in lanes:
        check_lane(lane, "wide merge scan")
        if lane.shape != lo_rot_sorted.shape or \
                lane.device != lo_rot_sorted.device:
            raise ValueError("wide merge scan wants equal-length lanes on one "
                             "device")
    fanout_bits = scan_fanout_bits(num_partitions, lo_rot_sorted.numel())
    dev = lo_rot_sorted.device
    if dev.type == "cpu":
        return merge_scan_wide_plain(lo_rot_sorted, hi_sorted, tag_sorted,
                                     fanout_bits)
    if dev.type == "cuda":
        return _merge_scan_wide_cuda(lo_rot_sorted, hi_sorted, tag_sorted,
                                     fanout_bits)
    raise ValueError(f"wide merge scan runs on cpu or cuda, not {dev}")
