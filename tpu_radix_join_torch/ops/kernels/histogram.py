"""K1: partition histogram — ``csrc/histogram.cu`` and its plain version.

Counterpart of ``tpu_radix_join/ops/pallas/histogram.py::histogram_pallas``:
uint32 counts (or wrapping uint32 weight sums) of ``pid`` into
``num_bins >= 1`` bins; ids >= ``num_bins`` are ignored.  Up to
:data:`MAX_BINS` bins the card runs the per-warp tables of ``rj_histogram``
(launches counted as ``histogram``); past them ``rj_histogram_wide``
(counted as ``histogram_wide``), whose table :func:`wide_table` names as
the kernel picks it, by ``num_bins`` alone: up to :data:`RANGE_MAX_BINS`
bins the range tables, one a block for a range of at most
:data:`MAX_RANGE_BINS` bins, past them the global table.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpu_radix_join_torch.data.tuples import check_lane, narrow, widen
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check

MAX_BINS = 128   # the per-warp tables of the narrow path
MAX_RANGE_BINS = 1 << 14     # bins a range table holds at most (kMaxRangeBins)
MAX_RANGES = 8               # ranges at most (kMaxRanges)
RANGE_MAX_BINS = MAX_RANGES * MAX_RANGE_BINS


def histogram_plain(pid: torch.Tensor, weights: Optional[torch.Tensor],
                    num_bins: int) -> torch.Tensor:
    """Plain PyTorch K1: widen, mask out ids >= num_bins, integer
    ``index_add_`` (a weighted ``bincount`` that stays exact in int64),
    then keep the low 32 bits."""
    ids = widen(pid)
    keep = ids < num_bins
    w = (widen(weights) if weights is not None
         else torch.ones_like(ids))
    out = torch.zeros(num_bins, dtype=torch.int64, device=pid.device)
    out.index_add_(0, ids[keep], w[keep])
    return narrow(out)


def wide_table(num_bins: int) -> str:
    """The table ``rj_histogram_wide`` counts ``num_bins`` (past
    :data:`MAX_BINS`) bins in: ``range`` up to :data:`RANGE_MAX_BINS`,
    else ``global``."""
    return "range" if num_bins <= RANGE_MAX_BINS else "global"


def _histogram_cuda(pid: torch.Tensor, weights: Optional[torch.Tensor],
                    num_bins: int) -> torch.Tensor:
    wide = num_bins > MAX_BINS
    fn = c_function("histogram",
                    "rj_histogram_wide" if wide else "rj_histogram",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    out = torch.empty(num_bins, dtype=torch.int32, device=pid.device)
    stream = torch.cuda.current_stream(pid.device).cuda_stream
    err = fn(pid.data_ptr(),
             weights.data_ptr() if weights is not None else None,
             pid.numel(), num_bins, out.data_ptr(), stream)
    check(err, "histogram kernel")
    LAUNCHES["histogram_wide" if wide else "histogram"] += 1
    return out


def histogram(pid: torch.Tensor, weights: Optional[torch.Tensor] = None, *,
              num_bins: int) -> torch.Tensor:
    """int32 lane [num_bins]: uint32 counts (or weight sums) of ``pid``.

    A CPU ``pid`` takes :func:`histogram_plain`; a CUDA ``pid`` launches
    the kernel, and anything else raises."""
    check_lane(pid, "histogram ids")
    if weights is not None:
        check_lane(weights, "histogram weights")
        if weights.shape != pid.shape or weights.device != pid.device:
            raise ValueError("histogram weights must match the ids' shape "
                             "and device")
    if not 1 <= num_bins < 1 << 31:
        raise ValueError(f"num_bins must be in [1, 2**31), got {num_bins}")
    if pid.device.type == "cpu":
        return histogram_plain(pid, weights, num_bins)
    if pid.device.type == "cuda":
        return _histogram_cuda(pid, weights, num_bins)
    raise ValueError(f"histogram runs on cpu or cuda, not {pid.device}")
