"""K6: per-window merge-weight sums — ``csrc/merge_scan_chunks.cu`` and its
plain version.

Counterpart of ``tpu_radix_join/ops/pallas/merge_scan.py::
merge_scan_chunks``: over a sorted packed union ``key << 1 | side`` (K3's
layout at fanout 0), the uint32 sums of the match weights of every window of
``width`` positions, and the largest single weight.  At ``width=TILE`` these
are the TPU kernel's per-tile counts, bit for bit; at ``width = ceil(n / c)``
they are the ``c`` partial counts of ``merge_count_chunks`` (the last ones
zero-extended by the caller).  The TPU kernel did not return the max weight
only because its one caller never asked; the grid's overflow guard needs it.
Unlike the TPU kernel it takes any length: the tile multiple was Mosaic's
requirement.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from tpu_radix_join_torch.data.tuples import check_lane, narrow
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check
from tpu_radix_join_torch.ops.kernels.merge_scan import _weights

#: the TPU kernel's tile, 256 x 128 positions: its per-tile window width
TILE = 256 * 128
#: positions a tile of the card's kernel holds (kTile in the CUDA source)
SCAN_TILE = 256 * 39


def merge_scan_chunks_plain(packed_sorted: torch.Tensor, width: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K6: int64 cumsum/cummax weights, an integer sum per window,
    then the low 32 bits (the kernel's wrap)."""
    weight, _ = _weights(packed_sorted)
    n = weight.numel()
    pad = (-n) % width
    if pad:
        weight = torch.cat([weight, weight.new_zeros(pad)])
    sums = weight.view(-1, width).sum(dim=1)
    maxw = weight.max() if n else weight.new_zeros(())
    return narrow(sums), narrow(maxw)


class ScratchLayout(NamedTuple):
    """The one scratch block of a K6 call over ``m`` positions, zeroed by
    one memset, in int32 words: the look-back table (``tiles`` words of
    ``word_bytes``), the tile counter, the max weight and the ``windows``
    window sums."""

    tiles: int
    lookback_words: int
    word_bytes: int
    windows: int

    @property
    def counter_offset(self) -> int:
        return self.lookback_words * self.word_bytes // 4

    @property
    def max_offset(self) -> int:
        return self.counter_offset + 1

    @property
    def sums_offset(self) -> int:
        return self.counter_offset + 2

    @property
    def words(self) -> int:
        return self.sums_offset + self.windows

    @property
    def bytes(self) -> int:
        return 4 * self.words


def scratch_layout(m: int, width: int) -> ScratchLayout:
    """The scratch of K6 over ``m`` positions and windows of ``width``: one
    tile per :data:`SCAN_TILE` positions, one look-back word of 8 bytes a
    tile (a 2-bit flag, R and B + 1 in 31 bits each)."""
    if not 0 <= m < 1 << 31 or width < 1:
        raise ValueError(f"K6 takes 0 <= m < 2**31 and width >= 1, got "
                         f"{m}, {width}")
    tiles = -(-m // SCAN_TILE)
    return ScratchLayout(tiles=tiles, lookback_words=tiles, word_bytes=8,
                         windows=-(-m // width))


def _merge_scan_chunks_cuda(packed_sorted: torch.Tensor, width: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = packed_sorted.numel()
    lay = scratch_layout(m, width)
    fn = c_function("merge_scan_chunks", "rj_merge_scan_chunks",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    dev = packed_sorted.device
    scratch = torch.empty(lay.words, dtype=torch.int32, device=dev)
    err = fn(packed_sorted.data_ptr(), m, width, scratch.data_ptr(),
             lay.bytes, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "merge scan chunks kernel")
    LAUNCHES["merge_scan_chunks"] += 1
    return (scratch[lay.sums_offset:lay.words],
            scratch[lay.max_offset].reshape(()))


def merge_scan_chunks(packed_sorted: torch.Tensor, *, width: int = TILE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums, max_weight)``: an int32 lane [ceil(n / width)] of the uint32
    weight sums of each window of ``width`` positions, and a 0-d int32
    holding the uint32 largest single weight, over a sorted packed lane
    ``key << 1 | side``.  CPU: plain; CUDA: K6."""
    check_lane(packed_sorted, "merge scan chunks")
    n = packed_sorted.numel()
    if width < 1:
        raise ValueError(f"window width must be >= 1, got {width}")
    if n >= 1 << 31:
        raise ValueError("the merge scan counts in 32 bits: length must "
                         "stay below 2**31")
    # a window wider than the lane holds all of it: one sum either way
    width = min(int(width), max(n, 1))
    dev = packed_sorted.device
    if dev.type == "cpu":
        return merge_scan_chunks_plain(packed_sorted, width)
    if dev.type == "cuda":
        return _merge_scan_chunks_cuda(packed_sorted, width)
    raise ValueError(f"merge scan chunks runs on cpu or cuda, not {dev}")
