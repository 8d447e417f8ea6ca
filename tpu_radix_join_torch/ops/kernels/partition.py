"""K4: radix partition pass — ``csrc/partition.cu`` and its plain version.

Counterpart of ``tpu_radix_join/ops/pallas/partition.py::
partition_slots_pallas``: uint32 ids [n] with ``num_groups`` groups →
(slots, exact hist).  ``capacity=None`` gives a dense stable grouping
permutation (id order across groups, input order within one); a capacity
gives the blocked layout where ``group_size`` consecutive groups share the
block ``id // group_size`` and a tuple whose unclipped position in its block
is ``>= capacity`` gets :data:`DROPPED`.  Ids ``>= num_groups`` are counted
nowhere and dropped.

:func:`partition_slots` exposes the contract; :func:`partition_scatter` is
what the join calls: it groups lanes into pad-filled outputs.  On the card
K4 moves the lanes and writes the pads itself: up to :data:`MAX_GROUPS`
groups in one onesweep call (``csrc/partition.cu``, launches counted as
``partition``), past them by the wide path (``csrc/partition_wide.cu``:
the groups sorted with their indices by K2's stable digit passes, the
totals from K1's wide path, then one placing launch; counted as
``partition_lsd``).  On the CPU
:func:`partition_scatter_plain` applies the plain slots with the dropped
ones masked out first (a torch index of -1, the int32 view of
``0xFFFFFFFF``, would write the last element).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from tpu_radix_join_torch.data.tuples import U32_MASK, check_lane, narrow, widen
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check
from tpu_radix_join_torch.ops.kernels.histogram import histogram
from tpu_radix_join_torch.ops.kernels.radix_sort import radix_sort

MAX_GROUPS = 256   # the onesweep call's groups (MAX_PARTITIONS of the TPU kernel)
MAX_LANES = 4      # lanes one pass on the card moves (csrc/partition.cu)
TILE_IDS = 4096    # ids a tile of the onesweep launch holds (kTile there)
DROPPED = U32_MASK


def _check_geometry(ids: torch.Tensor, num_groups: int, group_size: int,
                    capacity: Optional[int]) -> None:
    check_lane(ids, "partition ids")
    if not 1 <= num_groups < 1 << 31:
        raise ValueError(f"num_groups must be in [1, 2**31), got "
                         f"{num_groups}")
    if group_size < 1 or num_groups % group_size:
        raise ValueError(f"num_groups {num_groups} not a multiple of "
                         f"group_size {group_size}")
    if ids.numel() > U32_MASK:
        raise ValueError("partition takes at most 2**32 - 1 ids")
    if capacity is not None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if (num_groups // group_size) * capacity > U32_MASK:
            raise ValueError("the blocked layout must stay below 2**32 - 1 "
                             "slots, so the drop sentinel is never a slot")


def out_size(n: int, num_groups: int, group_size: int,
             capacity: Optional[int]) -> int:
    """Slots of the layout: n in dense mode, else blocks * capacity."""
    return n if capacity is None else (num_groups // group_size) * capacity


# ------------------------------------------------------------------ plain

def partition_slots_plain(ids: torch.Tensor, num_groups: int,
                          group_size: int = 1,
                          capacity: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: invalid ids join one extra group after the real ones, a
    stable argsort gives every id its dense position, and the exclusive
    cumsum of the bincount gives the group starts the blocked layout
    restarts from."""
    g = widen(ids)
    g = torch.where(g < num_groups, g, num_groups)
    full = torch.bincount(g, minlength=num_groups + 1)
    start = torch.cumsum(full, 0) - full
    pos = torch.empty_like(g)
    pos[torch.argsort(g, stable=True)] = torch.arange(
        g.numel(), dtype=g.dtype, device=g.device)
    keep = g < num_groups
    if capacity is None:
        slot = pos
    else:
        lead = (g // group_size) * group_size
        within = pos - start[lead]
        keep &= within < capacity
        slot = (g // group_size) * capacity + within
    return (narrow(torch.where(keep, slot, DROPPED)),
            narrow(full[:num_groups]))


def partition_scatter_plain(ids: torch.Tensor, lanes: Sequence[torch.Tensor],
                            fills: Sequence[int], num_groups: int,
                            group_size: int = 1,
                            capacity: Optional[int] = None
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain :func:`partition_scatter`: the plain slots, with the dropped
    ones masked out before the lanes are written (a torch index of -1, the
    int32 view of ``0xFFFFFFFF``, would write the last slot)."""
    slots, hist = partition_slots_plain(ids, num_groups, group_size, capacity)
    size = out_size(ids.numel(), num_groups, group_size, capacity)
    outs = [torch.full((size,), int(narrow(torch.tensor(f))),
                       dtype=torch.int32, device=ids.device) for f in fills]
    keep = slots != narrow(torch.tensor(DROPPED))
    dest = widen(slots[keep])
    for lane, out in zip(lanes, outs):
        out[dest] = lane[keep]
    return outs, hist


# ------------------------------------------------------------------ card

class ScratchLayout(NamedTuple):
    """The one scratch block of a K4 call over ``n`` ids, zeroed by one
    memset: the look-back table (``tiles`` x ``num_groups`` words of
    ``word_bytes``), then ``totals_words`` uint32 group totals and the tile
    counter, packed into ``words`` int64 words."""

    tiles: int
    lookback_words: int
    word_bytes: int
    totals_words: int

    @property
    def totals_offset(self) -> int:
        """Where the totals start, in int32 words."""
        return self.lookback_words * self.word_bytes // 4

    @property
    def words(self) -> int:
        return self.lookback_words + (self.totals_words + 2) // 2

    @property
    def bytes(self) -> int:
        return 8 * self.words


def scratch_layout(n: int, num_groups: int) -> ScratchLayout:
    """The scratch of K4 over ``n`` ids into ``num_groups`` groups: one tile
    per :data:`TILE_IDS` ids, one look-back word of 8 bytes a tile and group
    (a flag over a 32-bit count that reaches n < 2**32), the 256 totals and
    the counter."""
    if not 0 <= n < 1 << 32 or not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"K4 takes 0 <= n < 2**32 ids and 1..{MAX_GROUPS} "
                         f"groups, got {n}, {num_groups}")
    tiles = -(-n // TILE_IDS)
    return ScratchLayout(tiles=tiles, lookback_words=tiles * num_groups,
                         word_bytes=8, totals_words=MAX_GROUPS)


def _partition_cuda(ids: torch.Tensor, num_groups: int, group_size: int,
                    capacity: Optional[int], lanes: Sequence[torch.Tensor],
                    fills: Sequence[int], with_slots: bool
                    ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor],
                               torch.Tensor]:
    """One K4 call: (slots or None, the moved lanes, hist)."""
    n = ids.numel()
    fn = c_function("partition", "rj_partition",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_void_p])
    dev = ids.device
    size = out_size(n, num_groups, group_size, capacity)
    slots = torch.empty(n, dtype=torch.int32, device=dev) if with_slots else None
    outs = [torch.empty(size, dtype=torch.int32, device=dev) for _ in lanes]
    lay = scratch_layout(n, num_groups)
    scratch = torch.empty(lay.words, dtype=torch.int64, device=dev)
    ptrs_in = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in lanes])
    ptrs_out = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in outs])
    fill_words = (ctypes.c_uint32 * MAX_LANES)(*[int(f) & U32_MASK
                                                 for f in fills])
    err = fn(ids.data_ptr(), n, num_groups, group_size,
             -1 if capacity is None else capacity,
             slots.data_ptr() if slots is not None else None,
             len(lanes), ptrs_in, ptrs_out, fill_words, scratch.data_ptr(),
             lay.bytes, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "partition kernel")
    LAUNCHES["partition"] += 1
    totals = scratch.view(torch.int32)[lay.totals_offset:
                                       lay.totals_offset + num_groups]
    return slots, outs, totals


def _partition_wide_cuda(ids: torch.Tensor, num_groups: int, group_size: int,
                         capacity: Optional[int],
                         lanes: Sequence[torch.Tensor], fills: Sequence[int],
                         with_slots: bool
                         ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor],
                                    torch.Tensor]:
    """One grouping past :data:`MAX_GROUPS` groups (csrc/partition_wide.cu):
    (slots or None, the moved lanes, hist)."""
    n = ids.numel()
    dev = ids.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    keys_fn = c_function("partition_wide", "rj_partition_keys",
                         [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    place_fn = c_function("partition_wide", "rj_partition_place",
                          [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p])
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    index = torch.empty(n, dtype=torch.int32, device=dev)
    check(keys_fn(ids.data_ptr(), n, num_groups, keys.data_ptr(),
                  index.data_ptr(), stream), "partition keys kernel")
    if n > 1:
        keys, index = radix_sort((keys, index), num_keys=1,
                                 key_bounds=(num_groups + 1,))
    hist = histogram(ids, num_bins=num_groups)
    # the first sorted position of every group, then of every layout block
    lead = torch.cumsum(widen(hist), 0)
    lead = torch.cat([lead.new_zeros(1), lead])
    block_start = (lead[[0, num_groups]] if capacity is None
                   else lead[::group_size].contiguous())
    size = out_size(n, num_groups, group_size, capacity)
    slots = torch.empty(n, dtype=torch.int32, device=dev) if with_slots else None
    outs = [torch.empty(size, dtype=torch.int32, device=dev) for _ in lanes]
    ptrs_in = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in lanes])
    ptrs_out = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in outs])
    fill_words = (ctypes.c_uint32 * MAX_LANES)(*[int(f) & U32_MASK
                                                 for f in fills])
    err = place_fn(keys.data_ptr(), index.data_ptr(), n, num_groups,
                   group_size, -1 if capacity is None else capacity,
                   block_start.data_ptr(),
                   slots.data_ptr() if slots is not None else None,
                   len(lanes), ptrs_in, ptrs_out, fill_words, size, stream)
    check(err, "partition place kernel")
    LAUNCHES["partition_lsd"] += 1
    return slots, outs, hist


def _grouping_cuda(ids, num_groups, group_size, capacity, lanes, fills,
                   with_slots):
    """The card's grouping: the onesweep call up to :data:`MAX_GROUPS`
    groups, the wide path past them."""
    run = _partition_cuda if num_groups <= MAX_GROUPS else _partition_wide_cuda
    return run(ids, num_groups, group_size, capacity, lanes, fills,
               with_slots)


# --------------------------------------------------------------- wrappers

def partition_slots(ids: torch.Tensor, *, num_groups: int,
                    group_size: int = 1, capacity: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slots, hist): int32 lanes [n] and [num_groups] of uint32 bits, the
    TPU kernel's contract.  CPU: plain; CUDA: K4."""
    _check_geometry(ids, num_groups, group_size, capacity)
    if ids.device.type == "cpu":
        return partition_slots_plain(ids, num_groups, group_size, capacity)
    if ids.device.type == "cuda":
        slots, _, hist = _grouping_cuda(ids, num_groups, group_size,
                                        capacity, [], [], with_slots=True)
        return slots, hist
    raise ValueError(f"partition runs on cpu or cuda, not {ids.device}")


def partition_scatter(ids: torch.Tensor, lanes: Sequence[torch.Tensor],
                      fills: Sequence[int], *, num_groups: int,
                      group_size: int = 1, capacity: Optional[int] = None
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(outs, hist): every lane grouped into an output of
    :func:`out_size` slots whose other slots hold its entry of ``fills``
    (uint32 values); dropped tuples are not written.  CPU: plain slots,
    masked and applied over filled outputs; CUDA: one K4 call (a histogram
    and a onesweep launch, or the wide path past :data:`MAX_GROUPS`
    groups) that moves the lanes (at most four) and writes the pads
    itself."""
    _check_geometry(ids, num_groups, group_size, capacity)
    lanes = list(lanes)
    if len(fills) != len(lanes):
        raise ValueError("one fill value per lane")
    for lane in lanes:
        check_lane(lane, "partition lane")
        if lane.shape != ids.shape or lane.device != ids.device:
            raise ValueError("partition lanes must match the ids' shape and "
                             "device")
    if ids.device.type == "cpu":
        return partition_scatter_plain(ids, lanes, fills, num_groups,
                                       group_size, capacity)
    if ids.device.type != "cuda":
        raise ValueError(f"partition runs on cpu or cuda, not {ids.device}")
    if len(lanes) > MAX_LANES:
        raise ValueError(f"a partition pass on the card moves at most "
                         f"{MAX_LANES} lanes, got {len(lanes)}")
    _, outs, hist = _grouping_cuda(ids, num_groups, group_size, capacity,
                                   lanes, fills, with_slots=False)
    return outs, hist
