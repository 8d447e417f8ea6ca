"""K4: radix partition pass — ``csrc/partition.cu`` and its plain version.

Counterpart of ``tpu_radix_join/ops/pallas/partition.py::
partition_slots_pallas``: uint32 ids [n] with ``num_groups <= 256`` groups
→ (slots, exact hist).  ``capacity=None`` gives a dense stable grouping
permutation (id order across groups, input order within one); a capacity
gives the blocked layout where ``group_size`` consecutive groups share the
block ``id // group_size`` and a tuple whose unclipped position in its block
is ``>= capacity`` gets :data:`DROPPED`.  Ids ``>= num_groups`` are counted
nowhere and dropped.

:func:`partition_slots` exposes the contract; :func:`partition_scatter` is
what the join calls: it groups lanes into pad-filled outputs.  On the card
K4 moves the lanes itself; on the CPU :func:`partition_scatter_plain`
applies the plain slots with the dropped ones masked out first (a torch
index of -1, the int32 view of ``0xFFFFFFFF``, would write the last
element).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from tpu_radix_join_torch.data.tuples import U32_MASK, check_lane, narrow, widen
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check

MAX_GROUPS = 256   # MAX_PARTITIONS of the TPU kernel, the kernel's shared bins
MAX_LANES = 4      # lanes one pass on the card moves (csrc/partition.cu)
DROPPED = U32_MASK


def _check_geometry(ids: torch.Tensor, num_groups: int, group_size: int,
                    capacity: Optional[int]) -> None:
    check_lane(ids, "partition ids")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups must be in [1, {MAX_GROUPS}], got "
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


def _filled(size: int, fills: Sequence[int], device) -> List[torch.Tensor]:
    return [torch.full((size,), int(narrow(torch.tensor(f))),
                       dtype=torch.int32, device=device) for f in fills]


def partition_scatter_plain(ids: torch.Tensor, lanes: Sequence[torch.Tensor],
                            fills: Sequence[int], num_groups: int,
                            group_size: int = 1,
                            capacity: Optional[int] = None
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain :func:`partition_scatter`: the plain slots, with the dropped
    ones masked out before the lanes are written (a torch index of -1, the
    int32 view of ``0xFFFFFFFF``, would write the last slot)."""
    slots, hist = partition_slots_plain(ids, num_groups, group_size, capacity)
    outs = _filled(out_size(ids.numel(), num_groups, group_size, capacity),
                   fills, ids.device)
    keep = slots != narrow(torch.tensor(DROPPED))
    dest = widen(slots[keep])
    for lane, out in zip(lanes, outs):
        out[dest] = lane[keep]
    return outs, hist


# ------------------------------------------------------------------ card

def _partition_cuda(ids: torch.Tensor, num_groups: int, group_size: int,
                    capacity: Optional[int], lanes: Sequence[torch.Tensor],
                    outs: Sequence[torch.Tensor], with_slots: bool
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    n = ids.numel()
    num_blocks = c_function("partition", "rj_partition_num_blocks",
                            [ctypes.c_longlong], ctypes.c_longlong)(n)
    fn = c_function("partition", "rj_partition",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    dev = ids.device
    slots = torch.empty(n, dtype=torch.int32, device=dev) if with_slots else None
    counts = torch.empty(max(1, num_groups * num_blocks), dtype=torch.int32,
                         device=dev)
    totals = torch.empty(MAX_GROUPS, dtype=torch.int32, device=dev)
    ptrs_in = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in lanes])
    ptrs_out = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in outs])
    err = fn(ids.data_ptr(), n, num_groups, group_size,
             -1 if capacity is None else capacity,
             slots.data_ptr() if slots is not None else None,
             len(lanes), ptrs_in, ptrs_out, counts.data_ptr(),
             totals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "partition kernel")
    LAUNCHES["partition"] += 1
    return slots, totals[:num_groups]


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
        return _partition_cuda(ids, num_groups, group_size, capacity, [], [],
                               with_slots=True)
    raise ValueError(f"partition runs on cpu or cuda, not {ids.device}")


def partition_scatter(ids: torch.Tensor, lanes: Sequence[torch.Tensor],
                      fills: Sequence[int], *, num_groups: int,
                      group_size: int = 1, capacity: Optional[int] = None
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(outs, hist): every lane grouped into an output of
    :func:`out_size` slots pre-filled with its entry of ``fills`` (uint32
    values); dropped tuples are not written.  CPU: plain slots, masked
    and applied; CUDA: one K4 launch that moves the lanes (at most four)."""
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
    outs = _filled(out_size(ids.numel(), num_groups, group_size, capacity),
                   fills, ids.device)
    _, hist = _partition_cuda(ids, num_groups, group_size, capacity, lanes,
                              outs, with_slots=False)
    return outs, hist
