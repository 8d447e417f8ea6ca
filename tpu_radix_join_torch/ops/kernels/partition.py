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
K4 moves the lanes and writes the pads itself, by one of three paths chosen
by ``num_groups`` alone: up to :data:`MAX_GROUPS` groups one onesweep call
(``csrc/partition.cu``, launches counted as ``partition``); up to
:data:`WIDE_MAX_GROUPS` the wide grouping kernel (``csrc/partition_wide.cu``:
count, carry, starts and one sorting sweep a tile; ``partition_wide``);
past it the MSD passes (``csrc/partition_msd.cu``: the exact totals from
K1 at ``num_groups`` bins, a scan, then a coarse pass by the top digit and
segmented passes by the lower ones, :func:`msd_plan`; ``partition_msd``).
On the CPU
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

MAX_GROUPS = 256   # the onesweep call's groups (MAX_PARTITIONS of the TPU kernel)
MAX_LANES = 4      # lanes one pass on the card moves (csrc/partition.cu)
TILE_IDS = 4096    # ids a tile of the onesweep launch holds (kTile there)
WIDE_MAX_GROUPS = 8192   # the wide kernel's groups (kMaxGroups there)
WIDE_TILE_IDS = 8192     # ids a tile of its sweep holds (kTile there)
WIDE_CHUNK_TILES = 4     # tiles a block of its count launch takes (kChunk)
MSD_TILE_IDS = 4096      # ids a tile of an MSD pass holds (kTile there)
MSD_DIGIT_BITS = 8       # most bits an MSD pass groups by (kDigitBits)
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


class WideScratchLayout(NamedTuple):
    """The one scratch block of a wide K4 call (csrc/partition_wide.cu,
    ``rj_partition_wide_scratch_bytes``), written before it is read, so no
    memset: the pad slots before each layout region (8-byte words), the
    group starts, the exact totals (the call's hist), the chunk words and
    the 16-bit tile rows, each part rounded up to 8 bytes, in that order."""

    tiles: int
    chunks: int
    num_groups: int
    regions: int

    def _parts(self) -> Tuple[int, ...]:
        g = self.num_groups
        return tuple(-(-b // 8) * 8 for b in (
            8 * (self.regions + 1), 4 * (g + 1), 4 * g, 4 * self.chunks * g,
            2 * self.tiles * g))

    @property
    def totals_offset(self) -> int:
        """Where the totals start, in int32 words."""
        return sum(self._parts()[:2]) // 4

    @property
    def matrix_bytes(self) -> int:
        """The count matrix: the chunk words and the tile rows."""
        return sum(self._parts()[3:])

    @property
    def bytes(self) -> int:
        return sum(self._parts())


def wide_scratch_layout(n: int, num_groups: int, group_size: int = 1,
                        capacity: Optional[int] = None) -> WideScratchLayout:
    """The scratch of the wide kernel over ``n`` ids: one tile per
    :data:`WIDE_TILE_IDS` ids, one chunk per :data:`WIDE_CHUNK_TILES` tiles
    (at least one), a row of ``num_groups`` counters a tile (16-bit) and a
    chunk (32-bit), and one pad word a layout region and one more."""
    if not 0 <= n < 1 << 32 or not 1 <= num_groups <= WIDE_MAX_GROUPS:
        raise ValueError(f"the wide K4 takes 0 <= n < 2**32 ids and "
                         f"1..{WIDE_MAX_GROUPS} groups, got {n}, "
                         f"{num_groups}")
    tiles = -(-n // WIDE_TILE_IDS)
    return WideScratchLayout(
        tiles=tiles, chunks=max(1, -(-tiles // WIDE_CHUNK_TILES)),
        num_groups=num_groups,
        regions=1 if capacity is None else num_groups // group_size)


def _partition_cuda(ids: torch.Tensor, num_groups: int, group_size: int,
                    capacity: Optional[int], lanes: Sequence[torch.Tensor],
                    fills: Sequence[int], with_slots: bool, wide: bool = False
                    ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor],
                               torch.Tensor]:
    """One K4 call of the onesweep kernel (csrc/partition.cu) or, with
    ``wide``, of the wide kernel (csrc/partition_wide.cu, four launches):
    (slots or None, the moved lanes, hist).  The two share their C
    signature; each sizes its own scratch."""
    n = ids.numel()
    name = "partition_wide" if wide else "partition"
    fn = c_function(name, f"rj_{name}",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_void_p])
    dev = ids.device
    size = out_size(n, num_groups, group_size, capacity)
    slots = torch.empty(n, dtype=torch.int32, device=dev) if with_slots else None
    outs = [torch.empty(size, dtype=torch.int32, device=dev) for _ in lanes]
    lay = (wide_scratch_layout(n, num_groups, group_size, capacity) if wide
           else scratch_layout(n, num_groups))
    scratch = torch.empty(lay.bytes // 8, dtype=torch.int64, device=dev)
    ptrs_in = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in lanes])
    ptrs_out = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in outs])
    fill_words = (ctypes.c_uint32 * MAX_LANES)(*[int(f) & U32_MASK
                                                 for f in fills])
    err = fn(ids.data_ptr(), n, num_groups, group_size,
             -1 if capacity is None else capacity,
             slots.data_ptr() if slots is not None else None,
             len(lanes), ptrs_in, ptrs_out, fill_words, scratch.data_ptr(),
             lay.bytes, torch.cuda.current_stream(dev).cuda_stream)
    check(err, f"{name} kernel")
    LAUNCHES[name] += 1
    totals = scratch.view(torch.int32)[lay.totals_offset:
                                       lay.totals_offset + num_groups]
    return slots, outs, totals


def msd_plan(num_groups: int) -> List[Tuple[int, int]]:
    """The MSD passes past :data:`WIDE_MAX_GROUPS` groups, most significant
    first, as (digit bits, shift): a group id of B = bit_length(num_groups
    - 1) bits in ceil(B / 8) digits (two at least), the bits spread evenly,
    the earlier passes taking the fewer, as ``plan_for`` in
    csrc/partition_msd.cu splits them."""
    b = max(int(num_groups) - 1, 0).bit_length()
    passes = max(2, -(-b // MSD_DIGIT_BITS))
    plan, below = [], b
    for left in range(passes, 0, -1):
        bits = below // left
        below -= bits
        plan.append((bits, below))
    return plan


def _partition_msd_cuda(ids: torch.Tensor, num_groups: int, group_size: int,
                        capacity: Optional[int],
                        lanes: Sequence[torch.Tensor], fills: Sequence[int],
                        with_slots: bool
                        ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor],
                                   torch.Tensor]:
    """One grouping past :data:`WIDE_MAX_GROUPS` groups
    (csrc/partition_msd.cu): K1's totals at ``num_groups`` bins, then one
    call of the scan and the passes, nothing on the host between them:
    (slots or None, the moved lanes, hist)."""
    n = ids.numel()
    dev = ids.device
    bytes_fn = c_function("partition_msd", "rj_partition_msd_scratch_bytes",
                          [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int], restype=ctypes.c_longlong)
    fn = c_function("partition_msd", "rj_partition_msd",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_void_p])
    hist = histogram(ids, num_bins=num_groups)
    nbytes = bytes_fn(n, num_groups, int(with_slots), len(lanes))
    scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=dev)
    size = out_size(n, num_groups, group_size, capacity)
    slots = torch.empty(n, dtype=torch.int32, device=dev) if with_slots else None
    outs = [torch.empty(size, dtype=torch.int32, device=dev) for _ in lanes]
    ptrs_in = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in lanes])
    ptrs_out = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in outs])
    fill_words = (ctypes.c_uint32 * MAX_LANES)(*[int(f) & U32_MASK
                                                 for f in fills])
    err = fn(ids.data_ptr(), n, num_groups, group_size,
             -1 if capacity is None else capacity, hist.data_ptr(),
             slots.data_ptr() if slots is not None else None, len(lanes),
             ptrs_in, ptrs_out, fill_words, scratch.data_ptr(), nbytes,
             torch.cuda.current_stream(dev).cuda_stream)
    check(err, "partition_msd kernel")
    LAUNCHES["partition_msd"] += 1
    return slots, outs, hist


def _grouping_cuda(ids, num_groups, group_size, capacity, lanes, fills,
                   with_slots):
    """The card's grouping: the onesweep call up to :data:`MAX_GROUPS`
    groups, the wide kernel up to :data:`WIDE_MAX_GROUPS`, the MSD passes
    past it."""
    if num_groups > WIDE_MAX_GROUPS:
        return _partition_msd_cuda(ids, num_groups, group_size, capacity,
                                   lanes, fills, with_slots)
    return _partition_cuda(ids, num_groups, group_size, capacity, lanes,
                           fills, with_slots, wide=num_groups > MAX_GROUPS)


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
    and a onesweep launch; past :data:`MAX_GROUPS` groups the wide kernel's
    four launches, past :data:`WIDE_MAX_GROUPS` K1 and the MSD passes) that
    moves the lanes (at most four) and writes the pads itself."""
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
