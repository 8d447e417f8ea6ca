"""K2: LSD radix sort — ``csrc/radix_sort.cu`` and its plain version.

Counterpart of ``tpu_radix_join/ops/pallas/radix_sort.py``:
:func:`radix_pass_slots` is ``radix_pass_slots_pallas`` (one stable 8-bit
digit pass, returning each key's destination) and :func:`radix_sort` is the
``radix_sort_pallas`` driver (``num_radix_passes`` passes per key lane, least
significant key first, every operand lane moved by each pass).  Output order
is unsigned numeric order for every uint32 input, the 0xFFFFFFFE/0xFFFFFFFF
pads included.

On the card a sort is one histogram launch, which counts the digits of
every pass from the unsorted key lanes (:func:`radix_histograms`), then one
onesweep launch a pass that moves the lanes itself (up to four of them);
on the CPU the plain pass returns slots and the driver applies them.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from tpu_radix_join_torch.data.tuples import (check_lane,
                                              effective_key_bits, narrow,
                                              widen)
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
MAX_LANES = 4     # lanes one pass on the card moves (csrc/radix_sort.cu)
TILE_KEYS = 4096  # keys a tile of one pass holds on the card (kTile there)
_PLAIN_TILE = 1 << 14


def num_radix_passes(key_bound: Optional[int] = None,
                     key_bits: int = 32) -> int:
    """Digit passes needed for keys < ``key_bound`` (None = full width):
    ``ceil(effective_key_bits / 8)`` — 4 for full uint32, 2 for a 16-bit
    bound, 1 for an 8-bit bound."""
    return -(-effective_key_bits(key_bound, 0, key_bits) // RADIX_BITS)


def pass_plan(num_keys: int,
              key_bounds: Optional[Sequence[Optional[int]]] = None
              ) -> List[Tuple[int, int]]:
    """The digit passes of a sort in the order they run: ``(key index,
    shift)`` for the least significant key's passes first, each key's from
    shift 0 up."""
    plan = []
    for ki in range(num_keys - 1, -1, -1):
        bound = None if key_bounds is None else key_bounds[ki]
        plan += [(ki, RADIX_BITS * p) for p in range(num_radix_passes(bound))]
    return plan


# ------------------------------------------------------------------ plain

def radix_pass_slots_plain(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """Plain K2 pass: a per-digit stable cumcount, as the interpret branch
    of the TPU kernel computes it — one-hot digits, a running count along
    each digit's row, digit cursors carried from tile to tile (tiles of
    ``_PLAIN_TILE`` keys keep the one-hot table small).  The table is
    digit-major so the cumsum runs along its contiguous last dimension,
    which the card scans in parallel."""
    d = (widen(keys) >> shift) & (RADIX - 1)
    hist = torch.bincount(d, minlength=RADIX)
    cursor = torch.cumsum(hist, 0) - hist
    digits = torch.arange(RADIX, dtype=d.dtype, device=d.device)[:, None]
    slots = torch.empty_like(d)
    for lo in range(0, d.numel(), _PLAIN_TILE):
        g = d[lo:lo + _PLAIN_TILE]
        incl = torch.cumsum((digits == g).to(torch.int32), 1,
                            dtype=torch.int32)
        rank = incl.gather(0, g[None, :])[0].to(torch.int64) - 1
        slots[lo:lo + g.numel()] = cursor[g] + rank
        cursor = cursor + incl[:, -1]
    return narrow(slots)


def _apply_permutation(slots: torch.Tensor,
                       arrs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    dest = widen(slots)
    out = []
    for a in arrs:
        b = torch.empty_like(a)
        b[dest] = a
        out.append(b)
    return out


def radix_sort_plain(operands: Sequence[torch.Tensor], num_keys: int = 1,
                     key_bounds: Optional[Sequence[Optional[int]]] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain K2 driver: the same passes as :func:`radix_sort`, each one
    :func:`radix_pass_slots_plain` plus a permutation of every lane."""
    arrs = _check_operands(operands, num_keys, key_bounds)
    if arrs[0].numel() <= 1:
        return tuple(arrs)
    for ki in range(num_keys - 1, -1, -1):
        bound = None if key_bounds is None else key_bounds[ki]
        for p in range(num_radix_passes(bound)):
            slots = radix_pass_slots_plain(arrs[ki], RADIX_BITS * p)
            arrs = _apply_permutation(slots, arrs)
    return tuple(arrs)


def radix_histograms_plain(keys: Sequence[torch.Tensor],
                           key_bounds: Optional[Sequence[Optional[int]]] = None
                           ) -> torch.Tensor:
    """Plain digit table of a sort by ``keys`` (most significant first):
    int32 ``[passes, 256]`` of uint32 counts, one row per pass of
    :func:`pass_plan` in the order the passes run, each the ``bincount`` of
    that pass's digits."""
    rows = [torch.bincount((widen(keys[ki]) >> shift) & (RADIX - 1),
                           minlength=RADIX)
            for ki, shift in pass_plan(len(keys), key_bounds)]
    return narrow(torch.stack(rows))


# ------------------------------------------------------------------ card

class ScratchLayout(NamedTuple):
    """What one K2 sort (or pass) over ``n`` keys allocates beside its lanes,
    zeroed once: the look-back table (``tiles`` x 256 words of
    ``word_bytes``), the ``[passes, 256]`` uint32 digit table and one uint32
    tile counter a pass, packed in that order into ``words`` int64 words."""

    tiles: int
    lookback_words: int
    word_bytes: int
    table_words: int
    counters: int

    @property
    def words(self) -> int:
        return self.lookback_words + -(-(self.table_words + self.counters) // 2)

    @property
    def bytes(self) -> int:
        return 8 * self.words


def scratch_layout(n: int, passes: int) -> ScratchLayout:
    """The scratch of a sort of ``n`` keys in ``passes`` digit passes: one
    tile per ``TILE_KEYS`` keys, 256 look-back words of 8 bytes a tile (a
    count up to n < 2**32 beside its status, so nothing wraps past 2**30),
    shared by every pass of the sort."""
    if not 0 <= n < 1 << 32:
        raise ValueError(f"K2 sorts fewer than 2**32 keys, got {n}")
    tiles = -(-n // TILE_KEYS)
    return ScratchLayout(tiles=tiles, lookback_words=RADIX * tiles,
                         word_bytes=8, table_words=RADIX * passes,
                         counters=passes)


def _ptrs(lanes: Sequence[Optional[torch.Tensor]]):
    return (ctypes.c_void_p * MAX_LANES)(
        *[None if a is None else a.data_ptr() for a in lanes])


def _launch_histograms(lanes: Sequence[torch.Tensor],
                       plan: Sequence[Tuple[int, int]], table: int,
                       stream: int) -> None:
    """The histogram kernel: adds the digit counts of every pass of
    ``plan`` (rows in its order) into the zeroed uint32 table at address
    ``table``, reading each key lane once."""
    key_order: List[int] = []          # key lanes in the order they run
    for ki, _ in plan:
        if ki not in key_order:
            key_order.append(ki)
    rows = (ctypes.c_int * MAX_LANES)(
        *[sum(1 for k, _ in plan if k == ki) for ki in key_order])
    shifts = (ctypes.c_int * len(plan))(*[sh for _, sh in plan])
    fn = c_function("radix_sort", "rj_radix_histograms",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_void_p])
    check(fn(_ptrs([lanes[ki] for ki in key_order]), rows, shifts,
             len(key_order), lanes[0].numel(), table, stream),
          "radix histogram kernel")
    LAUNCHES["radix_histogram"] += 1


def _run_cuda(lanes: Sequence[torch.Tensor], plan: Sequence[Tuple[int, int]],
              slots: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """One K2 sort on the card: one histogram launch for every pass of
    ``plan``, then one onesweep launch a pass, ping-ponging between two
    sets of lane buffers.  With ``slots`` (one pass, one lane) the pass
    writes each key's slot there and moves nothing.  Returns the lanes
    after the last pass."""
    dev = lanes[0].device
    n = lanes[0].numel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lay = scratch_layout(n, len(plan))
    scratch = torch.zeros(lay.words, dtype=torch.int64, device=dev)
    table = scratch.data_ptr() + 8 * lay.lookback_words
    counters = table + 4 * lay.table_words
    _launch_histograms(lanes, plan, table, stream)
    one_pass = c_function("radix_sort", "rj_radix_onesweep_pass",
                          [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint,
                           ctypes.c_void_p])
    bufs = [] if slots is not None else [
        [torch.empty_like(a) for a in lanes] for _ in range(min(2, len(plan)))]
    src = list(lanes)
    for p, (ki, shift) in enumerate(plan):
        dst = bufs[p % 2] if bufs else [None] * len(src)
        err = one_pass(_ptrs(src), _ptrs(dst), len(src), ki, n, shift,
                       None if slots is None else slots.data_ptr(),
                       table + 4 * RADIX * p, scratch.data_ptr(), lay.tiles,
                       counters + 4 * p, p + 1, stream)
        check(err, "radix pass kernel")
        LAUNCHES["radix_pass"] += 1
        if bufs:
            src = dst
    return src


# --------------------------------------------------------------- wrappers

def _check_operands(operands, num_keys, key_bounds) -> List[torch.Tensor]:
    arrs = list(operands)
    if not 1 <= num_keys <= len(arrs):
        raise ValueError(f"num_keys {num_keys} out of range for "
                         f"{len(arrs)} operands")
    for a in arrs:
        check_lane(a, "radix sort")
        if a.shape != arrs[0].shape or a.device != arrs[0].device:
            raise ValueError("radix sort wants equal-length lanes on one "
                             "device")
    if key_bounds is not None and len(key_bounds) != num_keys:
        raise ValueError(f"key_bounds has {len(key_bounds)} entries for "
                         f"{num_keys} keys")
    return arrs


def _check_shift(shift: int) -> None:
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"shift must be 0, 8, 16 or 24, got {shift}")


def radix_pass_slots(keys: torch.Tensor, *, shift: int) -> torch.Tensor:
    """int32 lane [n] of destinations for one stable digit pass grouping by
    ``(keys >> shift) & 0xFF``: a dense permutation of [0, n), digit order
    across groups, input order within a group.  CPU: plain; CUDA: K2 (one
    histogram launch, one pass launch that writes the slots)."""
    check_lane(keys, "radix pass")
    _check_shift(shift)
    if keys.device.type == "cpu":
        return radix_pass_slots_plain(keys, shift)
    if keys.device.type == "cuda":
        slots = torch.empty_like(keys)
        if keys.numel() > 0:
            _run_cuda([keys], [(0, shift)], slots)
        return slots
    raise ValueError(f"radix pass runs on cpu or cuda, not {keys.device}")


def radix_histograms(keys: Sequence[torch.Tensor], *,
                     key_bounds: Optional[Sequence[Optional[int]]] = None
                     ) -> torch.Tensor:
    """int32 ``[passes, 256]`` table of uint32 digit counts, one row per
    pass of a sort by ``keys`` (most significant first), in the order the
    passes run.  CPU: :func:`radix_histograms_plain`; CUDA: K2's histogram
    kernel, the one launch a sort makes before its passes."""
    keys = _check_operands(keys, len(keys), key_bounds)
    dev = keys[0].device
    if dev.type == "cpu":
        return radix_histograms_plain(keys, key_bounds)
    if len(keys) > MAX_LANES:
        raise ValueError(f"the histogram kernel reads at most {MAX_LANES} "
                         f"key lanes, got {len(keys)}")
    if dev.type != "cuda":
        raise ValueError(f"radix histograms run on cpu or cuda, not {dev}")
    plan = pass_plan(len(keys), key_bounds)
    table = torch.zeros((len(plan), RADIX), dtype=torch.int32, device=dev)
    if keys[0].numel() > 0:
        _launch_histograms(keys, plan, table.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    return table


def radix_sort(operands: Sequence[torch.Tensor], *, num_keys: int = 1,
               key_bounds: Optional[Sequence[Optional[int]]] = None
               ) -> Tuple[torch.Tensor, ...]:
    """LSD radix sort of equal-length uint32 lanes.

    The first ``num_keys`` operands are lexicographic sort keys, most
    significant first; the rest ride along as values.  ``key_bounds`` holds
    one exclusive upper bound (or None) per key and skips the digit passes
    it proves constant.  CPU lanes take :func:`radix_sort_plain`; CUDA
    lanes run one histogram launch and one onesweep launch per pass, and
    more than four lanes raise."""
    arrs = _check_operands(operands, num_keys, key_bounds)
    dev = arrs[0].device
    if dev.type == "cpu":
        return radix_sort_plain(arrs, num_keys, key_bounds)
    if len(arrs) > MAX_LANES:
        raise ValueError(f"a radix pass on the card moves at most "
                         f"{MAX_LANES} lanes, got {len(arrs)}")
    if dev.type != "cuda":
        raise ValueError(f"radix sort runs on cpu or cuda, not {dev}")
    if arrs[0].numel() <= 1:
        return tuple(arrs)
    return tuple(_run_cuda(arrs, pass_plan(num_keys, key_bounds)))
