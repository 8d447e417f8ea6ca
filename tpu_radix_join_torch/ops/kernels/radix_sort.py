"""K2: LSD radix sort — ``csrc/radix_sort.cu`` and its plain version.

Counterpart of ``tpu_radix_join/ops/pallas/radix_sort.py``:
:func:`radix_pass_slots` is ``radix_pass_slots_pallas`` (one stable 8-bit
digit pass, returning each key's destination) and :func:`radix_sort` is the
``radix_sort_pallas`` driver (``num_radix_passes`` passes per key lane, least
significant key first, every operand lane moved by each pass).  Output order
is unsigned numeric order for every uint32 input, the 0xFFFFFFFE/0xFFFFFFFF
pads included.

On the card one pass moves the lanes itself (up to four of them); on the
CPU the plain pass returns slots and the driver applies them.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from tpu_radix_join_torch.data.tuples import (check_lane,
                                              effective_key_bits, narrow,
                                              widen)
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels._build import c_function, check

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
MAX_LANES = 4     # lanes one pass on the card moves (csrc/radix_sort.cu)
_PLAIN_TILE = 1 << 14


def num_radix_passes(key_bound: Optional[int] = None,
                     key_bits: int = 32) -> int:
    """Digit passes needed for keys < ``key_bound`` (None = full width):
    ``ceil(effective_key_bits / 8)`` — 4 for full uint32, 2 for a 16-bit
    bound, 1 for an 8-bit bound."""
    return -(-effective_key_bits(key_bound, 0, key_bits) // RADIX_BITS)


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


# ------------------------------------------------------------------ card

def _pass_cuda(keys: torch.Tensor, shift: int,
               lanes: Sequence[torch.Tensor],
               with_slots: bool) -> Tuple[Optional[torch.Tensor],
                                          List[torch.Tensor]]:
    """One digit pass on the card: (slots or None, the moved lanes)."""
    n = keys.numel()
    num_blocks = c_function("radix_sort", "rj_radix_num_blocks",
                            [ctypes.c_longlong], ctypes.c_longlong)(n)
    fn = c_function("radix_sort", "rj_radix_pass",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p])
    dev = keys.device
    slots = torch.empty(n, dtype=torch.int32, device=dev) if with_slots else None
    outs = [torch.empty_like(a) for a in lanes]
    counts = torch.empty(RADIX * num_blocks, dtype=torch.int32, device=dev)
    totals = torch.empty(RADIX, dtype=torch.int32, device=dev)
    ptrs_in = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in lanes])
    ptrs_out = (ctypes.c_void_p * MAX_LANES)(*[a.data_ptr() for a in outs])
    err = fn(keys.data_ptr(), n, shift,
             slots.data_ptr() if slots is not None else None,
             len(lanes), ptrs_in, ptrs_out, counts.data_ptr(),
             totals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "radix pass kernel")
    LAUNCHES["radix_pass"] += 1
    return slots, outs


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
    across groups, input order within a group.  CPU: plain; CUDA: K2."""
    check_lane(keys, "radix pass")
    _check_shift(shift)
    if keys.device.type == "cpu":
        return radix_pass_slots_plain(keys, shift)
    if keys.device.type == "cuda":
        if keys.numel() == 0:
            return torch.empty_like(keys)
        return _pass_cuda(keys, shift, [], with_slots=True)[0]
    raise ValueError(f"radix pass runs on cpu or cuda, not {keys.device}")


def radix_sort(operands: Sequence[torch.Tensor], *, num_keys: int = 1,
               key_bounds: Optional[Sequence[Optional[int]]] = None
               ) -> Tuple[torch.Tensor, ...]:
    """LSD radix sort of equal-length uint32 lanes.

    The first ``num_keys`` operands are lexicographic sort keys, most
    significant first; the rest ride along as values.  ``key_bounds`` holds
    one exclusive upper bound (or None) per key and skips the digit passes
    it proves constant.  CPU lanes take :func:`radix_sort_plain`; CUDA
    lanes run one K2 launch per pass, and more than four lanes raise."""
    arrs = _check_operands(operands, num_keys, key_bounds)
    dev = arrs[0].device
    if dev.type == "cpu":
        return radix_sort_plain(arrs, num_keys, key_bounds)
    if dev.type != "cuda":
        raise ValueError(f"radix sort runs on cpu or cuda, not {dev}")
    if len(arrs) > MAX_LANES:
        raise ValueError(f"a radix pass on the card moves at most "
                         f"{MAX_LANES} lanes, got {len(arrs)}")
    if arrs[0].numel() <= 1:
        return tuple(arrs)
    for ki in range(num_keys - 1, -1, -1):
        bound = None if key_bounds is None else key_bounds[ki]
        for p in range(num_radix_passes(bound)):
            _, arrs = _pass_cuda(arrs[ki], RADIX_BITS * p, arrs,
                                 with_slots=False)
    return tuple(arrs)
