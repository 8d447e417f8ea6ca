"""Sort primitives of the port.

Counterpart of ``tpu_radix_join/ops/sorting.py``: every hot reorder is an
unstable sort of uint32 lanes, and here each one is the K2 radix sort
(``ops/kernels/radix_sort.py``) at every size.  The JAX package's
``PALLAS_SORT_MIN_ELEMS`` threshold and its degrade to ``lax.sort`` were
TPU choices: the port never degrades.  Its ``impl=`` choice is JAX's
(``resolve_sort_impl``): "auto", "pallas" and "pallas_interpret" run K2;
"xla", asked for by name, is the library baseline arm, stable
``torch.sort`` key by key, least significant first, which gives K2's
order, counted apart in ``LAUNCHES["baseline_sort"]``.  The choice comes
down from the engine's ``JoinConfig.sort_impl`` as an argument, never as
a process default.  The JAX row sort (``sort_lex_unstable(...,
dimension=1)``) was an XLA sort there, since the radix arm took 1-D lanes
only; here :func:`sort_lex_rows_unstable` runs it on K2 with the row index
as the most significant key.  :func:`segmented_xor_fold` (the checksums of
integrity verification) sorts on K2 too; PyTorch has no cumulative xor, so
its prefix xor at the segment ends is a plain PyTorch reduction.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_radix_join_torch.core.config import SORT_IMPLS
from tpu_radix_join_torch.data.tuples import widen
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels.radix_sort import radix_sort

#: values a row of :func:`_prefix_xor_at`'s blocked reduction holds
_XOR_BLOCK = 1024


def check_sort_impl(impl: str) -> str:
    """``impl`` if it is one of :data:`SORT_IMPLS`, else ValueError (JAX's
    ``set_default_sort_impl`` text)."""
    if impl not in SORT_IMPLS:
        raise ValueError(
            f"unknown sort impl {impl!r} (expected one of {SORT_IMPLS})")
    return impl


def library_sort(operands, num_keys: int):
    """The baseline arm: a stable ``torch.sort`` of each key lane in turn,
    least significant first, each on the lane's unsigned value (int64), the
    order carried by index; every lane gathered once at the end.  Stable
    passes compose, so the order is K2's."""
    LAUNCHES["baseline_sort"] += 1
    order = None
    for k in range(num_keys - 1, -1, -1):
        key = widen(operands[k] if order is None else operands[k][order])
        step = torch.sort(key, stable=True).indices
        order = step if order is None else order[step]
    return tuple(o[order] for o in operands)


def _sort(operands, num_keys: int, key_bounds, impl: str):
    if check_sort_impl(impl) == "xla":
        return library_sort(operands, num_keys)
    return radix_sort(operands, num_keys=num_keys, key_bounds=key_bounds)


def sort_unstable(x: torch.Tensor, *, key_bound: Optional[int] = None,
                  impl: str = "auto") -> torch.Tensor:
    """Sort one uint32 lane."""
    return _sort((x,), 1, (key_bound,), impl)[0]


def sort_kv_unstable(key: torch.Tensor, *values: torch.Tensor,
                     key_bound: Optional[int] = None, impl: str = "auto"):
    """Key-value sort; returns (sorted key, *values in key order)."""
    return _sort((key, *values), 1, (key_bound,), impl)


def sort_lex_unstable(*operands: torch.Tensor, num_keys: int,
                      key_bounds=None, impl: str = "auto"):
    """Lexicographic sort on the first ``num_keys`` lanes (most significant
    first); the remaining lanes ride along as values."""
    return _sort(operands, num_keys, key_bounds, impl)


def sort_lex_rows_unstable(*operands: torch.Tensor, num_keys: int,
                           key_bounds=None, impl: str = "auto"):
    """:func:`sort_lex_unstable` along every row of equal-shape
    [rows, width] lanes: one sort of the flattened rows with the row index
    prepended as the most significant key (bound ``rows``: one 8-bit K2
    pass while rows <= 256).  Returns the lanes, reshaped back."""
    rows, width = operands[0].shape
    row = torch.arange(rows, dtype=torch.int32,
                       device=operands[0].device).repeat_interleave(width)
    bounds = (rows, *(key_bounds or (None,) * num_keys))
    out = _sort((row, *[o.reshape(-1) for o in operands]), num_keys + 1,
                bounds, impl)
    return tuple(o.view(rows, width) for o in out[1:])


def _xor_rows(x: torch.Tensor) -> torch.Tensor:
    """The xor of each row of int32 [rows, 2**k]: k halving steps."""
    while x.shape[1] > 1:
        x = torch.bitwise_xor(x[:, 0::2], x[:, 1::2])
    return x[:, 0]


def _prefix_xor_at(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int32 [q]: the xor of ``values[0..idx[i]]`` for int64 ``idx`` in
    [-1, n) (0 for -1).  The lane is cut into rows of ``_XOR_BLOCK``; each
    row is xor-reduced, the row totals are prefix-xored (a log-step scan
    over n / ``_XOR_BLOCK`` values), and each query adds the masked part of
    its own row."""
    n, b = values.numel(), _XOR_BLOCK
    rows = max(1, -(-n // b))
    blocks = torch.zeros(rows * b, dtype=torch.int32, device=values.device)
    blocks[:n] = values
    blocks = blocks.view(rows, b)
    incl = _xor_rows(blocks)
    d = 1
    while d < rows:                       # inclusive prefix xor of the rows
        incl = torch.cat([incl[:d], torch.bitwise_xor(incl[d:], incl[:-d])])
        d *= 2
    before = torch.cat([incl.new_zeros(1), incl[:-1]])
    q = torch.clamp(idx, min=0)
    row, col = q // b, q % b
    keep = (torch.arange(b, device=values.device)[None, :] <= col[:, None])
    part = _xor_rows(torch.where(keep, blocks[row], 0))
    return torch.where(idx >= 0, torch.bitwise_xor(before[row], part), 0)


def segmented_xor_fold(segment: torch.Tensor, values: torch.Tensor,
                       num_segments: int, impl: str = "auto") -> torch.Tensor:
    """Per-segment xor: ``out[q] = XOR of values[i] where segment[i] ==
    q``, an int32 lane [num_segments] of uint32 bits
    (``segmented_xor_fold``, ``ops/sorting.py:210-240``).

    The values sort by segment on K2 (key bound ``num_segments + 1``: one
    8-bit pass up to 255 segments), ``searchsorted`` finds each segment's
    last position, and the fold is the prefix xor there against the one at
    the previous segment's end (:func:`_prefix_xor_at`).  An empty segment
    folds to 0.  The segment ``num_segments`` is the discard bucket:
    callers route invalid lanes to exactly that value."""
    seg_s, val_s = sort_kv_unstable(segment, values,
                                    key_bound=num_segments + 1, impl=impl)
    ends = torch.searchsorted(
        seg_s, torch.arange(num_segments, dtype=torch.int32,
                            device=seg_s.device), right=True) - 1
    upto = _prefix_xor_at(val_s, ends.to(torch.int64))
    return torch.bitwise_xor(upto, torch.cat([upto.new_zeros(1), upto[:-1]]))
