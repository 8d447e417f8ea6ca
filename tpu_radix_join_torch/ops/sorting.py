"""Sort primitives of the port.

Counterpart of ``tpu_radix_join/ops/sorting.py``: every hot reorder is an
unstable sort of uint32 lanes, and here each one is the K2 radix sort
(``ops/kernels/radix_sort.py``) at every size.  The JAX package's
``PALLAS_SORT_MIN_ELEMS`` threshold and its degrade to ``lax.sort`` were
TPU choices; the port has no second sort to route to, so a lane the kernel
cannot take raises.  The JAX row sort (``sort_lex_unstable(...,
dimension=1)``) was an XLA sort there, since the radix arm took 1-D lanes
only; here :func:`sort_lex_rows_unstable` runs it on K2 with the row index
as the most significant key.  :func:`segmented_xor_fold` (the checksums of
integrity verification) sorts on K2 too; PyTorch has no cumulative xor, so
its prefix xor at the segment ends is a plain PyTorch reduction.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_radix_join_torch.ops.kernels.radix_sort import radix_sort

#: values a row of :func:`_prefix_xor_at`'s blocked reduction holds
_XOR_BLOCK = 1024


def sort_unstable(x: torch.Tensor, *,
                  key_bound: Optional[int] = None) -> torch.Tensor:
    """Sort one uint32 lane."""
    return radix_sort((x,), num_keys=1, key_bounds=(key_bound,))[0]


def sort_kv_unstable(key: torch.Tensor, *values: torch.Tensor,
                     key_bound: Optional[int] = None):
    """Key-value sort; returns (sorted key, *values in key order)."""
    return radix_sort((key, *values), num_keys=1, key_bounds=(key_bound,))


def sort_lex_unstable(*operands: torch.Tensor, num_keys: int,
                      key_bounds=None):
    """Lexicographic sort on the first ``num_keys`` lanes (most significant
    first); the remaining lanes ride along as values."""
    return radix_sort(operands, num_keys=num_keys, key_bounds=key_bounds)


def sort_lex_rows_unstable(*operands: torch.Tensor, num_keys: int,
                           key_bounds=None):
    """:func:`sort_lex_unstable` along every row of equal-shape
    [rows, width] lanes: one K2 sort of the flattened rows with the row
    index prepended as the most significant key (bound ``rows``: one 8-bit
    pass while rows <= 256).  Returns the lanes, reshaped back."""
    rows, width = operands[0].shape
    row = torch.arange(rows, dtype=torch.int32,
                       device=operands[0].device).repeat_interleave(width)
    bounds = (rows, *(key_bounds or (None,) * num_keys))
    out = radix_sort((row, *[o.reshape(-1) for o in operands]),
                     num_keys=num_keys + 1, key_bounds=bounds)
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
                       num_segments: int) -> torch.Tensor:
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
                                    key_bound=num_segments + 1)
    ends = torch.searchsorted(
        seg_s, torch.arange(num_segments, dtype=torch.int32,
                            device=seg_s.device), right=True) - 1
    upto = _prefix_xor_at(val_s, ends.to(torch.int64))
    return torch.bitwise_xor(upto, torch.cat([upto.new_zeros(1), upto[:-1]]))
