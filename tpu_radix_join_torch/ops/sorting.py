"""Sort primitives of the port.

Counterpart of ``tpu_radix_join/ops/sorting.py``: every hot reorder is an
unstable sort of uint32 lanes, and here each one is the K2 radix sort
(``ops/kernels/radix_sort.py``) at every size.  The JAX package's
``PALLAS_SORT_MIN_ELEMS`` threshold and its degrade to ``lax.sort`` were
TPU choices; the port has no second sort to route to, so a lane the kernel
cannot take raises.  The JAX row sort (``sort_lex_unstable(...,
dimension=1)``) was an XLA sort there, since the radix arm took 1-D lanes
only; here :func:`sort_lex_rows_unstable` runs it on K2 with the row index
as the most significant key.  ``segmented_xor_fold`` comes with the verify
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_radix_join_torch.ops.kernels.radix_sort import radix_sort


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
