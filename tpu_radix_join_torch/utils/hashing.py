"""32-bit integer mixing (lowbias32-style xorshift-multiply finalizer).

Bit-identical to ``tpu_radix_join/utils/hashing.py::mix32_np`` and its
device twin; the port's Zipf sampler draws through it.  Values travel as
int64 tensors holding uint32 values in [0, 2**32); :func:`mix32_np` is the
numpy twin the host generators (``Relation.fill_np``) draw through.
"""

from __future__ import annotations

import numpy as np
import torch

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_U32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in [0, 2**32) and a uint32 ``m``.

    The full product can pass 2**63 (``_M2 > 2**31``), so it is split into
    16-bit halves of ``x``: ``x_lo * m`` and ``x_hi * m`` each stay below
    2**48, and only the low 16 bits of the second survive the shift."""
    lo = (x & 0xFFFF) * m
    hi = ((x >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Bijective uint32 mix of int64 ``x`` in [0, 2**32)."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = mul32(x, _M1)
    x = x ^ (x >> 15)
    x = mul32(x, _M2)
    return x ^ (x >> 16)


def mix32_np(x: np.ndarray) -> np.ndarray:
    """Bijective uint32 mix of a numpy array (the twin of :func:`mix32`)."""
    x = np.asarray(x).astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(_M1)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(_M2)
        return x ^ (x >> np.uint32(16))
