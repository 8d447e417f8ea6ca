"""Host memory pool bound to the native bump allocator.

The port's ``tpu_radix_join/memory/pool.py``, the Python face of
``native/pool.cc`` (hpcjoin's ``memory/Pool.{h,cpp}``: one region, 64-byte
aligned bump allocation, overflow allocations past it, reset).
:meth:`Pool.get_array` hands out numpy views into the region that keep the
pool alive, so staging buffers are allocated once and reused chunk after
chunk.  :meth:`Pool.pin` page-locks the region once
(``cudaHostRegister``), so copies from it to the card run asynchronously;
:meth:`Pool.close` unregisters it before the region is freed.  Overflow
allocations past the region are not pinned (CUDA stages a copy from one
through its own buffer, synchronously).

Unlike the JAX package there is no numpy fallback: a failed native build
raises (native/build.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpu_radix_join_torch.native.build import load


class Pool:
    """Aligned bump allocator over one native region of
    ``capacity_bytes`` (rounded up to whole pages)."""

    def __init__(self, capacity_bytes: int):
        self._lib = load()
        self._handle = None
        self._pinned = False
        self.capacity = int(capacity_bytes)
        self._handle = self._lib.pool_create(self.capacity)
        if not self._handle:
            raise MemoryError(f"pool_create({self.capacity}) failed")

    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def pinned(self) -> bool:
        return self._pinned

    def _live(self):
        if self._handle is None:
            raise ValueError("the pool is closed")
        return self._handle

    def get_array(self, shape, dtype=np.uint32) -> np.ndarray:
        """A numpy array backed by pool memory (``Pool::getMemory``).  The
        array keeps the Pool alive through its buffer, so a view never
        dangles after the Pool object is collected; only :meth:`reset` or
        :meth:`close` invalidates it."""
        dtype = np.dtype(dtype)
        n_bytes = int(np.prod(shape)) * dtype.itemsize
        ptr = self._lib.pool_get_memory(self._live(), max(n_bytes, 1))
        if not ptr:
            raise MemoryError(f"pool_get_memory({n_bytes}) failed")
        # ctypes array instances take attributes: pin the Pool to the
        # buffer object numpy keeps as the array's base
        buf_cls = type("PoolBuf", ((ctypes.c_uint8 * n_bytes),), {})
        buf = buf_cls.from_address(ptr)
        buf._pool_keepalive = self
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def used(self) -> int:
        return self._lib.pool_used(self._live())

    def region(self):
        """(base address, bytes) of the pool's page-aligned region."""
        h = self._live()
        return self._lib.pool_base(h), self._lib.pool_capacity(h)

    def pin(self) -> None:
        """Page-lock the region for asynchronous copies to the card, once
        (a second call, or one after :meth:`reset`, does nothing)."""
        if self._pinned:
            return
        import torch
        base, size = self.region()
        err = torch.cuda.cudart().cudaHostRegister(base, size, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of the pool's {size} "
                               f"bytes failed: {err}")
        self._pinned = True

    def reset(self) -> None:
        """Rewind (``Pool::reset``): arrays returned so far become invalid.
        The region stays pinned."""
        self._lib.pool_reset(self._live())

    def close(self) -> None:
        """Unregister a pinned region, then free it (idempotent)."""
        if self._handle is None:
            return
        if self._pinned:
            import torch
            base, _ = self.region()
            torch.cuda.cudart().cudaHostUnregister(base)
            self._pinned = False
        self._lib.pool_destroy(self._handle)
        self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
