"""Host memory: the native pool allocator behind the host-fed chunk
stream (data/streaming.py)."""

from tpu_radix_join_torch.memory.pool import Pool

__all__ = ["Pool"]
