"""Tuple layout, relation generation and chunk streams."""

from tpu_radix_join_torch.data.relation import Relation
from tpu_radix_join_torch.data.streaming import (stream_chunks,
                                                 stream_chunks_device)
from tpu_radix_join_torch.data.tuples import CompressedBatch, TupleBatch

__all__ = ["CompressedBatch", "Relation", "TupleBatch", "stream_chunks",
           "stream_chunks_device"]
