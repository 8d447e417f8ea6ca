"""PyTorch + CUDA port of tpu_radix_join: the joins — the sort probe
(narrow, full-range and 64-bit keys) and the partitioned (bucket /
two-level) join with its chunked fallback, and the materializing join
(``HashJoin.join_materialize``: the rid pairs) — on one GPU or over a
``torch.distributed`` process group of N (``parallel/multihost.py``,
``HashJoin(config, group=...)``) with a raw, bit-packed or staged
exchange and optional integrity verification and repair, and the
out-of-core grid (``ops/chunked.py``).

The JAX package ``tpu_radix_join`` stays the reference; this package imports
nothing of it (nor JAX).  Lanes are ``torch.int32`` tensors holding uint32
bit patterns (data/tuples.py).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where every kernel takes its plain PyTorch
version.
"""

from tpu_radix_join_torch.core.config import JoinConfig
from tpu_radix_join_torch.data.relation import Relation
from tpu_radix_join_torch.data.tuples import TupleBatch
from tpu_radix_join_torch.operators.hash_join import (HashJoin, JoinResult,
                                                     MaterializedJoinResult)
from tpu_radix_join_torch.state import batch_from_numpy, from_jax_state

__all__ = ["HashJoin", "JoinConfig", "JoinResult", "MaterializedJoinResult",
           "Relation", "TupleBatch", "batch_from_numpy", "from_jax_state"]
