"""Join primitives: histogram, sorts, the merge-count probe, the
build/probe (counting and materializing) and the one-device joins."""

from tpu_radix_join_torch.ops.build_probe import (MaterializedMatches,
                                                  probe_count,
                                                  probe_count_bucketized,
                                                  probe_materialize,
                                                  probe_materialize_chunked)
from tpu_radix_join_torch.ops.local_join import (local_join_merge,
                                                 local_join_partitioned,
                                                 local_join_sorted)
from tpu_radix_join_torch.ops.radix import (local_histogram,
                                            reorder_by_partition,
                                            scatter_to_blocks)

__all__ = [
    "MaterializedMatches",
    "local_histogram",
    "local_join_merge",
    "local_join_partitioned",
    "local_join_sorted",
    "probe_count",
    "probe_count_bucketized",
    "probe_materialize",
    "probe_materialize_chunked",
    "reorder_by_partition",
    "scatter_to_blocks",
]
