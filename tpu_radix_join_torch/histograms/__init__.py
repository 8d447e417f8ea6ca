"""Histograms and the partition → rank assignment.

Counterpart of ``tpu_radix_join/histograms/`` (``compute_local_histogram``,
``compute_global_histogram``, ``compute_partition_assignment``,
``compute_offsets``).
"""

from tpu_radix_join_torch.histograms.assignment_map import (
    compute_partition_assignment, load_aware_assignment,
    round_robin_assignment)
from tpu_radix_join_torch.histograms.local_histogram import (
    compute_global_histogram, compute_local_histogram)
from tpu_radix_join_torch.histograms.offset_map import (Offsets,
                                                        compute_offsets)

__all__ = ["Offsets", "compute_global_histogram", "compute_local_histogram",
           "compute_offsets",
           "compute_partition_assignment", "load_aware_assignment",
           "round_robin_assignment"]
