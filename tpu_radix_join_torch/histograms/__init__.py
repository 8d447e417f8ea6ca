"""Histograms and the partition → rank assignment.

Counterpart of ``tpu_radix_join/histograms/`` (``compute_local_histogram``,
``compute_global_histogram``, ``compute_partition_assignment``);
``offset_map`` comes with the distributed slice (ROADMAP.md A7).
"""

from tpu_radix_join_torch.histograms.assignment_map import (
    compute_partition_assignment, load_aware_assignment,
    round_robin_assignment)
from tpu_radix_join_torch.histograms.local_histogram import (
    compute_global_histogram, compute_local_histogram)

__all__ = ["compute_global_histogram", "compute_local_histogram",
           "compute_partition_assignment", "load_aware_assignment",
           "round_robin_assignment"]
