"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Every wrapper takes its kernel's plain PyTorch version for a tensor on the
CPU and launches the CUDA kernel (or raises) for a tensor on the card; there
is no fallback between the two.  Each launch on the card adds one to the
wrapper's entry in :data:`LAUNCHES`, so a run can show which kernels its
path went through.
"""

from __future__ import annotations

from typing import Dict

#: launches on the card per wrapper since the last :func:`reset_launches`:
#: each kernel path past the narrow kernels' shared bins counts under its
#: own name (``histogram_wide``, ``merge_scan_fanout``, ``merge_scan_wide_fanout``,
#: ``partition_wide``; ``partition_msd`` past the wide K4's groups), and
#: the ``baseline_*``
#: entries count the calls of the library arms a caller asked for by name
#: (``sort_impl="xla"``, ``partition_impl="sort"``) on either device
LAUNCHES: Dict[str, int] = {"histogram": 0, "radix_histogram": 0,
                             "radix_pass": 0, "merge_scan": 0,
                             "partition": 0, "merge_scan_wide": 0,
                             "merge_scan_chunks": 0, "histogram_wide": 0,
                             "merge_scan_fanout": 0,
                             "merge_scan_wide_fanout": 0,
                             "partition_wide": 0,
                             "partition_msd": 0, "baseline_sort": 0,
                             "baseline_partition": 0,
                             "baseline_histogram": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
