"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Every wrapper takes its kernel's plain PyTorch version for a tensor on the
CPU and launches the CUDA kernel (or raises) for a tensor on the card; there
is no fallback between the two.  Each launch on the card adds one to the
wrapper's entry in :data:`LAUNCHES`, so a run can show which kernels its
path went through.
"""

from __future__ import annotations

from typing import Dict

#: launches on the card per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"histogram": 0, "radix_histogram": 0,
                             "radix_pass": 0, "merge_scan": 0,
                             "partition": 0, "merge_scan_wide": 0,
                             "merge_scan_chunks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
