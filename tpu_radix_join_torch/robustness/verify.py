"""The classified data-corruption error.

``DataCorruption`` of ``tpu_radix_join/robustness/verify.py``: the out-of-core
grid raises it when a key lane reaches the reserved pad range, the signature
of a damaged streamed lane.  The checksums of integrity verification
(``JoinConfig.verify``) are ROADMAP A15.
"""

from __future__ import annotations

from tpu_radix_join_torch.robustness.retry import DATA_CORRUPTION


class DataCorruption(ValueError):
    """Input or intermediate data failed an integrity check; carries the
    machine-readable failure class."""

    failure_class = DATA_CORRUPTION
