"""Typed runtime configuration of the port.

The port's own copy of the fields of ``tpu_radix_join/core/config.py`` that
the single-GPU sort-probe join reads, each with the JAX package's default.
A setting the port does not run yet raises ``NotImplementedError`` naming
the ROADMAP item that will port it; nothing falls back quietly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: the kernels' shared bins hold 128 partitions (csrc/histogram.cu,
#: csrc/merge_scan.cu)
MAX_NETWORK_FANOUT_BITS = 7


def _not_ported(setting: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{setting} is not ported to PyTorch yet (ROADMAP.md {item})")


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Knobs of the single-GPU join.

      * ``network_fanout_bits`` -> NETWORK_PARTITIONING_FANOUT
        (Configuration.h:30): the join reports 1 << bits partition counts.
      * ``key_range``: "auto" decides per join from the relations' key
        bounds (or the device max key for raw lanes); "narrow" always takes
        the packed 31-bit probe and flags larger keys.
      * ``sort_impl``: the port has one sort (K2), so only "auto".
      * ``max_retries``: capacity-shortfall retries; the single-node sort
        probe has no capacity to fall short, so it never retries.
    """

    network_fanout_bits: int = 5
    num_nodes: int = 1
    key_bits: int = 32
    key_range: str = "auto"
    probe_algorithm: str = "sort"
    sort_impl: str = "auto"
    max_retries: int = 0
    two_level: bool = False
    verify: str = "off"
    skew_threshold: Optional[float] = None

    def __post_init__(self):
        if self.network_fanout_bits < 0:
            raise ValueError("fanout bits must be non-negative")
        if self.network_fanout_bits > MAX_NETWORK_FANOUT_BITS:
            raise _not_ported(
                f"network_fanout_bits={self.network_fanout_bits} (the "
                f"kernels hold {1 << MAX_NETWORK_FANOUT_BITS} partitions)",
                "queue A, wider fanout")
        if self.num_nodes < 1:
            raise ValueError("num_nodes must be >= 1")
        if self.num_nodes > 1:
            raise _not_ported(f"num_nodes={self.num_nodes}",
                              "A7, the distributed main path")
        if self.key_bits not in (32, 64):
            raise ValueError("key_bits must be 32 or 64")
        if self.key_bits == 64:
            raise _not_ported("key_bits=64", "A9")
        if self.key_range not in ("auto", "narrow", "full"):
            raise ValueError(f"unknown key range mode {self.key_range!r}")
        if self.key_range == "full":
            raise _not_ported("key_range='full'", "A9")
        if self.probe_algorithm not in ("sort", "bucket"):
            raise ValueError(
                f"unknown probe algorithm {self.probe_algorithm!r}")
        if self.probe_algorithm == "bucket":
            raise _not_ported("probe_algorithm='bucket'", "A11")
        if self.two_level:
            raise _not_ported("two_level=True", "A11")
        if self.sort_impl != "auto":
            raise ValueError(
                f"unknown sort impl {self.sort_impl!r}: the port has one "
                "sort, the K2 radix sort ('auto')")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.verify not in ("off", "check", "repair"):
            raise ValueError(f"unknown verify mode {self.verify!r}")
        if self.verify != "off":
            raise _not_ported(f"verify={self.verify!r}", "A15")
        if self.skew_threshold is not None:
            raise _not_ported("skew_threshold", "A10")

    @property
    def network_partition_count(self) -> int:
        """NETWORK_PARTITIONING_COUNT = 1 << FANOUT (Configuration.h:33)."""
        return 1 << self.network_fanout_bits
