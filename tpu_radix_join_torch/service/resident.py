"""Device-resident sorted-union state for incremental delta-merge joins.

The port's copy of ``tpu_radix_join/service/resident.py``.  The manager
keeps each session relation's sorted inner key lane on the device under
an explicit byte budget, so a follow-up query that only appends Δ new
tuples sorts the Δ and splices it into the resident union
(ops/merge_delta.py :func:`merge_sorted`) instead of re-sorting all N+Δ
keys.

Budget discipline: ``budget_bytes`` caps the sum of the resident lanes'
``nbytes`` (``Tensor.nbytes``).  Admitting a lane that would exceed it
evicts least-recently-used lanes first; a lane larger than the whole
budget is not admitted (the query still runs, on the full path).
``RESBYTES`` holds the high-water mark of resident bytes, and the live
total is in :meth:`stats`.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Hashable, Optional, Tuple

from tpu_radix_join_torch.performance.measurements import RESBYTES


@dataclasses.dataclass
class _Resident:
    lane: object            # device lane, sorted ascending (torch.Tensor)
    nbytes: int
    epoch: Optional[int]    # membership epoch the lane was built under
    merges: int = 0         # delta merges absorbed since admission


class ResidentStateManager:
    """LRU-by-bytes pool of device-resident sorted key lanes.

    ``budget_bytes == 0`` disables residency: every get misses, every
    put drops — the session then always takes the full-sort path.
    Keys are caller-chosen hashables (the session uses the relation-spec
    tuple that also keys ``_place``); an epoch mismatch on get drops the
    lane, because a membership change re-partitions what each host
    generates.
    """

    def __init__(self, budget_bytes: int, measurements=None):
        if budget_bytes < 0:
            raise ValueError("budget_bytes must be >= 0")
        self.budget_bytes = budget_bytes
        self.measurements = measurements
        self._lanes: "OrderedDict[Hashable, _Resident]" = OrderedDict()
        self.resident_bytes = 0
        self.admitted = 0
        self.evicted = 0
        self.rejected = 0       # lanes larger than the whole budget
        self.merges = 0

    # ------------------------------------------------------------- lookup
    def get(self, key: Hashable,
            epoch: Optional[int] = None) -> Optional[object]:
        """The resident sorted lane for ``key``, or None.  A lane built
        under a different epoch is dropped, not served."""
        entry = self._lanes.get(key)
        if entry is None:
            return None
        if entry.epoch != epoch:
            self._drop(key)
            return None
        self._lanes.move_to_end(key)
        return entry.lane

    def put(self, key: Hashable, lane, epoch: Optional[int] = None) -> bool:
        """Admit (or replace) the sorted lane for ``key``; returns False
        when the lane alone exceeds the budget (nothing is evicted for a
        lane that cannot fit anyway)."""
        if self.budget_bytes == 0:
            return False
        nbytes = int(lane.nbytes)
        if nbytes > self.budget_bytes:
            self.rejected += 1
            return False
        if key in self._lanes:
            self._drop(key)
        while self.resident_bytes + nbytes > self.budget_bytes:
            victim = next(iter(self._lanes))
            self._drop(victim)
            self.evicted += 1
        self._lanes[key] = _Resident(lane=lane, nbytes=nbytes, epoch=epoch)
        self.resident_bytes += nbytes
        self.admitted += 1
        m = self.measurements
        if m is not None:
            # max-hold gauge (JDEPTH discipline): RESBYTES keeps the
            # high-water mark of resident bytes across the run
            cur = int(m.counters.get(RESBYTES, 0))
            if self.resident_bytes > cur:
                m.incr(RESBYTES, self.resident_bytes - cur)
        return True

    def note_merge(self, key: Hashable) -> None:
        """Record that ``key``'s lane absorbed one delta merge (the lane
        object itself was already replaced via :meth:`put`)."""
        self.merges += 1
        entry = self._lanes.get(key)
        if entry is not None:
            entry.merges += 1

    # ---------------------------------------------------------- lifecycle
    def _drop(self, key: Hashable) -> None:
        entry = self._lanes.pop(key, None)
        if entry is not None:
            self.resident_bytes -= entry.nbytes

    def invalidate(self, key: Optional[Hashable] = None) -> int:
        """Drop one lane (or all, key=None); returns how many went."""
        if key is not None:
            had = key in self._lanes
            self._drop(key)
            return 1 if had else 0
        n = len(self._lanes)
        self._lanes.clear()
        self.resident_bytes = 0
        return n

    def __len__(self) -> int:
        return len(self._lanes)

    def keys(self) -> Tuple[Hashable, ...]:
        return tuple(self._lanes)

    def stats(self) -> dict:
        """The residency counts (the session's ``fastpath_stats``)."""
        return {"lanes": len(self._lanes),
                "resident_bytes": self.resident_bytes,
                "budget_bytes": self.budget_bytes,
                "admitted": self.admitted, "evicted": self.evicted,
                "rejected": self.rejected, "merges": self.merges}
