"""Straggler detection and the accounting of a speculative hedge.

The port's copy of ``tpu_radix_join/robustness/straggler.py``: host code
with nothing of the device in it.

Rank loss (robustness/membership.py) has a twin the lease machinery must
not catch: a rank that is alive, heartbeating on time, but slow.  Declaring
it dead would be wrong, and waiting for it stretches the join's tail.  The
remedy is a *hedge*: recompute the straggler's unfinished partitions out of
band (the masked out-of-core grid recovery uses, K2 and K6 on the card)
while the original runs on, and let the
:class:`~tpu_radix_join_torch.robustness.checkpoint.PartitionManifest`'s
first-writer-wins fence decide: whichever writer realises a partition first
owns its count, so a hedge never counts a partition twice.

Detection is *relative progress*: every lease beat carries
``partitions_done`` (the rank's manifest progress), and a rank straggles
when its progress falls below ``threshold`` x the live median while it
still owes at least ``min_outstanding`` partitions.  The verdict must hold
for ``dwell_checks`` consecutive observations (one slow poll never launches
a hedge), and ties break to the smallest rank, so every rank's detector
names the same suspect.

Counters: ``HEDGED`` a hedge launched, ``HEDGEWIN`` a hedged partition
whose speculative count won the fence, ``SPECWASTE`` a hedged partition
whose original landed first (the wasted speculation ``hedge="auto"``
backs off on).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Mapping, Optional

from tpu_radix_join_torch.performance.measurements import HEDGEWIN, SPECWASTE


class StragglerDetected(RuntimeError):
    """A live rank fell below the relative-progress threshold.

    Control flow, not a failure: the elastic wrapper absorbs it into the
    hedge path (the straggler stays a member — nothing is declared lost,
    no epoch bumps).  Raised only when hedging is enabled."""

    def __init__(self, rank: int, epoch: int, progress: int,
                 median: float, outstanding: int):
        super().__init__(
            f"rank {rank} straggling at epoch {epoch}: progress {progress} "
            f"< threshold x median {median:.1f} with {outstanding} "
            f"partition(s) outstanding — hedging its unfinished work")
        self.rank = int(rank)
        self.epoch = int(epoch)
        self.progress = int(progress)
        self.median = float(median)
        self.outstanding = int(outstanding)


@dataclasses.dataclass(frozen=True)
class StragglerVerdict:
    """One confirmed detection (post-dwell)."""

    rank: int
    progress: int
    median: float
    outstanding: int

    def to_exc(self, epoch: int) -> StragglerDetected:
        return StragglerDetected(self.rank, epoch, self.progress,
                                 self.median, self.outstanding)


class StragglerDetector:
    """Relative-progress straggler detector (see module docstring).

    ``observe`` is pure w.r.t. its inputs plus a small dwell state:
    callers feed ``{rank: partitions_done}`` (only ranks with known
    progress, i.e. ``partitions_done >= 0`` leases) and
    ``{rank: partitions_outstanding}``; the same suspect must survive
    ``dwell_checks`` consecutive calls before a verdict is returned.
    """

    def __init__(self, threshold: float = 0.5, min_outstanding: int = 2,
                 dwell_checks: int = 2):
        if not 0.0 < threshold < 1.0:
            raise ValueError(f"threshold must be in (0, 1), got {threshold}")
        if dwell_checks < 1:
            raise ValueError(f"dwell_checks must be >= 1, got {dwell_checks}")
        self.threshold = float(threshold)
        self.min_outstanding = int(min_outstanding)
        self.dwell_checks = int(dwell_checks)
        self._suspect: Optional[int] = None
        self._streak = 0

    def reset(self) -> None:
        self._suspect = None
        self._streak = 0

    def observe(self, progress: Mapping[int, int],
                outstanding: Mapping[int, int]
                ) -> Optional[StragglerVerdict]:
        """One detection poll; returns a verdict only once the same rank
        has been the suspect for ``dwell_checks`` consecutive calls."""
        if len(progress) < 2:
            self.reset()            # no peers to be relative to
            return None
        med = statistics.median(progress.values())
        if med <= 0:
            self.reset()            # nobody has progressed: too early
            return None
        # ties break to the smallest rank so every process's detector
        # converges on the same suspect (no-coordinator discipline)
        slowest = min(sorted(progress), key=lambda r: progress[r])
        behind = progress[slowest] < self.threshold * med
        todo = int(outstanding.get(slowest, 0))
        if not behind or todo < self.min_outstanding:
            self.reset()
            return None
        if slowest != self._suspect:
            self._suspect, self._streak = slowest, 0
        self._streak += 1
        if self._streak < self.dwell_checks:
            return None
        return StragglerVerdict(rank=slowest, progress=int(progress[slowest]),
                                median=float(med), outstanding=todo)


def board_progress(board, ranks) -> Dict[int, int]:
    """Per-rank ``partitions_done`` from live leases (the heartbeat
    metadata side of the progress clock); ranks whose lease carries no
    progress (-1) are omitted — the detector only compares ranks that
    export a clock."""
    out: Dict[int, int] = {}
    for r, lease in board.snapshot(ranks).items():
        if lease.partitions_done >= 0:
            out[int(r)] = int(lease.partitions_done)
    return out


def unfinished_partitions(num_partitions: int, owner_of, rank: int,
                          manifest=None) -> List[int]:
    """The partitions ``owner_of(p) == rank`` still owes — the hedge's
    work list (everything the straggler owns minus what the manifest
    already shows realized by anyone)."""
    done = set(manifest.completed()) if manifest is not None else set()
    return [p for p in range(num_partitions)
            if owner_of(p) == rank and p not in done]


def score_hedge(manifest, hedged_partitions, straggler: int,
                measurements=None) -> Dict[str, int]:
    """Post-hedge accounting against the manifest fence: for every hedged
    partition, the winning ``owner`` decides whether the speculation won
    (``HEDGEWIN``: someone other than the straggler holds the count) or
    was wasted (``SPECWASTE``: the original landed first).  Partitions
    with no winner yet count as wins-in-waiting for neither."""
    winners = manifest.completed()
    win = waste = 0
    for p in hedged_partitions:
        rec = winners.get(int(p))
        if rec is None:
            continue
        if int(rec["owner"]) == int(straggler):
            waste += 1
        else:
            win += 1
    m = measurements
    if m is not None:
        if win:
            m.incr(HEDGEWIN, win)
        if waste:
            m.incr(SPECWASTE, waste)
    return {"hedgewin": win, "specwaste": waste}
