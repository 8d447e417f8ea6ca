"""Atomic checkpoint and resume for the out-of-core grid.

The port's copy of ``CheckpointMismatch``, ``CheckpointManager``,
``AsyncCheckpointWriter`` and ``PartitionManifest`` of
``tpu_radix_join/robustness/checkpoint.py`` (``:46-460``), with the same
file formats, so a checkpoint or manifest written by either package reads
in the other.  A grid checkpoint is one JSON object::

    {"<cursor and count fields>", "done": bool, "fingerprint": {...}}

  * Writes go to ``<path>.tmp.<pid>``, then ``fsync`` and ``os.replace``: a
    reader never sees a torn file.
  * ``load`` raises :class:`CheckpointMismatch` when the saved fingerprint
    differs from the run's; an unreadable file restarts from zero.
  * A failed save is swallowed into a ``checkpoint_save_failed`` event: the
    run loses one resume point, not the join.

Counters: ``CKPTSAVE`` per file written, ``CKPTLOAD`` per resume.

:class:`PartitionManifest` is the per-partition completion log of a join
(JSONL: a fingerprint header, then one line a realized partition), which
``HashJoin`` appends to after each successful join when one is attached
(``--elastic on --checkpoint-dir``, ``JoinSession(partition_manifest=)``);
``CKPTSAVE`` counts its lines too.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
from typing import Dict, Optional

from tpu_radix_join_torch.performance.measurements import CKPTLOAD, CKPTSAVE
from tpu_radix_join_torch.robustness import faults as _faults
from tpu_radix_join_torch.robustness.retry import CHECKPOINT_MISMATCH


class CheckpointMismatch(ValueError):
    """The checkpoint's fingerprint or grid extent is not this run's."""

    failure_class = CHECKPOINT_MISMATCH


class CheckpointManager:
    """One checkpoint file and its fingerprint guard."""

    def __init__(self, path: str, fingerprint: dict, measurements=None):
        self.path = path
        self.fingerprint = fingerprint
        self.measurements = measurements

    def _span(self, name: str):
        m = self.measurements
        return m.span(name) if m is not None else contextlib.nullcontext()

    def load(self) -> Optional[dict]:
        """The saved state (with ``done``), or None when there is nothing
        valid to resume from; raises :class:`CheckpointMismatch` on a
        fingerprint conflict."""
        m = self.measurements
        if not os.path.exists(self.path):
            return None
        try:
            with self._span("ckpt_load"):
                _faults.check(_faults.CKPT_LOAD, m)
                with open(self.path) as f:
                    state = json.load(f)
                saved_fp = state.pop("fingerprint")
        except (json.JSONDecodeError, KeyError, OSError) as e:
            if m is not None:
                m.event("checkpoint_corrupt", path=self.path, error=repr(e))
            return None
        if saved_fp != self.fingerprint:
            raise CheckpointMismatch(
                f"checkpoint {self.path} belongs to a different join "
                f"({saved_fp} != {self.fingerprint}); remove it or use a "
                f"distinct fingerprint/tag")
        if m is not None:
            m.incr(CKPTLOAD)
            m.event("checkpoint_load", path=self.path,
                    done=bool(state.get("done")))
        return state

    def save(self, state: dict, done: bool = False,
             span: str = "ckpt_save") -> bool:
        """Atomically write ``state`` with ``done`` and the fingerprint;
        False (and an event) on an I/O error.  ``span``: "ckpt_save" on the
        critical path, "ckpt_flush" from the write-behind thread."""
        m = self.measurements
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with self._span(span):
                _faults.check(_faults.CKPT_SAVE, m)
                with open(tmp, "w") as f:
                    json.dump({**state, "done": done,
                               "fingerprint": self.fingerprint}, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
        except OSError as e:
            if m is not None:
                m.event("checkpoint_save_failed", path=self.path,
                        error=repr(e))
            with contextlib.suppress(OSError):
                os.remove(tmp)
            return False
        if m is not None:
            m.incr(CKPTSAVE)
        return True


class AsyncCheckpointWriter:
    """Write-behind saves for a :class:`CheckpointManager`: ``save()``
    queues the state and returns; one daemon thread writes it.  The queue
    holds one state (the newest wins: it covers every pair the older one
    did), callers queue only states whose pairs are resolved, and
    :meth:`flush` returns once every queued state is on disk."""

    def __init__(self, manager: CheckpointManager):
        self._mgr = manager
        self._cond = threading.Condition()
        self._pending = None          # (state, done) or None
        self._busy = False
        self._stop = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="ckpt-write-behind", daemon=True)
        self._thread.start()
        # a clean exit between save() and flush() must not drop the last
        # state with the daemon thread
        atexit.register(self.close)

    def save(self, state: dict, done: bool = False) -> None:
        with self._cond:
            self._pending = (dict(state), done)
            self._cond.notify_all()

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._pending is None:
                    return
                state, done = self._pending
                self._pending = None
                self._busy = True
            try:
                self._mgr.save(state, done=done, span="ckpt_flush")
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def flush(self) -> None:
        """Return once every state queued before the call is written (or
        recorded as a failed save)."""
        with self._cond:
            while self._pending is not None or self._busy:
                self._cond.wait()

    def close(self) -> None:
        """Flush and stop the thread; idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cond.notify_all()
        self._thread.join()
        atexit.unregister(self.close)


class PartitionManifest:
    """Append-only per-partition completion manifest (elastic recovery).

    Extends the checkpoint discipline from "one cursor per grid run" to
    *partition granularity*: one JSONL line per realized network
    partition —

        {"fingerprint": {...}, "schema": 1}          # header line
        {"partition": 3, "count": 4096, "owner": 1, "epoch": 0}
        ...

    Rules carried over from :class:`CheckpointManager`:

      * **Kill-never-overclaims** — callers append a line only AFTER the
        partition's count is realized on host; the last line of a
        killed writer may be torn and is skipped on read, so the
        manifest never claims unrealized work.
      * **Fingerprint guard** — the header binds the manifest to one
        (inputs, geometry) identity; a conflicting header raises
        :class:`CheckpointMismatch` (resuming counts from a different
        join would splice wrong totals), a corrupt header restarts from
        zero.
      * **Durability beats availability** — a failed append is swallowed
        into a ``manifest_append_failed`` event (the run loses one
        resume point, not its life).

    Recovery reads :meth:`completed` to skip every realized partition and
    recompute exactly the lost rank's unfinished ones
    (robustness/recovery.py; the engine records,
    ``HashJoin._manifest_record``); the
    ``owner``/``epoch`` stamps make the recovery timeline reconstructible
    in post-mortem bundles.

    **Fencing (hedge-never-double-counts)** — per partition, a line at a
    strictly newer epoch supersedes (a partition re-realized after a
    membership change owns its new count), but within one epoch the
    FIRST writer wins: when a straggler hedge (robustness/straggler.py)
    realizes a partition before its slow original owner does, the
    original's late line is dead on arrival — read-side arbitration, so
    two uncoordinated appenders can never sum the same partition twice.
    :meth:`claim` records hedge intent (forensics + the HEDGEWIN /
    SPECWASTE split); the *done* line remains the only count arbiter.
    """

    def __init__(self, path: str, fingerprint: dict, measurements=None):
        self.path = path
        self.fingerprint = fingerprint
        self.measurements = measurements
        self._ensure_header()

    def _ensure_header(self) -> None:
        m = self.measurements
        header = None
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    header = json.loads(f.readline())
            except (OSError, json.JSONDecodeError) as e:
                if m is not None:
                    m.event("manifest_corrupt", path=self.path,
                            error=repr(e))
                header = None
        if header is not None:
            if header.get("fingerprint") != self.fingerprint:
                raise CheckpointMismatch(
                    f"partition manifest {self.path} belongs to a different "
                    f"join ({header.get('fingerprint')} != "
                    f"{self.fingerprint}); remove it or use a distinct "
                    f"fingerprint/tag")
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"fingerprint": self.fingerprint, "schema": 1}, f)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError as e:
            if m is not None:
                m.event("manifest_init_failed", path=self.path,
                        error=repr(e))
            try:
                os.remove(tmp)
            except OSError:
                pass

    def mark_done(self, partition: int, count: int, owner: int,
                  epoch: int = 0) -> bool:
        """Append one realized-partition line; False (after an event) on
        I/O failure instead of raising."""
        m = self.measurements
        rec = {"partition": int(partition), "count": int(count),
               "owner": int(owner), "epoch": int(epoch)}
        try:
            with open(self.path, "a") as f:
                json.dump(rec, f)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            if m is not None:
                m.event("manifest_append_failed", path=self.path,
                        error=repr(e))
            return False
        if m is not None:
            m.incr(CKPTSAVE)
        return True

    def mark_many(self, counts: Dict[int, int], owner_of, epoch: int = 0
                  ) -> int:
        """Bulk append (join epilogue: every partition realized at once).
        ``owner_of(p)`` maps a partition to its owner rank.  Returns the
        number of lines written."""
        n = 0
        for p, c in counts.items():
            if self.mark_done(p, c, owner_of(p), epoch):
                n += 1
        return n

    def completed(self) -> Dict[int, dict]:
        """``{partition: {"count", "owner", "epoch"}}`` of every realized
        partition; torn/corrupt lines are skipped — the
        kill-never-overclaims read side.  Arbitration per partition: a
        strictly newer epoch supersedes, and within one epoch the first
        writer wins (the hedge fence — a late-finishing original can
        never displace the speculative count that already landed)."""
        out: Dict[int, dict] = {}
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return out
        for line in lines[1:]:
            try:
                rec = json.loads(line)
                if "count" not in rec:
                    continue        # claim line, not a done line
                p = int(rec["partition"])
                ep = int(rec.get("epoch", 0))
                if p in out and ep <= out[p]["epoch"]:
                    continue        # first writer already won this epoch
                out[p] = {"count": int(rec["count"]),
                          "owner": int(rec["owner"]), "epoch": ep}
            except (ValueError, KeyError, json.JSONDecodeError):
                continue
        return out

    # ------------------------------------------------------------- claims
    def claim(self, partition: int, owner: int, epoch: int = 0) -> bool:
        """Record hedge intent on a partition; returns True when this
        ``(owner, epoch)`` holds the claim (first claimant at the highest
        epoch), False when a rival claimed it first or the partition is
        already done at ``epoch`` or newer.  Claims are advisory — they
        split HEDGEWIN from SPECWASTE and render in the post-mortem
        timeline — while the *done*-line fence in :meth:`completed`
        remains the count arbiter, so a lost claim race can waste work
        but never double-count."""
        m = self.measurements
        done = self.completed().get(int(partition))
        if done is not None and done["epoch"] >= int(epoch):
            return False
        holder = self.claims().get(int(partition))
        if holder is not None and holder["epoch"] >= int(epoch):
            return (holder["owner"] == int(owner)
                    and holder["epoch"] == int(epoch))
        rec = {"partition": int(partition), "claim": True,
               "owner": int(owner), "epoch": int(epoch)}
        try:
            with open(self.path, "a") as f:
                json.dump(rec, f)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            if m is not None:
                m.event("manifest_append_failed", path=self.path,
                        error=repr(e))
            return False
        if m is not None:
            m.event("hedge_claim", partition=int(partition),
                    owner=int(owner), epoch=int(epoch))
        return True

    def claims(self) -> Dict[int, dict]:
        """``{partition: {"owner", "epoch"}}`` of every claimed partition,
        arbitrated like :meth:`completed` (newer epoch supersedes, first
        claimant wins within an epoch)."""
        out: Dict[int, dict] = {}
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return out
        for line in lines[1:]:
            try:
                rec = json.loads(line)
                if not rec.get("claim"):
                    continue
                p = int(rec["partition"])
                ep = int(rec.get("epoch", 0))
                if p in out and ep <= out[p]["epoch"]:
                    continue
                out[p] = {"owner": int(rec["owner"]), "epoch": ep}
            except (ValueError, KeyError, json.JSONDecodeError):
                continue
        return out

    def audit(self) -> dict:
        """The double-count audit the chaos soak asserts on: the fenced
        total (sum of winning counts), plus every partition where a
        second writer's same-epoch line was fenced out — absorbed
        double-count attempts, each one a would-have-been wrong total."""
        winners = self.completed()
        fenced: Dict[int, int] = {}
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            lines = []
        for line in lines[1:]:
            try:
                rec = json.loads(line)
                if "count" not in rec:
                    continue
                p = int(rec["partition"])
                win = winners.get(p)
                if (win is not None and int(rec.get("epoch", 0)) == win["epoch"]
                        and int(rec["owner"]) != win["owner"]):
                    fenced[p] = fenced.get(p, 0) + 1
            except (ValueError, KeyError, json.JSONDecodeError):
                continue
        return {"total": sum(rec["count"] for rec in winners.values()),
                "partitions": len(winners),
                "fenced_duplicates": fenced}
