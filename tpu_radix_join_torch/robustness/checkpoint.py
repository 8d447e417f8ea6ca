"""Atomic checkpoint and resume for the out-of-core grid.

The port's copy of ``CheckpointMismatch``, ``CheckpointManager`` and
``AsyncCheckpointWriter`` of ``tpu_radix_join/robustness/checkpoint.py``
(``:46-227``), with the same file format, so a checkpoint written by either
package resumes in the other.  The file is one JSON object::

    {"<cursor and count fields>", "done": bool, "fingerprint": {...}}

  * Writes go to ``<path>.tmp.<pid>``, then ``fsync`` and ``os.replace``: a
    reader never sees a torn file.
  * ``load`` raises :class:`CheckpointMismatch` when the saved fingerprint
    differs from the run's; an unreadable file restarts from zero.
  * A failed save is swallowed into a ``checkpoint_save_failed`` event: the
    run loses one resume point, not the join.

Counters: ``CKPTSAVE`` per file written, ``CKPTLOAD`` per resume.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
from typing import Optional

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
