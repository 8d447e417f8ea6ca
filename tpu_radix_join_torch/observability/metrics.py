"""Live metrics sampler: a background heartbeat for a running join or a
serving session.

The port's copy of ``tpu_radix_join/observability/metrics.py``.  The
sampler writes one JSON line a tick to ``<rank>.metrics.jsonl``: host
RSS / VmSize, the card's allocator bytes, and a snapshot of the counter
registry, so progress and memory growth can be watched live (``tail -f``)
and read after a death (the last line is the state at death).  An
``extra=`` provider folds more into every tick: a serving session's SLO
and breaker state, a membership lease board's heartbeat (the lease is
written on the tick).

Discipline: the sampler is a daemon thread; it samples at once on start
(a short run still gets a line), never raises into the join (a failed
sample records its error and carries on), flushes every line (a kill loses
at most the current tick) and rotates its file at a size cap.

The device it reads is named (``device=``): the session's own card.  A
tick reads the caching allocator's counters (``torch.cuda.memory_stats``)
and the CUDA runtime's free / total bytes (``torch.cuda.mem_get_info``), host
queries that never synchronize the stream the join runs on.  On the card
a tick also carries the process's kernel launch counts
(``ops/kernels.launch_counts``, ``launches``): a fleet worker's last line
says which kernels it ran.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

METRICS_SUFFIX = ".metrics.jsonl"

#: rotation defaults: at the cap the live file becomes ``<path>.1`` (older
#: rotations shift to .2, .3, ..., the oldest past ``keep`` dropped) and
#: sampling continues into a fresh file
DEFAULT_ROTATE_BYTES = 16 << 20
DEFAULT_ROTATE_KEEP = 3


def host_memory() -> Dict[str, int]:
    """VmSize / VmRSS in bytes from /proc (empty off Linux)."""
    out: Dict[str, int] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmSize:", "VmRSS:")):
                    k, v = line.split(":", 1)
                    out[k] = int(v.split()[0]) * 1024
    except OSError:
        pass
    return out


def device_memory(device=None) -> Dict[str, int]:
    """The named card's memory in bytes: the caching allocator's bytes in
    use, reserved and peak (``device<i>_bytes_in_use``,
    ``device<i>_bytes_reserved``, ``device<i>_peak_bytes_in_use``) and the
    CUDA runtime's free and total bytes (``device<i>_free_bytes``,
    ``device<i>_total_bytes``).  Empty for the CPU or no device: the CPU
    has no allocator stats, as the JAX package's CPU backend has none."""
    import torch
    if device is None:
        return {}
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(i)
    free, total = torch.cuda.mem_get_info(i)
    return {f"device{i}_bytes_in_use":
            int(stats.get("allocated_bytes.all.current", 0)),
            f"device{i}_bytes_reserved":
            int(stats.get("reserved_bytes.all.current", 0)),
            f"device{i}_peak_bytes_in_use":
            int(stats.get("allocated_bytes.all.peak", 0)),
            f"device{i}_free_bytes": int(free),
            f"device{i}_total_bytes": int(total)}


class MetricsSampler:
    """Append-only JSONL heartbeat; ``start()`` / ``stop()`` or use as a
    context manager.  ``measurements`` (optional) contributes counter and
    timer snapshots and the epoch anchor, so samples align with the span
    timeline and ``meta["events"]``; ``device`` names the card whose
    memory every tick reads (None: no device block)."""

    def __init__(self, path: str, interval_s: float = 1.0,
                 measurements=None, extra=None, device=None,
                 rotate_bytes: int = DEFAULT_ROTATE_BYTES,
                 rotate_keep: int = DEFAULT_ROTATE_KEEP):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if extra is not None and not callable(extra):
            raise TypeError("extra must be a zero-arg callable or None")
        if rotate_bytes <= 0 or rotate_keep < 1:
            raise ValueError("rotate_bytes must be > 0 and rotate_keep >= 1")
        self.path = path
        self.interval_s = float(interval_s)
        self.rotate_bytes = int(rotate_bytes)
        self.rotate_keep = int(rotate_keep)
        self.rotations = 0
        self.measurements = measurements
        #: zero-arg provider merged into every tick (a session's SLO and
        #: breaker snapshot, a lease board's heartbeat)
        self.extra = extra
        self.device = device
        self.samples_written = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._file = None
        # sample() runs on the tick thread and on the caller's (start's
        # first line, stop's last); reentrant so _rotate can re-enter
        self._lock = threading.RLock()
        m = measurements
        self._epoch0 = (float(m.meta["epoch_s"])
                        if m is not None and "epoch_s" in m.meta
                        else time.time())
        self._mono0 = time.perf_counter()

    # --------------------------------------------------------------- sampling
    def _record(self) -> dict:
        rel_s = time.perf_counter() - self._mono0
        rec: dict = {
            "t_epoch_s": round(self._epoch0 + rel_s, 6),
            "t_rel_s": round(rel_s, 6),
        }
        try:
            rec["host"] = host_memory()
            rec["devices"] = device_memory(self.device)
            if rec["devices"]:
                # on the card: the process's kernel launches so far, so a
                # worker's heartbeat shows which kernels its queries ran
                from tpu_radix_join_torch.ops.kernels import launch_counts
                rec["launches"] = launch_counts()
            m = self.measurements
            if m is not None:
                lock = getattr(m, "_lock", None)
                with lock if lock is not None else contextlib.nullcontext():
                    rec["counters"] = dict(m.counters)
                    rec["times_us"] = {k: round(v, 1)
                                       for k, v in m.times_us.items()}
                rec["open_phases"] = sorted(m._starts)
                # mid-join ticks show the resolved wire plan's geometry
                # (meta["exchange_plan"]) before WIREBYTES lands
                c = rec["counters"]
                xp = m.meta.get("exchange_plan") or {}
                if c.get("WIREBYTES") or xp:
                    rec["exchange"] = {
                        "wirebytes": int(c.get("WIREBYTES", 0)),
                        "pack_ratio_pct": c.get(
                            "PACKRATIO", xp.get("pack_ratio_pct")),
                        "stages": c.get("XSTAGES", xp.get("stages")),
                        "planned_wire_bytes": xp.get("wire_bytes"),
                    }
            if self.extra is not None:
                rec.update(self.extra())
        except Exception as e:     # a tick must never kill the join
            rec["error"] = repr(e)
        return rec

    def sample(self) -> dict:
        """Take and write one sample (also the thread's tick)."""
        rec = self._record()
        with self._lock:
            f = self._file
            if f is not None:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                self.samples_written += 1
                try:
                    if f.tell() >= self.rotate_bytes:
                        self._rotate()
                except Exception:   # rotation must never kill the join
                    pass
        return rec

    def _rotate(self) -> None:
        """Size-cap rotation: live file -> .1, .k -> .(k+1), the rotation
        past ``rotate_keep`` dropped; sampling continues into a fresh
        live file."""
        with self._lock:
            f, self._file = self._file, None
            if f is not None:
                f.close()
            oldest = f"{self.path}.{self.rotate_keep}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for k in range(self.rotate_keep - 1, 0, -1):
                src = f"{self.path}.{k}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{k + 1}")
            if os.path.exists(self.path):
                os.replace(self.path, f"{self.path}.1")
            self._file = open(self.path, "a")
            self.rotations += 1

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "MetricsSampler":
        if self._thread is not None:
            return self
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._file = open(self.path, "a")
        self.sample()                       # a line however short the run
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-sampler")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:
                pass

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        try:
            self.sample()                   # the state at shutdown
        finally:
            with self._lock:
                f, self._file = self._file, None
                if f is not None:
                    f.close()

    def __enter__(self) -> "MetricsSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def load_samples(path: str, include_rotated: bool = False) -> list:
    """Read a ``.metrics.jsonl`` back; unparseable lines (a killed run's
    torn last write) are skipped.  ``include_rotated`` prepends the
    rotations (``<path>.N`` .. ``<path>.1``) oldest first."""
    paths = [path]
    if include_rotated:
        k = 1
        older = []
        while os.path.exists(f"{path}.{k}"):
            older.append(f"{path}.{k}")
            k += 1
        paths = list(reversed(older)) + paths
    out = []
    for p in paths:
        if p == path:
            f = open(p)        # a missing live file stays an error
        else:
            try:
                f = open(p)
            except OSError:
                continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    return out
