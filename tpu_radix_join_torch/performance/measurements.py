"""Phase timers, counters and the ``.perf`` report of the port.

Counterpart of ``tpu_radix_join/performance/measurements.py``, the
reference's ``performance/Measurements.{h,cpp}``: a timer registry keyed by
the reference's tag vocabulary (JTOTAL, JHIST, JMPI, JPROC, SWINALLOC, ...),
counters, per-rank ``<rank>.perf`` / ``<rank>.info`` files in the JAX
package's layout (a directory written by either package loads in the
other), the rank-0 aggregate (:func:`print_results`) over a gather of every
rank's registry (:meth:`Measurements.gather_all`), the dispatch floor, the
memory probe and a profiler bracket (:meth:`Measurements.trace`,
performance/trace.py).

Device work is asynchronous: a timer that must include it is stopped with a
``fence`` (``torch.cuda.synchronize`` on the device of the fenced tensors;
nothing on the CPU), the counterpart of ``jax.block_until_ready``.  The join
engine fences only under ``measure_phases``; by default each timer stops at
a host readback the join already does.

The grid, the retry loop, the fault injector and the checkpoints also read
``span`` (host seconds per named span, ``span_s`` / ``span_n``), ``event``
(``events`` and ``meta["events"]``) and ``incr``, from several threads: the
registry's lock guards them.

As in the JAX registry (``measurements.py:216-340``), every ``start``,
``stop``, ``incr``, ``event`` and ``span`` is mirrored into the always-on
flight recorder (``flightrec``, observability/flightrec.py: the ring a
forensics bundle freezes and the idle clock the hang watchdog reads) and,
once :meth:`Measurements.attach_tracer` has run, into a span tracer
(observability/spans.py).  A record holds the host values the registry
already has (names, host-clock intervals, counter totals), so mirroring
adds no device readback.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from tpu_radix_join_torch.utils.hostsync import host_fence, host_readback

# Reference tag vocabulary (Measurements.cpp:136-142,176-178,351-368,533-542)
JTOTAL = "JTOTAL"          # end-to-end join wall time
JHIST = "JHIST"            # histogram phase (the sizing pass's execution)
JMPI = "JMPI"              # network partitioning phase
JPROC = "JPROC"            # local processing phase
SWINALLOC = "SWINALLOC"    # window allocation (sizing + kernel builds)
SNETCOMPL = "SNETCOMPL"    # network completion wait (nested in JMPI)
SLOCPREP = "SLOCPREP"      # local preparation (the second radix pass)
MWINWAIT = "MWINWAIT"      # time spent on superseded (undersized) attempts
JCOMPILE = "JCOMPILE"      # first-use kernel builds (no reference analog;
                           # kept out of every phase column)
SDISPATCH = "SDISPATCH"    # amortized round trip of one trivial launch and
                           # synchronize (a floor, not a cumulative phase)
CTOTAL = "CTOTAL"          # device busy time under Measurements.trace

_GATHER_BUF_BYTES = 1 << 16   # fixed all_gather slot per rank (gather_all)

# Detail tags (MEASUREMENT_DETAILS_* analogs)
RTUPLES = "RTUPLES"        # inner tuples joined (global)
STUPLES = "STUPLES"        # outer tuples joined (global)
RESULTS = "RESULTS"        # global match count
BPBUILD = "BPBUILD"        # bucket-path build (row sort) timer
BPPROBE = "BPPROBE"        # bucket-path probe (row scan) timer
BPBUILDTUPLES = "BPBUILDTUPLES"  # slots the build stage processed
BPPROBETUPLES = "BPPROBETUPLES"  # slots the probe stage processed
RETRIES = "RETRIES"        # capacity attempts superseded by a retry
MWINPUTCNT = "MWINPUTCNT"  # block transfers shuffled (MPI_Put count analog)
MWINBYTES = "MWINBYTES"    # shuffle bytes incl. padding (8 or 12 B a slot)
WIREBYTES = "WIREBYTES"    # bytes shipped under the codec (= MWINBYTES off)
PACKRATIO = "PACKRATIO"    # gauge: wire bytes as a percent of the raw lanes
XSTAGES = "XSTAGES"        # gauge: column groups per exchange (1 = fused)
WINCAPR = "WINCAPR"        # per-(sender, dest) block capacity, inner window
WINCAPS = "WINCAPS"        # per-(sender, dest) block capacity, outer window
FINJECT = "FINJECT"        # injected faults fired (robustness/faults.py)
RETRYN = "RETRYN"          # retry attempts (robustness/retry.py)
BACKOFFMS = "BACKOFFMS"    # total retry backoff slept, milliseconds
CKPTSAVE = "CKPTSAVE"      # checkpoints written (robustness/checkpoint.py)
CKPTLOAD = "CKPTLOAD"      # checkpoints resumed from
GRIDPAIRS = "GRIDPAIRS"    # chunk pairs probed by chunked_join_grid (a
                           # resumed run skips completed pairs)
PREFETCH = "PREFETCH"      # chunks staged by the grid's prefetch thread
SORTREUSE = "SORTREUSE"    # grid pair probes that reused the row's presorted
                           # inner chunk: rows x (cols - 1) on a full grid
VCHK = "VCHK"              # integrity verification's time (times only:
                           # its comparisons count under VCHKN)
VCHKN = "VCHKN"            # integrity checksum comparisons performed
VFAIL = "VFAIL"            # checksum mismatches found (robustness/verify.py)
VREPAIR = "VREPAIR"        # damaged partitions recomputed (verify="repair")
QADMIT = "QADMIT"          # queries admitted by the service queue
QREJECT = "QREJECT"        # queries rejected at admission (depth / quota)
QDEADLINE = "QDEADLINE"    # queries cancelled by their deadline
QWARM = "QWARM"            # warm queries (capacity-cache hit: no sizing pass)
QDEGRADED = "QDEGRADED"    # queries served by the degraded CPU engine
BRKTRIP = "BRKTRIP"        # circuit-breaker trips (closed/half-open -> open)
BRKPROBE = "BRKPROBE"      # half-open health probes dispatched
RCHIT = "RCHIT"            # result-cache hits (service/resultcache.py)
RCMISS = "RCMISS"          # result-cache misses (cold, TTL expiry, or a
                           # digest/epoch check dropping a stale entry)
BATCHN = "BATCHN"          # fused micro-batches dispatched as one program
BATCHQ = "BATCHQ"          # queries served through fused micro-batches
DELTAMERGE = "DELTAMERGE"  # queries served O(N+delta) by the delta merge
RESBYTES = "RESBYTES"      # gauge: high-water device-resident sorted-union
                           # bytes (service/resident.py)
PLANDRIFT = "PLANDRIFT"    # gauge: |actual - predicted| JTOTAL as a percent
                           # of the planner's prediction (planner/audit.py)
NCOMPILE = "NCOMPILE"      # first-use kernel builds and loads
                           # (observability/compilemon.py)
COMPILEMS = "COMPILEMS"    # their total milliseconds
MEPOCH = "MEPOCH"          # gauge: membership epoch (robustness/membership.py)
RANKLOST = "RANKLOST"      # ranks declared lost on a lease lapse
RANKJOIN = "RANKJOIN"      # ranks admitted from a ``joining`` lease
WDOGTRIP = "WDOGTRIP"      # hang-watchdog trips (observability/watchdog.py)
PMBUNDLE = "PMBUNDLE"      # forensics bundles written (observability/
                           # postmortem.py)
FAILOVER = "FAILOVER"      # fleet queries failed over to another worker after
                           # the routed worker died mid-query (service/fleet.py)
REPLAYN = "REPLAYN"        # journal intents replayed (failover retries plus
                           # restart-time unacknowledged-intent replay)
WINCARN = "WINCARN"        # fleet worker incarnations spawned (boot + restarts)
WRESTART = "WRESTART"      # dead-worker restarts (WINCARN minus the boot pool)
JDEPTH = "JDEPTH"          # gauge: peak unacknowledged query-journal depth
DOUBLEEXEC = "DOUBLEEXEC"  # fingerprints with >1 journaled outcome: the
                           # exactly-once invariant; any nonzero is a bug
RECOVERN = "RECOVERN"      # partitions recomputed by elastic recovery
                           # (robustness/recovery.py); below the partition
                           # count when the manifest resumed any
RECOVERMS = "RECOVERMS"    # elastic-recovery milliseconds (re-plan,
                           # regeneration, recompute and splice)
HEDGED = "HEDGED"          # straggler hedges launched (robustness/
                           # straggler.py)
HEDGEWIN = "HEDGEWIN"      # hedged partitions whose speculative count won
                           # the manifest's first-writer-wins fence
SPECWASTE = "SPECWASTE"    # hedged partitions whose original landed first
SORTPASS = "SORTPASS"      # sorts the K2 arm dispatched (ops/sorting.py); JAX
                           # ticks one a traced sort site, the port one a
                           # call: a join's K2 sorts
PARTPASS = "PARTPASS"      # groupings the K4 arm dispatched (ops/radix.py);
                           # one a call, as SORTPASS
JRATE = "JRATE"            # derived: (R+S) tuples / JTOTAL second
JPROCRATE = "JPROCRATE"    # derived: (R+S) tuples / JPROC second
HILOCRATE = "HILOCRATE"    # derived: inner tuples / JHIST second
HOLOCRATE = "HOLOCRATE"    # derived: outer tuples / JHIST second


def fence_tensors(tensors) -> None:
    """Wait for the device work that produces ``tensors`` (a tensor or a
    nested tuple/list of them): ``torch.cuda.synchronize`` on each CUDA
    device among them; nothing for CPU tensors, which are ready."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(tensors)
    for dev in devices:
        host_fence(dev)


class Measurements:
    """Per-rank measurement registry (``Measurements::init``,
    Measurements.cpp:707-749)."""

    def __init__(self, node_id: int = 0, num_nodes: int = 1,
                 tag: str = "experiment"):
        self.node_id = node_id
        self.num_nodes = num_nodes
        self.tag = tag
        self._starts: Dict[str, float] = {}
        self.times_us: Dict[str, float] = defaultdict(float)
        self.counters: Dict[str, int] = defaultdict(int)
        self.span_s: Dict[str, float] = defaultdict(float)
        self.span_n: Dict[str, int] = defaultdict(int)
        self.events: List[Tuple[str, dict]] = []
        self._lock = threading.Lock()
        self._tracer = None
        self._mono0 = time.perf_counter()
        self.meta: Dict[str, object] = {
            "host": socket.gethostname(),
            "node": node_id,
            "nodes": num_nodes,
            "epoch_s": time.time(),
        }
        # the always-on flight recorder, on the registry's clock anchors
        from tpu_radix_join_torch.observability.flightrec import (
            FlightRecorder)
        self.flightrec = FlightRecorder(epoch_s=self.meta["epoch_s"],
                                        mono_s=self._mono0)

    # ------------------------------------------------------ span tracer
    def attach_tracer(self, tracer=None, trace_id=None, **tags):
        """Attach (or build) a ``SpanTracer`` on this registry's clock
        anchors: every ``start`` / ``stop`` pair then mirrors into a
        timeline span and every :meth:`event` into an instant event.
        ``trace_id`` (one for every rank of a run) lands in the span file,
        ``meta["trace_id"]`` and the flight recorder's context.  Returns
        the tracer."""
        if tracer is None:
            from tpu_radix_join_torch.observability.spans import SpanTracer
            tracer = SpanTracer(rank=self.node_id, trace_id=trace_id,
                                tags=tags, epoch_s=self.meta["epoch_s"],
                                mono_s=self._mono0)
        self.meta["trace_id"] = tracer.trace_id
        self.flightrec.set_context(trace_id=tracer.trace_id)
        self._tracer = tracer
        return tracer

    @property
    def tracer(self):
        return self._tracer

    def set_trace_tags(self, **tags) -> None:
        """Stamp tags (plan strategy, engine, ...) onto future spans; a
        no-op without an attached tracer."""
        if self._tracer is not None:
            self._tracer.set_tags(**tags)

    # ------------------------------------------------------------ spans
    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Host seconds of a named span (grid pairs, prefetch waits,
        checkpoint writes, served queries), summed per name in ``span_s``;
        no ``times_us`` tag, so the ``.perf`` file stays bounded.  Mirrored
        into the ring (``span`` / ``span_end``) and the tracer."""
        self.flightrec.record("span", name, **args)
        t0 = time.perf_counter()
        try:
            if self._tracer is not None:
                with self._tracer.span(name, **args):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.span_s[name] += dt
                self.span_n[name] += 1
            self.flightrec.record("span_end", name)

    # ----------------------------------------------------------- timers
    def start(self, key: str) -> None:
        """Start a timer.  One clock reading serves the timer and the
        tracer's span, so a span's ``dur`` is the timer's interval."""
        now = time.perf_counter()
        self._starts[key] = now
        self.flightrec.record("begin", key)
        if self._tracer is not None:
            self._tracer.begin(key, at=now)

    def stop(self, key: str, fence=None) -> float:
        """Stop a timer and return its microseconds; ``fence`` (tensors)
        is waited for first, so the device work that produces them lands
        inside the timer.  The tracer's span ends at the same reading."""
        if fence is not None:
            fence_tensors(fence)
        now = time.perf_counter()
        dt = (now - self._starts.pop(key)) * 1e6
        with self._lock:
            self.times_us[key] += dt
        self.flightrec.record("end", key, us=round(dt, 1))
        if self._tracer is not None:
            self._tracer.end(key, at=now)
        return dt

    def add_time_us(self, key: str, us: float) -> None:
        with self._lock:
            self.times_us[key] += us

    def exclude_from_running(self, us: float) -> None:
        """Shift every running timer's start forward by ``us``: an interval
        that must not land in their columns (a first-use kernel build) is
        kept out of JTOTAL, SWINALLOC, ...; JCOMPILE keeps it."""
        for k in self._starts:
            self._starts[k] += us / 1e6

    def incr(self, key: str, by: int = 1) -> None:
        with self._lock:
            self.counters[key] += by
            total = self.counters[key]
        self.flightrec.record("incr", key, by=by, total=total)

    def event(self, name: str, **data) -> None:
        """Record an event: ``(name, data)`` in ``events``, and in
        ``meta["events"]`` (the ``<rank>.info`` JSON) with the monotonic
        ``t_s`` and its wall-clock twin ``t_epoch_s``, as the JAX registry
        writes them; values must be JSON-serializable."""
        now = time.perf_counter()
        with self._lock:
            self.events.append((name, data))
            self.meta.setdefault("events", []).append({
                "event": name, "t_s": round(now, 6),
                "t_epoch_s": round(self.meta["epoch_s"]
                                   + (now - self._mono0), 6),
                **data})
        self.flightrec.record("event", name, **data)
        if self._tracer is not None:
            self._tracer.instant(name, **data)

    # ----------------------------------------------- detail accumulators
    def record_exchange(self, num_nodes: int, cap_r: int, cap_s: int,
                        tuple_bytes: int = 8,
                        wire_bytes: Optional[int] = None,
                        pack_ratio_pct: Optional[float] = None,
                        stages: Optional[int] = None) -> None:
        """Shuffle counters (Measurements.cpp:272-349), derived from the
        static block geometry: per relation each rank ships ``num_nodes``
        blocks of ``capacity`` slots of ``tuple_bytes`` (8 for two lanes,
        12 with the hi key lane).  ``wire_bytes`` defaults to the raw
        bytes; ``pack_ratio_pct`` and ``stages`` are gauges (100 and 1 with
        the codec off and the fused exchange)."""
        self.incr(MWINPUTCNT, 2 * num_nodes)
        raw_bytes = tuple_bytes * num_nodes * (cap_r + cap_s)
        self.incr(MWINBYTES, raw_bytes)
        self.incr(WIREBYTES,
                  raw_bytes if wire_bytes is None else int(wire_bytes))
        with self._lock:
            if pack_ratio_pct is not None:
                self.counters[PACKRATIO] = int(round(pack_ratio_pct))
            if stages is not None:
                self.counters[XSTAGES] = int(stages)
            self.counters[WINCAPR] = cap_r
            self.counters[WINCAPS] = cap_s
        # the gauges bypass incr(): one ring record keeps the geometry
        self.flightrec.record(
            "gauge", "exchange", wirebytes=self.counters[WIREBYTES],
            pack_ratio_pct=self.counters.get(PACKRATIO),
            stages=self.counters.get(XSTAGES))

    def derive_rates(self) -> None:
        """Throughput tags (Measurements.cpp:251-260): tuples per second of
        JTOTAL and JPROC, and each side's tuples per second of JHIST."""
        tuples = self.counters.get(RTUPLES, 0) + self.counters.get(STUPLES, 0)
        for rate_key, time_key in ((JRATE, JTOTAL), (JPROCRATE, JPROC)):
            us = self.times_us.get(time_key, 0.0)
            if tuples and us > 0:
                self.counters[rate_key] = int(tuples / (us / 1e6))
        jh = self.times_us.get(JHIST, 0.0)
        if jh > 0:
            for rate_key, cnt_key in ((HILOCRATE, RTUPLES),
                                      (HOLOCRATE, STUPLES)):
                cnt = self.counters.get(cnt_key, 0)
                if cnt:
                    self.counters[rate_key] = int(cnt / (jh / 1e6))

    def measure_dispatch_floor(self, iters: int = 20,
                               device=None) -> float:
        """Record SDISPATCH: one trivial kernel launch plus a synchronize,
        amortized over ``iters`` — the floor each fenced phase column pays
        per launch.  ``device`` defaults to the current CUDA device, or the
        CPU without a card (where nothing is launched asynchronously).
        Stored as a floor (assignment); returns microseconds."""
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if torch.cuda.is_available() else torch.device("cpu"))
        device = torch.device(device)
        x = torch.zeros(8, dtype=torch.int32, device=device)
        fence_tensors(x + 1)   # first launch (context, module load) outside the loop
        t0 = time.perf_counter()
        for _ in range(iters):
            fence_tensors(x + 1)
        us = (time.perf_counter() - t0) / iters * 1e6
        self.times_us[SDISPATCH] = us
        return us

    # -------------------------------------------------- memory / tracing
    def memory_utilization(self) -> Dict[str, int]:
        """Host VmSize/VmRSS (Measurements.cpp:825-851) and each visible
        card's allocated and peak allocated bytes (``device<i>_bytes_in_use``,
        ``device<i>_peak_bytes_in_use``), in bytes; also in ``meta``."""
        out: Dict[str, int] = {}
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith(("VmSize:", "VmRSS:")):
                        k, v = line.split(":", 1)
                        out[k] = int(v.split()[0]) * 1024
        except OSError:   # non-Linux host
            pass
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                out[f"device{i}_bytes_in_use"] = int(
                    torch.cuda.memory_allocated(i))
                out[f"device{i}_peak_bytes_in_use"] = int(
                    torch.cuda.max_memory_allocated(i))
        self.meta["memory"] = out
        return out

    def trace(self, trace_dir: str):
        """Profiler bracket (the PAPI / CUDA-event analog,
        Measurements.cpp:90-107): ``torch.profiler`` with CPU and CUDA
        activities around the block, its Chrome trace exported into
        ``trace_dir``; on exit ``meta["trace"]`` holds the busiest
        timeline's per-op table (performance/trace.summarize_trace) and,
        where a CUDA timeline exists, ``times_us["CTOTAL"]`` the device's
        busy time (the union of its kernel, memset and memcpy intervals)."""
        from tpu_radix_join_torch.performance import trace as _trace

        @contextlib.contextmanager
        def _ctx():
            with _trace.profile(trace_dir, self.node_id):
                yield self
            summary = _trace.summarize_trace(trace_dir)
            if summary is not None:
                self.meta["trace"] = summary
                if _trace.is_device_plane(summary["plane"]):
                    self.times_us[CTOTAL] = summary["busy_us"]

        return _ctx()

    # ------------------------------------------------------------ output
    def lines(self):
        """Tagged key/value/unit lines of the reference's .perf format
        (Measurements.cpp:136-142)."""
        for k in sorted(self.times_us):
            yield f"{k}\t{self.times_us[k]:.0f}\tus"
        for k in sorted(self.counters):
            yield f"{k}\t{self.counters[k]}\tcount"

    def store(self, out_dir: str) -> str:
        """Write ``<rank>.perf`` and ``<rank>.info``
        (Measurements.cpp:707-770); returns the ``.perf`` path."""
        self.derive_rates()
        os.makedirs(out_dir, exist_ok=True)
        perf = os.path.join(out_dir, f"{self.node_id}.perf")
        with open(perf, "w") as f:
            for line in self.lines():
                f.write(line + "\n")
        with open(os.path.join(out_dir, f"{self.node_id}.info"), "w") as f:
            json.dump(self.meta, f, indent=2)
        return perf

    def summary(self) -> Dict[str, float]:
        self.derive_rates()
        return {**{k: v for k, v in self.times_us.items()},
                **{k: float(v) for k, v in self.counters.items()}}

    # ------------------------------------------------------- aggregation
    def _slim_meta(self) -> Dict[str, object]:
        """Stand-in for a meta too large for the gather slot: the fields
        the aggregate report reads survive (a truncated rank must not
        vanish from the FailureClasses line)."""
        slim: Dict[str, object] = {"truncated": True}
        for k in ("failure_class", "epoch_s"):
            if k in self.meta:
                slim[k] = self.meta[k]
        if isinstance(self.meta.get("events"), list):
            slim["events_count"] = len(self.meta["events"])
        return slim

    def gather_all(self, world=None) -> List["Measurements"]:
        """Every rank's registry, in rank order, on every rank (the
        reference's rank-0 gather, Measurements.cpp:548-590): each rank
        writes its registry as JSON into a fixed 64 KiB uint8 slot, and one
        ``world.all_gather`` hands every rank all of them — a CUDA tensor
        under NCCL, a CPU tensor under gloo.  Every rank must call it.  A
        world of one rank (or none) returns ``[self]``."""
        if world is None or world.size == 1:
            return [self]
        rec = {"node": self.node_id, "num_nodes": self.num_nodes,
               "times_us": self.times_us, "counters": self.counters,
               "meta": self.meta}
        payload = json.dumps(rec, default=str).encode()
        cap = _GATHER_BUF_BYTES - 4
        if len(payload) > cap:
            rec["meta"] = self._slim_meta()
            payload = json.dumps(rec, default=str).encode()
        if len(payload) > cap:
            raise ValueError(
                f"measurement payload ({len(payload)}B) exceeds the "
                f"{cap}B gather buffer even without meta")
        buf = bytearray(_GATHER_BUF_BYTES)
        buf[:4] = len(payload).to_bytes(4, "little")
        buf[4:4 + len(payload)] = payload
        slot = torch.frombuffer(buf, dtype=torch.uint8)
        if world.backend == "nccl":
            slot = slot.to(torch.device("cuda", torch.cuda.current_device()))
        rows = host_readback(world.all_gather(slot))
        out = []
        for row in rows:
            n = int.from_bytes(row[:4].tobytes(), "little")
            got = json.loads(row[4:4 + n].tobytes().decode())
            m = Measurements(node_id=int(got["node"]),
                             num_nodes=int(got["num_nodes"]))
            m.times_us.update({k: float(v)
                               for k, v in got["times_us"].items()})
            m.counters.update({k: int(v) for k, v in got["counters"].items()})
            m.meta = got["meta"]
            out.append(m)
        return out

    @classmethod
    def load(cls, out_dir: str) -> List["Measurements"]:
        """Every ``<rank>.perf`` of a directory back into registries (the
        file-based rank-0 gather); a stray non-rank ``.perf`` is skipped."""
        out = []
        for name in sorted(os.listdir(out_dir)):
            if not name.endswith(".perf"):
                continue
            try:
                node_id = int(name[:-5])
            except ValueError:
                continue
            m = cls(node_id=node_id)
            with open(os.path.join(out_dir, name)) as f:
                for line in f:
                    key, value, unit = line.rstrip("\n").split("\t")
                    if unit == "us":
                        m.times_us[key] = float(value)
                    else:
                        m.counters[key] = int(value)
            out.append(m)
        return out


def print_results(measurements: Iterable[Measurements],
                  file=None) -> Dict[str, Dict[str, float]]:
    """Rank-0 report (printMeasurements, Measurements.cpp:592-702): the
    ``[RESULTS]`` lines — nodes, tuples, failure classes and fault sites
    where ranks stamped them into ``meta`` — and each tag's max and average
    over the ranks.  Returns the aggregate dict it printed."""
    ms = list(measurements)
    agg: Dict[str, Dict[str, float]] = {}
    keys = sorted({k for m in ms for k in (*m.times_us, *m.counters)})
    for k in keys:
        vals = [m.times_us.get(k, m.counters.get(k, 0)) for m in ms]
        agg[k] = {"max": float(max(vals)), "avg": float(sum(vals) / len(vals))}
    print(f"[RESULTS] Nodes: {len(ms)}", file=file)
    total = sum(m.counters.get(RESULTS, 0) for m in ms) // max(1, len(ms))
    print(f"[RESULTS] Tuples: {total}", file=file)
    classes = {m.node_id: str(m.meta.get("failure_class"))
               for m in ms if m.meta.get("failure_class") is not None}
    if classes:
        bad = {rank: c for rank, c in sorted(classes.items()) if c != "ok"}
        if bad:
            per_rank = " ".join(f"rank{rank}={c}" for rank, c in bad.items())
            print(f"[RESULTS] FailureClasses: {len(bad)}/{len(classes)} "
                  f"ranks not ok — {per_rank}", file=file)
        else:
            print(f"[RESULTS] FailureClasses: ok x{len(classes)}", file=file)
    sites: Dict[str, Dict[str, int]] = {}
    for m in ms:
        for site, st in (m.meta.get("fault_sites") or {}).items():
            acc = sites.setdefault(site, {"hits": 0, "fired": 0})
            acc["hits"] += int(st.get("hits", 0))
            acc["fired"] += int(st.get("fired", 0))
    if sites:
        per_site = " ".join(
            f"{site}={st['fired']}/{st['hits']}"
            for site, st in sorted(sites.items()))
        print(f"[RESULTS] FaultSites (fired/hits): {per_site}", file=file)
    for k in keys:
        unit = "us" if any(k in m.times_us for m in ms) else "count"
        print(f"[RESULTS] {k}: max {agg[k]['max']:.0f} {unit}, "
              f"avg {agg[k]['avg']:.0f} {unit}", file=file)
    return agg
