"""Out-of-core chunked join: relations larger than the card's memory.

Counterpart of ``tpu_radix_join/ops/chunked.py``, which replaces hpcjoin's
large-data path (relations streamed through the GPU in 128M-tuple chunks,
``data/data.hpp:13-20``).  The outer side is counted in slabs against a
resident inner side, so the working set is O(inner + slab):

  * :func:`chunked_join_count` counts one (inner, outer) pair.  The JAX
    package's ``jax.lax.scan`` over slabs is a loop here that keeps every
    slab's uint32 total and the largest weight on the card, with one
    readback per pair.  Narrow keys take the packed count of each slab's
    union (K2, then K6 at ``ceil(n / 1024)`` positions a window:
    ``merge_count_chunks``); keys above the 31-bit packing the full-range
    count (K2, K5); 64-bit keys the wide count (K2, K5).
  * :func:`chunked_join_grid` streams both sides and probes every
    (inner, outer) chunk pair once, with checkpoints after each pair and
    resume.  ``pipeline="off"`` is the synchronous loop; ``"on"`` sorts
    each inner chunk once per grid row (K2, ``presort_keys``) and counts
    every outer chunk of the row by binary search against it
    (``merge_count_presorted``), stages the next chunks from a prefetch
    thread, defers the readbacks through a window of pending pairs and
    writes the checkpoints behind the computation.  ``"auto"`` is "on"
    for any grid larger than one pair.

Either side may come from ``data/streaming``: ``stream_chunks_device``
(generated on the card) or ``stream_chunks`` (filled on the host and
copied from a pinned pool on a side stream), as a list or, for the outer
side, a factory such as ``lambda: stream_chunks(s_rel, node, c)``.

The prefetch thread issues its generation on the thread's current stream,
which is the device's default stream, as the consumer's is: the two never
race, and the chunk's max-key readback is the staging fence, as in JAX.
On one stream the thread does not overlap generation with the probes; it
takes the max-key readbacks off the consumer's thread and keeps the JAX
package's ``PREFETCH`` count and ``prefetch_wait`` span.  A host-fed chunk
reaches it already on the card (the default stream waits on its copy's
event), and it stages that chunk as it is: no second copy.
"""

from __future__ import annotations

import contextlib
import os
import queue as _queue
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_radix_join_torch.data.tuples import (R_PAD_KEY, S_PAD_KEY,
                                              TupleBatch, lane_to_numpy,
                                              narrow, umax, widen)
from tpu_radix_join_torch.ops.merge_count import (
    MAX_MERGE_KEY, merge_count_chunks, merge_count_per_partition_full,
    merge_count_wide_per_partition, presort_keys, presorted_weights)
from tpu_radix_join_torch.performance.measurements import (GRIDPAIRS,
                                                           PREFETCH,
                                                           SORTREUSE)
from tpu_radix_join_torch.robustness import faults as _faults
from tpu_radix_join_torch.robustness.checkpoint import (AsyncCheckpointWriter,
                                                        CheckpointManager,
                                                        CheckpointMismatch)
from tpu_radix_join_torch.robustness.retry import execute as _retry_execute
from tpu_radix_join_torch.robustness.verify import DataCorruption
from tpu_radix_join_torch.utils.hostsync import host_readback, stream_fence
from tpu_radix_join_torch.utils.locks import (bench_pause_file,
                                              grid_presence_file,
                                              pid_file_alive, remove_pid_file,
                                              write_pid_file)

#: partial sums per slab in the narrow count (the JAX ``num_chunks``)
SLAB_WINDOWS = 1024
#: the pipelined grid's outer chunks staged ahead of the consumer
_PREFETCH_DEPTH = 2
#: the pipelined grid's pairs whose counts may wait for their readback
_READBACK_DEPTH = 2


# ------------------------------------------------------------------ probes
# Each returns (int32 lane [num_slabs] of uint32 per-slab totals, 0-d int32
# holding the uint32 largest weight), both left on the device.

def _stack(totals, mws) -> Tuple[torch.Tensor, torch.Tensor]:
    return narrow(torch.stack(totals)), narrow(torch.stack(mws).max())


def _scan_probe(r_keys: torch.Tensor, s_keys: torch.Tensor, num_slabs: int,
                sort_impl: str = "auto"):
    """The narrow packed count of every slab of ``s_keys``: K2 on the slab's
    union with ``r_keys``, then K6 into 1024 partial sums."""
    totals, mws = [], []
    for slab in s_keys.view(num_slabs, -1):
        c, mw = merge_count_chunks(r_keys, slab, num_chunks=SLAB_WINDOWS,
                                   return_max_weight=True,
                                   sort_impl=sort_impl)
        totals.append(widen(c).sum())
        mws.append(widen(mw))
    return _stack(totals, mws)


def _scan_probe_full(r_keys: torch.Tensor, s_keys: torch.Tensor,
                     num_slabs: int, sort_impl: str = "auto"):
    """Full-range twin of :func:`_scan_probe` for keys above the 31-bit
    packing, which would land on the pads there and count nothing."""
    totals, mws = [], []
    for slab in s_keys.view(num_slabs, -1):
        c, mw = merge_count_per_partition_full(r_keys, slab, 0,
                                               return_max_weight=True,
                                               sort_impl=sort_impl)
        totals.append(widen(c[0]))
        mws.append(widen(mw))
    return _stack(totals, mws)


def _scan_probe_wide(r_lo, r_hi, s_lo, s_hi, num_slabs: int,
                     sort_impl: str = "auto"):
    """64-bit (hi, lo lanes) twin of :func:`_scan_probe`."""
    totals, mws = [], []
    for lo, hi in zip(s_lo.view(num_slabs, -1), s_hi.view(num_slabs, -1)):
        c, mw = merge_count_wide_per_partition(r_lo, r_hi, lo, hi, 0,
                                               return_max_weight=True,
                                               sort_impl=sort_impl)
        totals.append(widen(c).sum())
        mws.append(widen(mw))
    return _stack(totals, mws)


def _scan_probe_presorted(r_sorted: torch.Tensor, s_keys: torch.Tensor,
                          num_slabs: int):
    """The pipelined grid's probe against a row's presorted inner chunk:
    one binary search of the whole outer chunk, summed per slab (the JAX
    package's per-slab ``merge_count_presorted``, whose totals these
    equal).  No packing, so every key below the pads joins."""
    weight = presorted_weights(r_sorted, s_keys)
    per_slab = narrow(weight.view(num_slabs, -1).sum(dim=1))
    maxw = weight.max() if weight.numel() else weight.new_zeros(())
    return per_slab, maxw


def _pad_outer(lane: torch.Tensor, slab: int) -> torch.Tensor:
    """``lane`` padded to a slab multiple with the outer pad, which matches
    nothing."""
    pad = (-lane.numel()) % slab
    if not pad:
        return lane
    return torch.cat([lane, narrow(torch.full((pad,), S_PAD_KEY,
                                              dtype=torch.int64,
                                              device=lane.device))])


def _resolve(per_slab: torch.Tensor, maxw: torch.Tensor) -> Tuple[int, int]:
    """One readback: (largest weight, uint64 sum of the slab totals)."""
    host = lane_to_numpy(torch.cat([maxw.reshape(1), per_slab]))
    return int(host[0]), int(host[1:].astype(np.uint64).sum())


# ------------------------------------------------------------------ checks
def _sentinel_corruption(mx: int) -> DataCorruption:
    return DataCorruption(
        f"keys reach the pad sentinel range (max {mx:#x}): uint32 keys "
        f"must stay <= {R_PAD_KEY - 1:#x}; a key lane in the sentinel "
        f"range is the streamed-lane corruption signature (such tuples "
        f"would silently pad-match)")


def _narrow_violation(mx: int) -> ValueError:
    return ValueError(
        f"key contract violation: key_range='narrow' but max key {mx:#x} "
        f"exceeds the 31-bit packing limit {MAX_MERGE_KEY:#x}; such keys "
        f"pack to the reserved zero-match pads (silent undercount); use "
        f"key_range='full' or 'auto'")


def _check_weight_window(maxw: int, window: int) -> None:
    """uint32 overflow guard: every accumulation window (a slab's total
    and the partial sums inside it) is at most the largest weight times
    the window's width; a wrapped window would be a wrong count."""
    if maxw > (2**32 - 1) // window:
        raise OverflowError(
            f"uint32 count-window overflow risk: max inner multiplicity "
            f"{maxw} x window {window} can reach 2**32; shrink slab_size "
            f"or deduplicate the inner side")


def _check_widths(r: TupleBatch, s: TupleBatch) -> None:
    if (r.key_hi is None) != (s.key_hi is None):
        raise ValueError(
            "mixed key widths: one side carries a key_hi lane and the other "
            "does not; refusing to run a silently-truncated join")


def _max_key(r: TupleBatch, s: TupleBatch) -> torch.Tensor:
    """0-d int64 on the device: the largest uint32 key of both lanes."""
    return torch.maximum(umax(r.key), umax(s.key))


def chunked_join_count(r: TupleBatch, s: TupleBatch, slab_size: int,
                       key_range: str = "auto",
                       key_bound: Optional[int] = None,
                       sort_impl: str = "auto") -> int:
    """Exact match count, the outer side streamed in ``slab_size`` slabs
    (padded to a slab multiple with the outer pad).  64-bit batches take
    the wide count; mixed widths raise.

    ``key_range`` for 32-bit keys: "auto" reads the lanes' max key (one
    readback) and takes the full-range count above the 31-bit packing;
    "narrow" asserts the packing, and the lanes' max key is read back with
    the counts and raises when it breaks it; "full" always takes the
    full-range count.  ``key_bound``, an inclusive max over both lanes known
    to the caller, replaces those reads with host arithmetic.  A key in the
    pad range raises :class:`DataCorruption` under "auto"; a slab whose
    uint32 sums could wrap raises ``OverflowError``.  ``sort_impl`` is every
    sort's arm (``ops/sorting``)."""
    if key_range not in ("auto", "narrow", "full"):
        raise ValueError(f"unknown key range mode {key_range!r}")
    _check_widths(r, s)
    keys = _pad_outer(s.key, slab_size)
    num_slabs = keys.numel() // slab_size
    mx_narrow = None
    if r.key_hi is not None:
        per_slab, maxw = _scan_probe_wide(r.key, r.key_hi, keys,
                                          _pad_outer(s.key_hi, slab_size),
                                          num_slabs, sort_impl)
    else:
        full = key_range == "full"
        if key_range == "auto":
            mx = (int(key_bound) if key_bound is not None
                  else int(host_readback(_max_key(r, s))))
            if mx >= R_PAD_KEY:
                raise _sentinel_corruption(mx)
            full = mx > MAX_MERGE_KEY
        if full:
            per_slab, maxw = _scan_probe_full(r.key, keys, num_slabs,
                                              sort_impl)
        else:
            per_slab, maxw = _scan_probe(r.key, keys, num_slabs, sort_impl)
            if key_range == "narrow":
                if key_bound is not None:
                    if int(key_bound) > MAX_MERGE_KEY:
                        raise _narrow_violation(int(key_bound))
                else:
                    # rides the counts' readback: no extra sync
                    mx_narrow = _max_key(r, s)
    extra = [] if mx_narrow is None else [narrow(mx_narrow.reshape(1))]
    host = lane_to_numpy(torch.cat([maxw.reshape(1), *extra, per_slab]))
    if extra and int(host[1]) > MAX_MERGE_KEY:
        raise _narrow_violation(int(host[1]))
    window = max(slab_size, -(-(r.key.shape[0] + slab_size) // SLAB_WINDOWS))
    _check_weight_window(int(host[0]), window)
    return int(host[1 + len(extra):].astype(np.uint64).sum())


# ------------------------------------------------------------------ grid
def _span(measurements, name: str, **kw):
    return (measurements.span(name, **kw) if measurements is not None
            else contextlib.nullcontext())


def _fence(batch: TupleBatch) -> Optional[int]:
    """Wait for a chunk's generation; for a 32-bit chunk the wait is the
    readback of its max key, which is returned (the "auto" bound)."""
    if batch.key_hi is None:
        return int(host_readback(umax(batch.key)))
    if batch.key.is_cuda:
        stream_fence(torch.cuda.current_stream(batch.key.device))
    return None


class _Prefetcher:
    """Bounded background chunk stager of the pipelined grid: a daemon
    thread pulls chunks from ``it``, waits for their generation (and, for
    32-bit chunks, reads their max key off the critical path) and hands
    ``(chunk, bound)`` pairs over a queue of ``depth`` slots; the chunk is
    the iterator's own batch, never copied again.  Each staged
    chunk is one "prefetch" span and one ``PREFETCH`` count; the
    consumer's wait for a chunk is a "prefetch_wait" span (the pipeline's
    stall).  An exception of the iterator is raised at the consumer's
    ``next()``."""

    _DONE = object()

    def __init__(self, it, depth: int, measurements, side: str):
        self._q = _queue.Queue(maxsize=max(1, depth))
        self._meas = measurements
        self._side = side
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(it,), name=f"grid-prefetch-{side}",
            daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for idx, chunk in enumerate(it):
                if self._stop.is_set():
                    return
                with _span(self._meas, "prefetch", side=self._side,
                           chunk=idx):
                    bound = _fence(chunk)
                if self._meas is not None:
                    self._meas.incr(PREFETCH)
                self._put((chunk, bound))
            self._put(self._DONE)
        except BaseException as e:      # raised again at the consumer
            self._put(e)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except _queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        with _span(self._meas, "prefetch_wait", side=self._side):
            item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=5)


def chunked_join_grid(r_chunks, s_chunks, slab_size: int,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_tag: str = "",
                      progress: bool = False,
                      key_range: str = "auto",
                      measurements=None,
                      retry_policy=None,
                      retry_on=None,
                      pipeline: str = "off",
                      sort_impl: str = "auto",
                      plan=None) -> int:
    """Both sides streamed; every inner chunk joins every outer chunk once.

    ``s_chunks`` is walked once per inner chunk: pass a list or tuple, or a
    zero-argument factory returning a fresh iterator (device memory then
    stays O(chunk)); a one-shot iterator is materialised first.

    ``pipeline``: "off" probes, reads back and checkpoints pair by pair;
    "on" is the pipelined engine (module docstring), its lookahead
    ``_PREFETCH_DEPTH`` chunks and its pending readbacks at most
    ``_READBACK_DEPTH`` pairs; "auto" is "on" unless the grid is one pair.
    Both return the same total and share the checkpoint format.  ``sort_impl``
    is every sort's arm (``ops/sorting``).

    ``checkpoint_path`` (with a ``checkpoint_tag`` naming the inputs) saves
    the total and the next pair's (i, j) after every resolved pair; a rerun
    skips the pairs done (their chunks are generated, not probed).  The
    fingerprint (slab, tag, rows and cols where known, and a planner
    ``plan``'s strategy and chunking) and the saved grid extent guard
    against resuming another join
    (:class:`CheckpointMismatch`).  The file format is the JAX package's,
    so a run killed in either package resumes in the other.

    ``measurements`` (duck-typed ``incr``/``span``/``event``) receives
    ``GRIDPAIRS`` (pairs probed by this run), ``SORTREUSE``, ``PREFETCH``,
    ``CKPTSAVE``/``CKPTLOAD`` and the spans; ``retry_policy`` retries each
    pair on ``retry_on`` errors (default: the injectable
    ``TransientFault``).  Between pairs the grid parks while a benchmark's
    pause file exists (``utils/locks.py``)."""
    if callable(s_chunks):
        s_iter = s_chunks
    else:
        if not isinstance(s_chunks, (list, tuple)):
            s_chunks = list(s_chunks)
        s_iter = lambda: s_chunks           # noqa: E731
    if pipeline not in ("off", "on", "auto"):
        raise ValueError(f"unknown grid pipeline mode {pipeline!r} "
                         f"(want off|on|auto)")
    rows_known = (len(r_chunks) if isinstance(r_chunks, (list, tuple))
                  else None)
    cols_known = (len(s_chunks) if isinstance(s_chunks, (list, tuple))
                  else None)
    if pipeline == "auto":
        pipeline = "off" if rows_known == 1 and cols_known == 1 else "on"
    if checkpoint_path and not checkpoint_tag:
        raise ValueError(
            "checkpoint_path requires a checkpoint_tag identifying the input "
            "relations: an untagged checkpoint resumed against different "
            "data would silently return a wrong total")

    fingerprint = {"slab": int(slab_size), "tag": checkpoint_tag,
                   "rows": rows_known, "cols": cols_known}
    if plan is not None:
        # a planned grid (main.py --plan) walks the plan's chunking: a
        # checkpoint of another strategy or chunking must not resume here
        fingerprint["plan"] = {"strategy": plan.strategy,
                               "chunk_tuples": plan.chunk_tuples}
    ckpt = (CheckpointManager(checkpoint_path, fingerprint, measurements)
            if checkpoint_path else None)
    start_i, start_j, total = 0, 0, 0
    saved_cols = None
    if ckpt is not None:
        state = ckpt.load()
        if state is not None:
            saved_rows, saved_cols = state.get("rows"), state.get("cols")
            # generator-fed grids have no rows/cols in the fingerprint: the
            # saved extent catches a same-tag grid of another shape
            for name, saved, known in (("rows", saved_rows, rows_known),
                                       ("cols", saved_cols, cols_known)):
                if saved is not None and known is not None and saved != known:
                    raise CheckpointMismatch(
                        f"checkpoint {checkpoint_path} was saved from a grid "
                        f"with {saved} {name.rstrip('s')} chunk(s), but this "
                        f"run walks {known}: same tag, different grid "
                        f"shape; remove the checkpoint or fix the inputs")
            if state.get("done"):
                return int(state["total"])
            start_i, start_j = int(state["i"]), int(state["j"])
            total = int(state["total"])
    cols = cols_known if cols_known is not None else saved_cols
    if progress and (start_i or start_j):
        skipped = (f"{start_i * cols + start_j} completed pair(s)" if cols
                   else "completed pairs before cursor")
        print(f"[grid] resume: skipping {skipped} (cursor i={start_i}, "
              f"j={start_j})", flush=True)

    def state_dict(i: int, j: int, total: int, done: bool = False) -> dict:
        state = {"i": i, "j": j, "total": total}
        if cols is not None:
            state["cols"] = cols
        rows = rows_known if rows_known is not None else (i if done else None)
        if rows is not None:
            state["rows"] = rows
        return state

    def note_cols(n: int) -> None:
        nonlocal cols
        if saved_cols is not None and n != saved_cols:
            raise CheckpointMismatch(
                f"checkpoint {checkpoint_path} was saved from a grid with "
                f"{saved_cols} outer chunk(s) per row, but this run "
                f"discovered {n}: same tag, different grid shape; remove "
                f"the checkpoint or fix the inputs")
        if cols is None:
            cols = n

    pause_file = bench_pause_file()
    grid_file = grid_presence_file()
    if write_pid_file(grid_file):
        # a grid killed while parked leaves a stale .parked behind
        remove_pid_file(grid_file + ".parked")
    else:
        grid_file = None

    def yield_chip() -> None:
        """Park between pairs while a benchmark holds the pause file; a
        pause file whose owner died is removed."""
        waited = False
        while os.path.exists(pause_file):
            alive = pid_file_alive(pause_file)
            if alive is False:
                print("[grid] removing dead bench's pause file", flush=True)
                remove_pid_file(pause_file)
                break
            if alive is None and not os.path.exists(pause_file):
                break
            if not waited:
                print(f"[grid] paused: {pause_file} present", flush=True)
                waited = True
                if measurements is not None:
                    measurements.event("grid_parked", pause_file=pause_file)
                if grid_file:
                    write_pid_file(grid_file + ".parked")
            time.sleep(5)
        if waited:
            if grid_file:
                remove_pid_file(grid_file + ".parked")
            if measurements is not None:
                measurements.event("grid_resumed")
            print("[grid] resumed", flush=True)

    def run_pair(fn, i: int, j: int):
        """``fn()`` under the "grid_pair" span and the retry policy."""
        def attempt():
            _faults.check(_faults.GRID_TRANSIENT, measurements)
            return fn()

        with _span(measurements, "grid_pair", i=i, j=j):
            if retry_policy is None:
                return attempt()
            return _retry_execute(
                attempt, retry_policy,
                retryable=retry_on or (_faults.TransientFault,),
                measurements=measurements, label=f"grid_pair({i},{j})")

    t0 = time.perf_counter()
    start_pairs = start_i * cols + start_j if cols else 0
    done_this_run = 0

    def report(i: int, j: int) -> None:
        if not progress:
            return
        elapsed = time.perf_counter() - t0
        rate = done_this_run / elapsed if elapsed > 0 else 0.0
        line = (f"[grid] pair ({i}, {j}) done, total={total:,}, "
                f"t={elapsed:.1f}s, {rate:.2f} pairs/s")
        if rows_known is not None and cols and rate > 0:
            remaining = max(0, rows_known * cols - start_pairs - done_this_run)
            line += f", eta={remaining / rate:.0f}s"
        print(line, flush=True)

    # "auto"'s max key: one readback per chunk, cached by outer chunk
    # index (the outer side repeats every row), not one per pair
    s_bounds: dict = {}
    last_i = start_i

    def run_sync() -> int:
        nonlocal total, last_i, done_this_run
        for i, r in enumerate(r_chunks):
            if i < start_i:
                continue
            row_start_j = start_j if i == start_i else 0
            rb = (int(host_readback(umax(r.key)))
                  if key_range == "auto" and r.key_hi is None else None)
            row_cols = 0
            for j, s in enumerate(s_iter()):
                row_cols = j + 1
                if j < row_start_j:
                    continue
                yield_chip()
                # a simulated hard kill lands between the last save and
                # the next probe: the checkpoint covers every finished pair
                _faults.check(_faults.GRID_KILL, measurements)
                kb = None
                if rb is not None and s.key_hi is None:
                    if j not in s_bounds:
                        s_bounds[j] = int(host_readback(umax(s.key)))
                    kb = max(rb, s_bounds[j])
                total += run_pair(
                    lambda r=r, s=s, kb=kb: chunked_join_count(
                        r, s, min(slab_size, s.key.shape[0]),
                        key_range=key_range, key_bound=kb,
                        sort_impl=sort_impl), i, j)
                if measurements is not None:
                    measurements.incr(GRIDPAIRS)
                done_this_run += 1
                if ckpt is not None:
                    ckpt.save(state_dict(i, j + 1, total))
                report(i, j)
            note_cols(row_cols)
            last_i = i + 1
        if ckpt is not None:
            ckpt.save(state_dict(last_i, 0, total, done=True), done=True)
        return total

    def dispatch_probe(r, s, r_sorted, kb):
        """One pair's probe, its counts left on the device: (per_slab,
        maxw, overflow window)."""
        _check_widths(r, s)
        slab = min(slab_size, s.key.shape[0])
        keys = _pad_outer(s.key, slab)
        num_slabs = keys.numel() // slab
        if r.key_hi is not None:
            # wide chunks keep the per-pair union sort (no presorted probe
            # for two-lane keys) but ride the other pipeline stages
            per_slab, maxw = _scan_probe_wide(r.key, r.key_hi, keys,
                                              _pad_outer(s.key_hi, slab),
                                              num_slabs, sort_impl)
            return (per_slab, maxw,
                    max(slab, -(-(r.key.shape[0] + slab) // SLAB_WINDOWS)))
        # the binary search compares raw keys: an inner key in the pad
        # range would pad-match the outer fill, so every mode checks
        if kb is None:
            kb = int(host_readback(_max_key(r, s)))
        if kb >= R_PAD_KEY:
            raise _sentinel_corruption(kb)
        if key_range == "narrow" and kb > MAX_MERGE_KEY:
            raise _narrow_violation(kb)
        per_slab, maxw = _scan_probe_presorted(r_sorted, keys, num_slabs)
        return per_slab, maxw, slab

    def run_pipelined() -> int:
        nonlocal total, last_i, done_this_run
        writer = AsyncCheckpointWriter(ckpt) if ckpt is not None else None
        pending = deque()   # (i, j, per_slab, maxw, window), dispatch order

        def resolve_until(limit: int) -> None:
            nonlocal total, done_this_run
            if len(pending) <= limit:
                return
            # pairs resolve in dispatch order, so the resolved prefix (all
            # that is ever checkpointed) advances row-major, as in the
            # synchronous loop
            with _span(measurements, "readback_flush",
                       drained=len(pending) - limit):
                while len(pending) > limit:
                    pi, pj, per_slab, maxw, window = pending.popleft()
                    maxw, pair_total = _resolve(per_slab, maxw)
                    _check_weight_window(maxw, window)
                    total += pair_total
                    done_this_run += 1
                    if writer is not None:
                        writer.save(state_dict(pi, pj + 1, total))
                    report(pi, pj)

        prefetchers = []

        def open_prefetcher(it, depth, side):
            pf = _Prefetcher(it, depth, measurements, side)
            prefetchers.append(pf)
            return pf

        try:
            inner_pf = open_prefetcher(iter(r_chunks), 1, "inner")
            for i, (r, rb) in enumerate(inner_pf):
                if i < start_i:
                    continue
                row_start_j = start_j if i == start_i else 0
                r_sorted = None     # sorted at the row's first probed pair
                outer_pf = open_prefetcher(iter(s_iter()), _PREFETCH_DEPTH,
                                           "outer")
                row_cols = 0
                for j, (s, sb) in enumerate(outer_pf):
                    row_cols = j + 1
                    if j < row_start_j:
                        continue
                    yield_chip()
                    _faults.check(_faults.GRID_KILL, measurements)
                    reused = r_sorted is not None
                    if r.key_hi is None and r_sorted is None:
                        with _span(measurements, "presort", i=i):
                            r_sorted = presort_keys(r.key, sort_impl)
                    kb = (max(rb, sb) if rb is not None and sb is not None
                          else None)
                    res = run_pair(
                        lambda r=r, s=s, rs=r_sorted, kb=kb: dispatch_probe(
                            r, s, rs, kb), i, j)
                    if measurements is not None:
                        measurements.incr(GRIDPAIRS)
                        if reused:
                            measurements.incr(SORTREUSE)
                    pending.append((i, j, *res))
                    resolve_until(_READBACK_DEPTH)
                prefetchers.remove(outer_pf)
                outer_pf.close()
                note_cols(row_cols)
                last_i = i + 1
            resolve_until(0)
            if writer is not None:
                # flush, then one synchronous final save: the done marker
                # is durable before the total is returned
                writer.flush()
                ckpt.save(state_dict(last_i, 0, total, done=True), done=True)
            return total
        finally:
            for pf in prefetchers:
                pf.close()
            if writer is not None:
                # flushes what was queued: on an error path that keeps the
                # most progress a resume may claim
                writer.close()

    try:
        return run_pipelined() if pipeline == "on" else run_sync()
    finally:
        if grid_file:
            remove_pid_file(grid_file)
            remove_pid_file(grid_file + ".parked")
