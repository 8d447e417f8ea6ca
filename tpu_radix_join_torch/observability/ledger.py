"""Run ledger: the planner's memory across runs.

The port's copy of ``tpu_radix_join/observability/ledger.py:1-178``: an
append-only, schema-versioned JSONL store, one row an observation.  The
command line writes one ``kind="run"`` row at exit (``main.py
--ledger-dir``), a resident session one ``kind="query"`` row an executed query
(``JoinSession(ledger=...)``), and a probe pre-reduced ``kind="obs"`` rows;
``planner/calibrate.py`` fits the device profile's constants from them and
attributes persistent PLANDRIFT to the constant behind the drifting term.

Row shape (schema v1)::

    {"schema_version": 1, "kind": "run"|"bench"|"query"|"obs",
     "run_id": ..., "t_epoch_s": ..., **payload}

The reader skips torn lines (a killed writer's last record) and rows of a
newer schema than this build understands.

The backfill (JAX's ``ledger.py:181-273``): :func:`rows_from_perf_dir`
turns a ``--output-dir`` directory (``<rank>.perf`` / ``<rank>.info``)
into run rows, :func:`bench_payload` a benchmark's result line into a
bench row, and :func:`ingest_artifacts` walks ``perf_*`` directories
(``python -m tpu_radix_join_torch.tools.make_report DIR --emit-ledger
OUT``).  Two differences from JAX's: a backfilled run row's fingerprint
carries ``device`` (the ``.info``'s, which the port's command line writes,
else ``"unknown"``), so a fit onto a card's profile can set aside rows of
another device; and ``ingest_artifacts`` reads ``BENCH_r*.json`` files only
from a ``bench_dir`` the caller names (the repo root's are the JAX
package's TPU runs, and the port has no benchmark yet).
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import socket
import time
from typing import Dict, List, Optional, Tuple

LEDGER_SCHEMA_VERSION = 1
LEDGER_BASENAME = "ledger.jsonl"

#: row kinds the fitter understands ("obs": a pre-reduced single-constant
#: observation)
KINDS = ("run", "bench", "query", "obs")

#: the size of a bench row that carries none (the JAX benchmark's fixed
#: 16M-a-side join, as its rows before the "size" tag measured)
BENCH_DEFAULT_SIZE = 1 << 24

_seq = itertools.count()


def default_ledger_dir() -> str:
    """Where ``--profile auto`` looks when no ``--ledger-dir`` is given:
    ``$TPU_RADIX_LEDGER_DIR``, else ``artifacts/ledger``."""
    return (os.environ.get("TPU_RADIX_LEDGER_DIR")
            or os.path.join("artifacts", "ledger"))


def run_fingerprint(extra: Optional[dict] = None) -> dict:
    """The software stack a row was measured under (the host, the torch
    and CUDA versions, the device), so a fit can exclude rows of another
    stack; configuration and world ride in the payload."""
    import torch

    fp: Dict[str, object] = {"host": socket.gethostname(),
                             "torch": torch.__version__,
                             "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        fp["device"] = torch.cuda.get_device_name(torch.cuda.current_device())
    else:
        fp["device"] = "cpu"
    if extra:
        fp.update(extra)
    return fp


class Ledger:
    """Append-only JSONL ledger at ``<dir>/ledger.jsonl`` (or an explicit
    ``*.jsonl`` path).  An append is one write and a flush, so concurrent
    writers interleave whole lines and a killed writer tears at most one
    row, which the reader skips."""

    def __init__(self, dir_or_path: str):
        self.path = (dir_or_path if dir_or_path.endswith(".jsonl")
                     else os.path.join(dir_or_path, LEDGER_BASENAME))

    def append(self, kind: str, payload: dict,
               run_id: Optional[str] = None,
               t_epoch_s: Optional[float] = None) -> dict:
        if kind not in KINDS:
            raise ValueError(f"unknown ledger row kind {kind!r} "
                             f"(want one of {KINDS})")
        row = {"schema_version": LEDGER_SCHEMA_VERSION,
               "kind": kind,
               "run_id": run_id or
               f"{kind}-{os.getpid()}-{int(time.time())}-{next(_seq)}",
               "t_epoch_s": round(t_epoch_s if t_epoch_s is not None
                                  else time.time(), 3)}
        for k, v in payload.items():
            if k not in row and v is not None:
                row[k] = v
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(row, default=str) + "\n")
            f.flush()
        return row

    def rows(self, kind: Optional[str] = None) -> List[dict]:
        return load_rows(self.path, kind=kind)


def load_rows(path: str, kind: Optional[str] = None) -> List[dict]:
    """Tolerant read: a missing file is [], torn lines and rows of a newer
    schema are skipped (never misread)."""
    if path and not path.endswith(".jsonl"):
        path = os.path.join(path, LEDGER_BASENAME)
    out: List[dict] = []
    try:
        f = open(path)
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if not isinstance(row, dict):
                continue
            if int(row.get("schema_version", 1)) > LEDGER_SCHEMA_VERSION:
                continue
            if kind is not None and row.get("kind") != kind:
                continue
            out.append(row)
    return out


def run_payload(measurements, config: Optional[dict] = None,
                workload: Optional[dict] = None,
                fingerprint: Optional[dict] = None) -> dict:
    """One ``kind="run"`` row from a registry: phase times, non-zero
    counters, the workload, the plan and its plan-vs-actual table, the
    exchange plan and failure class where present, the scalar config, and
    the stack fingerprint."""
    m = measurements
    payload: Dict[str, object] = {
        "fingerprint": fingerprint or run_fingerprint(
            {"nodes": getattr(m, "num_nodes", 1)}),
        "times_us": {k: round(float(v), 1) for k, v in m.times_us.items()},
        "counters": {k: int(v) for k, v in m.counters.items() if v},
    }
    wl = workload or {k: m.meta[k] for k in
                      ("tuples_per_node", "global_size", "nodes")
                      if k in m.meta}
    if wl:
        payload["workload"] = wl
    for key in ("plan", "plan_vs_actual", "exchange_plan", "failure_class"):
        if m.meta.get(key) is not None:
            payload[key] = m.meta[key]
    cfg = config if config is not None else m.meta.get("config")
    if isinstance(cfg, dict):
        payload["config"] = {k: v for k, v in cfg.items()
                             if isinstance(v, (int, float, str, bool))}
        if cfg.get("repeat"):
            payload["repeat"] = int(cfg["repeat"])
    return payload


def bench_payload(doc: dict,
                  size_default: int = BENCH_DEFAULT_SIZE) -> Optional[dict]:
    """One ``kind="bench"`` row from a benchmark's result dict or its
    runner's wrapper (``{"parsed": {...}, "rc": N, ...}``); None when there
    is no parsed result (a capture that died before its JSON line)."""
    parsed = doc.get("parsed") if isinstance(doc.get("parsed"), dict) else doc
    if not isinstance(parsed, dict) or "metric" not in parsed:
        return None
    payload: Dict[str, object] = {
        "metric": parsed["metric"],
        "value": float(parsed.get("value") or 0.0),
        "unit": parsed.get("unit", ""),
        "size": int(parsed.get("size") or size_default),
    }
    for k, v in parsed.items():
        if k not in payload and isinstance(v, (int, float, str, bool)):
            payload[k] = v
    if doc is not parsed and "rc" in doc:
        payload["rc"] = doc["rc"]
    return payload


def rows_from_perf_dir(d: str) -> List[Tuple[str, dict]]:
    """``(run_id, payload)`` run rows from one ``--output-dir`` directory
    (``<rank>.perf`` + ``<rank>.info``), one a rank; [] when it holds none
    or cannot be read.  The fingerprint names the host, the ranks, the
    directory and the device the ``.info`` recorded."""
    from tpu_radix_join_torch.performance.measurements import Measurements

    out: List[Tuple[str, dict]] = []
    try:
        ranks = Measurements.load(d)
    except (OSError, ValueError):
        return out
    base = os.path.basename(d.rstrip("/"))
    for m in ranks:
        meta: dict = {}
        try:
            with open(os.path.join(d, f"{m.node_id}.info")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            pass
        cfg = meta.get("config") or {}
        wl = {k: meta[k] for k in
              ("tuples_per_node", "global_size", "nodes") if k in meta}
        payload = run_payload(
            m, config=cfg, workload=wl or None,
            fingerprint={"host": meta.get("host", "?"),
                         "nodes": meta.get("nodes", m.num_nodes),
                         "artifact": d,
                         "device": meta.get("device", "unknown")})
        for key in ("plan", "plan_vs_actual", "failure_class"):
            if meta.get(key) is not None:
                payload[key] = meta[key]
        out.append((f"{base}:{m.node_id}", payload))
    return out


def ingest_artifacts(base_dir: str, out_path: str,
                     bench_dir: Optional[str] = None) -> Dict[str, int]:
    """Backfill the ledger at ``out_path``: every ``BENCH_r*.json`` under
    ``bench_dir`` (none when it is None) and every ``perf_*`` directory
    under ``base_dir`` (one level of nesting allowed:
    ``base/chip_*/perf_*``).  A row's timestamp is its file's mtime, so
    backfilled evidence keeps its age.  Returns ``{"bench": n, "run":
    n}``."""
    led = Ledger(out_path)
    counts = {"bench": 0, "run": 0}
    benches = (sorted(glob.glob(os.path.join(bench_dir, "BENCH_r*.json")))
               if bench_dir else [])
    for path in benches:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        payload = bench_payload(doc)
        if payload is None:
            continue
        stem = os.path.splitext(os.path.basename(path))[0]
        led.append("bench", payload, run_id=stem,
                   t_epoch_s=os.path.getmtime(path))
        counts["bench"] += 1
    perf_dirs = sorted(glob.glob(os.path.join(base_dir, "perf_*")))
    perf_dirs += sorted(glob.glob(os.path.join(base_dir, "*", "perf_*")))
    for d in perf_dirs:
        if not os.path.isdir(d):
            continue
        for run_id, payload in rows_from_perf_dir(d):
            led.append("run", payload, run_id=run_id,
                       t_epoch_s=os.path.getmtime(d))
            counts["run"] += 1
    return counts
