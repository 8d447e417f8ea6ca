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
newer schema than this build understands.  The JAX package's backfill of
its own ``BENCH_r*.json`` and ``artifacts/`` (``bench_payload``,
``rows_from_perf_dir``, ``ingest_artifacts``) holds TPU numbers and waits
for ROADMAP A8b.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import time
from typing import Dict, List, Optional

LEDGER_SCHEMA_VERSION = 1
LEDGER_BASENAME = "ledger.jsonl"

#: row kinds the fitter understands ("obs": a pre-reduced single-constant
#: observation)
KINDS = ("run", "bench", "query", "obs")

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
