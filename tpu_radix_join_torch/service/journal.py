"""Request fingerprints and the durable query journal.

The port's copy of ``tpu_radix_join/service/journal.py``.  The result
cache (service/resultcache.py) keys on :func:`_canonical`, and
:func:`request_fingerprint` names one submission: both give the JAX
package's strings for the same request.

The journal is an append-only intent/outcome JSONL file: every append is
one ``write`` and a flush (a kill tears at most one line), torn lines are
skipped on read, and rows of a newer schema are skipped rather than
misread.  Row shapes (schema v1)::

    {"schema_version": 1, "kind": "intent",  "fp": ..., "query_id": ...,
     "t_epoch_s": ..., "worker": slot, "incarnation": ..., "attempt": n,
     "request": {...}}
    {"schema_version": 1, "kind": "outcome", "fp": ..., "query_id": ...,
     "t_epoch_s": ..., "worker": slot, "outcome": {...}}

:meth:`QueryJournal.audit` counts fingerprints with more than one outcome
(``double_exec``).  The fleet supervisor that writes it is ROADMAP
A16b.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional

JOURNAL_SCHEMA_VERSION = 1
JOURNAL_BASENAME = "query_journal.jsonl"

_KINDS = ("intent", "outcome")


#: Request fields that do not change what the query COMPUTES: a deadline
#: changes when we give up, not the answer; display names are client-side
#: labels.  Excluded from the fingerprint so equal work dedups even when
#: clients vary the non-semantic envelope.
NONSEMANTIC_FIELDS = ("deadline_s", "tenant_name", "display_name")


def _canonical(obj, top: bool = False):
    """Canonical form of one request value: dict keys sorted with the
    non-semantic envelope dropped at the top level, integral floats
    folded to int (``2.0`` and ``2`` name the same workload — JSON
    clients disagree on number types, the query does not), tuples and
    lists unified."""
    if isinstance(obj, dict):
        return {k: _canonical(obj[k]) for k in sorted(obj)
                if not (top and k in NONSEMANTIC_FIELDS)}
    if isinstance(obj, bool):          # bool is an int subclass: keep it
        return obj
    if isinstance(obj, float) and obj.is_integer():
        return int(obj)
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    return obj


def request_fingerprint(request: dict) -> str:
    """Stable identity of one query request: sha256 over the sorted-key
    JSON of the *canonicalized* request fields.  Everything that changes
    what the query computes is in the request dict, so equal fingerprints
    mean "the same query" across supervisor incarnations.

    Canonicalization (key order, integral-float folding, non-semantic
    field exclusion — :func:`_canonical`) means two requests for equal
    work hash equal even when the JSON lines differ textually.

    Journal compatibility: hardening the canonicalization CHANGED the
    fingerprint strings for requests carrying floats-with-integral-values
    or a ``deadline_s``.  A pre-hardening journal replayed under this
    build simply sees its old fingerprints as distinct cold entries —
    unacknowledged intents still replay (the fp is read from the intent
    row, never recomputed against the new scheme mid-replay), and no old
    fp can collide with a new one, so exactly-once is preserved; only
    cross-build outcome dedup of textually-divergent duplicates is lost.
    """
    blob = json.dumps(_canonical(request, top=True), sort_keys=True,
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class JournalAudit:
    """The exactly-once ledger sheet: accepted vs answered vs doubled."""

    intents: int                 # distinct accepted fingerprints
    outcomes: int                # distinct answered fingerprints
    unacked: int                 # accepted, no outcome yet
    double_exec: int             # fingerprints with >1 outcome row (MUST be 0)
    replays: int                 # intent rows beyond the first per fingerprint

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class QueryJournal:
    """Append-only intent/outcome WAL at ``<dir>/query_journal.jsonl``
    (or an explicit ``*.jsonl`` path).

    Single-writer by design (the supervisor's dispatch loop); the reader
    side is crash-tolerant so a *previous* incarnation's torn final line
    never poisons recovery.
    """

    def __init__(self, dir_or_path: str):
        self.path = (dir_or_path if dir_or_path.endswith(".jsonl")
                     else os.path.join(dir_or_path, JOURNAL_BASENAME))

    # ------------------------------------------------------------- writing
    def _append(self, row: dict) -> dict:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(row, default=str) + "\n")
            f.flush()
        return row

    def append_intent(self, request: dict, fp: Optional[str] = None,
                      worker: Optional[int] = None,
                      incarnation: Optional[str] = None,
                      attempt: int = 1) -> dict:
        """Journal "this query is accepted and about to run on
        ``worker``" — written BEFORE the request reaches any worker, so
        a supervisor death between dispatch and outcome leaves a
        replayable record, never a vanished query."""
        return self._append({
            "schema_version": JOURNAL_SCHEMA_VERSION, "kind": "intent",
            "fp": fp or request_fingerprint(request),
            "query_id": request.get("query_id"),
            "t_epoch_s": round(time.time(), 3),
            "worker": worker, "incarnation": incarnation,
            "attempt": int(attempt), "request": request})

    def append_outcome(self, fp: str, outcome: dict,
                       worker: Optional[int] = None) -> dict:
        """Journal the terminal verdict — written as soon as the worker's
        response is read, BEFORE the client sees it, so a lost response
        is re-servable from the journal without re-execution."""
        return self._append({
            "schema_version": JOURNAL_SCHEMA_VERSION, "kind": "outcome",
            "fp": fp, "query_id": outcome.get("query_id"),
            "t_epoch_s": round(time.time(), 3),
            "worker": worker, "outcome": outcome})

    # ------------------------------------------------------------- reading
    def rows(self, kind: Optional[str] = None) -> List[dict]:
        """Tolerant read: missing file -> [], torn lines skipped, rows
        from a newer schema skipped (never misread) — the ledger reader
        discipline verbatim."""
        out: List[dict] = []
        try:
            f = open(self.path)
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
                    continue               # torn final line of a dead writer
                if not isinstance(row, dict):
                    continue
                if (int(row.get("schema_version", 1))
                        > JOURNAL_SCHEMA_VERSION):
                    continue
                if row.get("kind") not in _KINDS:
                    continue
                if kind is not None and row.get("kind") != kind:
                    continue
                out.append(row)
        return out

    def intents(self) -> Dict[str, dict]:
        """Latest intent row per fingerprint, in journal order."""
        out: Dict[str, dict] = {}
        for row in self.rows("intent"):
            if row.get("fp"):
                out[row["fp"]] = row
        return out

    def outcomes(self) -> Dict[str, dict]:
        """First outcome row per fingerprint (the one the client is owed
        — later duplicates are the double-execution bug the audit
        counts, never the answer)."""
        out: Dict[str, dict] = {}
        for row in self.rows("outcome"):
            fp = row.get("fp")
            if fp and fp not in out:
                out[fp] = row
        return out

    def outcome_for(self, fp: str) -> Optional[dict]:
        """The journaled outcome dict for ``fp``, or None — the re-serve
        dedup lookup (an outcome here means the query MUST NOT run
        again)."""
        row = self.outcomes().get(fp)
        return row.get("outcome") if row else None

    def unacknowledged(self) -> List[dict]:
        """Intent rows (latest per fingerprint) with no journaled outcome
        — the replay set a restarted supervisor owes its clients, in
        original acceptance order."""
        done = set(self.outcomes())
        pend = [row for fp, row in self.intents().items() if fp not in done]
        pend.sort(key=lambda r: (r.get("t_epoch_s") or 0))
        return pend

    def depth(self) -> int:
        """Unacknowledged intents right now (the JDEPTH gauge)."""
        return len(self.unacknowledged())

    # -------------------------------------------------------------- audit
    def audit(self) -> JournalAudit:
        intent_fps: Dict[str, int] = {}
        outcome_fps: Dict[str, int] = {}
        for row in self.rows():
            fp = row.get("fp")
            if not fp:
                continue
            table = (intent_fps if row["kind"] == "intent" else outcome_fps)
            table[fp] = table.get(fp, 0) + 1
        return JournalAudit(
            intents=len(intent_fps),
            outcomes=len(outcome_fps),
            unacked=len(set(intent_fps) - set(outcome_fps)),
            double_exec=sum(1 for n in outcome_fps.values() if n > 1),
            replays=sum(n - 1 for n in intent_fps.values() if n > 1))
