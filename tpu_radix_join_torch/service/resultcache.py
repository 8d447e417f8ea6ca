"""Relation-fingerprint result cache: whole-query reuse before admission.

The port's copy of ``tpu_radix_join/service/resultcache.py``.  The content
fingerprint hashes only the fields that determine a query's answer (the
relation specs, the join configuration and the membership epoch) and
drops the submission envelope (query_id, tenant, deadline), so two
clients asking the same question hit one entry, and any change of spec,
epoch or configuration lands on a new fingerprint.

Serving discipline (service/session.py):

  * a hit short-circuits before admission: the stored outcome is
    re-stamped with the new submission's query_id and tenant and marked
    ``served_by="cache_hit"``;
  * every stored entry carries a sha256 digest of its payload and the
    epoch it was computed under; :meth:`ResultCache.get` re-verifies both
    on every read, so a corrupted or stale entry is dropped (a miss,
    re-executed) rather than served.  The ``serve.cache_poison`` fault
    site (robustness/faults.py) injects exactly that corruption.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from collections import OrderedDict
from typing import Callable, Optional

from tpu_radix_join_torch.performance.measurements import RCHIT, RCMISS
from tpu_radix_join_torch.robustness import faults as _faults
from tpu_radix_join_torch.service.journal import _canonical

#: submission-envelope fields the content fingerprint must NOT see: they
#: change who asked / when we give up, never the answer
_ENVELOPE_FIELDS = ("query_id", "tenant", "tenant_name", "display_name",
                    "deadline_s")


def content_fingerprint(request, config_fp: Optional[dict] = None,
                        epoch: Optional[int] = None) -> str:
    """Content identity of one query: sha256 over the canonicalized
    request MINUS the submission envelope, the join-config fingerprint,
    and the membership epoch.  Equal fingerprints mean "the same answer"
    — the invalidation rule is that there is no invalidation, only new
    fingerprints."""
    if dataclasses.is_dataclass(request) and not isinstance(request, type):
        request = dataclasses.asdict(request)
    spec = {k: v for k, v in request.items() if k not in _ENVELOPE_FIELDS}
    blob = json.dumps({"spec": _canonical(spec), "config": config_fp,
                       "epoch": epoch}, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _digest(payload: dict) -> str:
    return hashlib.sha256(json.dumps(payload, sort_keys=True,
                                     default=str).encode()).hexdigest()


@dataclasses.dataclass
class _Entry:
    payload: dict                  # the stored outcome fields (JSON shape)
    digest: str                    # sha256 over payload at store time
    epoch: Optional[int]           # membership epoch at store time
    stored_at: float               # clock() timestamp for TTL expiry
    hits: int = 0


class ResultCache:
    """LRU + TTL result cache keyed by :func:`content_fingerprint`.

    ``max_entries == 0`` is the disabled posture: every get misses
    without counting, every put is dropped — callers need no gate of
    their own.  Single-threaded like the session that owns it.
    """

    def __init__(self, max_entries: int, ttl_s: Optional[float] = None,
                 measurements=None,
                 clock: Callable[[], float] = time.monotonic):
        if max_entries < 0:
            raise ValueError("max_entries must be >= 0")
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self.measurements = measurements
        self._clock = clock
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.expired = 0
        self.dropped_stale = 0     # digest/epoch verification drops

    # ------------------------------------------------------------- serving
    def get(self, fp: str, epoch: Optional[int] = None) -> Optional[dict]:
        """The stored payload for ``fp`` (a COPY — callers re-stamp their
        own envelope), or None.  Verifies TTL, payload digest, and epoch
        on every read; any failure drops the entry and counts a miss —
        a stale or damaged entry is never served."""
        if self.max_entries == 0:
            return None
        m = self.measurements
        entry = self._entries.get(fp)
        if entry is not None and _faults.fires(_faults.CACHE_POISON, m):
            # chaos: corrupt the stored entry in place — the digest check
            # below must catch it (the production twin is heap rot or a
            # stale epoch surviving an invalidation bug)
            entry.payload = dict(entry.payload, matches=-1)
        if entry is None:
            self.misses += 1
            if m is not None:
                m.incr(RCMISS)
            return None
        if (self.ttl_s is not None
                and self._clock() - entry.stored_at > self.ttl_s):
            del self._entries[fp]
            self.expired += 1
            self.misses += 1
            if m is not None:
                m.incr(RCMISS)
            return None
        if _digest(entry.payload) != entry.digest or entry.epoch != epoch:
            # poisoned payload or an epoch the entry was not computed
            # under: drop loudly, re-execute
            del self._entries[fp]
            self.dropped_stale += 1
            self.misses += 1
            if m is not None:
                m.incr(RCMISS)
                m.event("result_cache_drop", fp=fp,
                        reason=("epoch" if entry.epoch != epoch
                                else "digest"))
            return None
        self._entries.move_to_end(fp)
        entry.hits += 1
        self.hits += 1
        if m is not None:
            m.incr(RCHIT)
        return dict(entry.payload)

    def put(self, fp: str, payload: dict,
            epoch: Optional[int] = None) -> None:
        """Store one ok outcome's payload under its content fingerprint
        (callers only cache ``status == "ok"`` outcomes — a failure is
        evidence, not an answer)."""
        if self.max_entries == 0:
            return
        payload = dict(payload)
        self._entries[fp] = _Entry(payload=payload, digest=_digest(payload),
                                   epoch=epoch, stored_at=self._clock())
        self._entries.move_to_end(fp)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    # ---------------------------------------------------------- lifecycle
    def invalidate(self, fp: Optional[str] = None) -> int:
        """Drop one entry (or all, fp=None); returns how many went."""
        if fp is not None:
            return 1 if self._entries.pop(fp, None) is not None else 0
        n = len(self._entries)
        self._entries.clear()
        return n

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        """The cache's counts (the session's ``fastpath_stats``)."""
        total = self.hits + self.misses
        return {"entries": len(self._entries),
                "max_entries": self.max_entries,
                "ttl_s": self.ttl_s,
                "hits": self.hits, "misses": self.misses,
                "expired": self.expired,
                "dropped_stale": self.dropped_stale,
                "hit_rate": round(self.hits / total, 4) if total else 0.0}
