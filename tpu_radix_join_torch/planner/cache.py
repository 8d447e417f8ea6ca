"""Warm-start plan cache and multi-rank run manifest.

The port's copy of ``tpu_radix_join/planner/cache.py:59-238``.  The
engine's sizing pass (the histograms' readback and the worst demand's
``all_reduce``) runs once per cold join; the cache keeps, per (profile,
shapes, configuration) key:

  * the chosen :class:`~tpu_radix_join_torch.planner.plan.JoinPlan`, and
  * the engine's **converged window capacities** (cap_r, cap_s and the
    local slack after any capacity retries),

so a warm join skips the sizing pass: no JHIST, and one CKPTLOAD when the
entry comes from disk.

Every entry is a :class:`~tpu_radix_join_torch.robustness.checkpoint.
CheckpointManager` file: atomic tmp + fsync + rename writes, a corrupt
file is a miss, and the profile fingerprint is part of each entry's
fingerprint, so capacities cached under one profile never warm-start a
run under another (:class:`CheckpointMismatch` is a miss and an event,
and the next store overwrites the entry).  The key is the shapes, not the
data, so a warm capacity is a guess for other data of the same shape: the
engine's capacity retry loop stays the backstop.  An in-process hot layer
serves repeated lookups from memory, re-validated against the file's
(mtime, size) on every hit.

The **manifest**: rank 0 records the rank count and the profile
fingerprint; a later run over the same directory with another topology
or profile fails with :class:`ManifestMismatch`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

from tpu_radix_join_torch.planner.plan import JoinPlan, PlanError
from tpu_radix_join_torch.planner.profile import DeviceProfile
from tpu_radix_join_torch.robustness.checkpoint import (
    CheckpointManager, CheckpointMismatch)

MANIFEST_NAME = "manifest.json"


class ManifestMismatch(ValueError):
    """Plan-cache directory belongs to a different topology or profile."""


def _canonical(doc: dict) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


class PlanCache:
    """On-disk plan + capacity cache rooted at ``cache_dir``."""

    def __init__(self, cache_dir: str, profile: DeviceProfile,
                 measurements=None):
        self.cache_dir = cache_dir
        self.profile = profile
        self.measurements = measurements
        # in-process hot layer (resident sessions, service/session.py):
        # repeated same-shape queries inside one process resolve from
        # memory — no JSON re-parse, no fingerprint re-check — while the
        # disk entry remains the cross-process/cold-start truth.  Keyed by
        # entry path, so the fingerprint discipline is inherited: a
        # different profile or config hashes to a different path.  Each
        # hot entry carries the (mtime_ns, size) of the disk file it was
        # parsed from; a cheap stat on every hot hit keeps it coherent
        # with external writers (another PlanCache over the same dir,
        # corruption) — an out-of-date hot entry falls back to the disk
        # path and its stale/corrupt handling, never serves stale data.
        self._hot: dict = {}
        os.makedirs(cache_dir, exist_ok=True)

    # ------------------------------------------------------------- keys

    def _key_fields(self, r_tuples: int, s_tuples: int,
                    config_fp: dict) -> dict:
        return {"r_tuples": int(r_tuples), "s_tuples": int(s_tuples),
                "config": config_fp}

    @staticmethod
    def _stat_sig(path: str):
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def _entry(self, key_fields: dict) -> CheckpointManager:
        digest = hashlib.sha256(
            _canonical(key_fields).encode()).hexdigest()[:16]
        path = os.path.join(self.cache_dir, f"plan_{digest}.json")
        fingerprint = {"profile": self.profile.fingerprint(), **key_fields}
        return CheckpointManager(path, fingerprint,
                                 measurements=self.measurements)

    # ------------------------------------------------------------ lookup

    def lookup(self, r_tuples: int, s_tuples: int, config_fp: dict
               ) -> Tuple[Optional[JoinPlan], Optional[dict]]:
        """(plan, capacities) on a hit; (None, None) on a miss.  A
        fingerprint conflict (same shapes, different profile constants) or
        a corrupt entry is a miss, recorded as a trace event — a stale
        entry must degrade to a cold start, never a wrong warm one."""
        entry = self._entry(self._key_fields(r_tuples, s_tuples, config_fp))
        m = self.measurements
        if entry.path in self._hot:
            plan, caps, sig = self._hot[entry.path]
            if sig == self._stat_sig(entry.path):
                if m is not None:
                    m.event("plan_cache_hit", path=entry.path, hot=True,
                            strategy=plan.strategy if plan else None,
                            warm_capacities=caps is not None)
                return plan, caps
            # disk changed underneath us: re-validate the slow way
            del self._hot[entry.path]
        # stat BEFORE the load: if a writer lands between the two, the
        # recorded signature is older than the content and the next hot
        # hit falls back to disk — conservative, never stale
        sig = self._stat_sig(entry.path)
        try:
            state = entry.load()
        except CheckpointMismatch as e:
            if m is not None:
                m.event("plan_cache_stale", path=entry.path, error=str(e))
            return None, None
        if state is None:
            return None, None
        plan = None
        if "plan" in state:
            try:
                plan = JoinPlan.from_dict(state["plan"])
            except (TypeError, PlanError) as e:
                if m is not None:
                    m.event("plan_cache_corrupt", path=entry.path,
                            error=repr(e))
                return None, None
        caps = state.get("capacities")
        self._hot[entry.path] = (plan, caps, sig)
        if m is not None:
            m.event("plan_cache_hit", path=entry.path, hot=False,
                    strategy=plan.strategy if plan else None,
                    warm_capacities=caps is not None)
        return plan, caps

    def store(self, r_tuples: int, s_tuples: int, config_fp: dict,
              plan: Optional[JoinPlan] = None,
              capacities: Optional[dict] = None) -> bool:
        """Persist a plan and/or the engine's converged window capacities
        (the engine stores capacity-only entries when it runs unplanned).
        Overwrites stale entries; save failures degrade to a trace event,
        same as checkpoints."""
        entry = self._entry(self._key_fields(r_tuples, s_tuples, config_fp))
        # merge with the existing entry (a planned run stores the plan
        # first, the engine adds capacities after converging) — read via an
        # uninstrumented manager: CKPTLOAD counts *warm starts*, not the
        # read-modify-write here
        probe = CheckpointManager(entry.path, entry.fingerprint,
                                  measurements=None)
        try:
            state = probe.load() or {}
        except CheckpointMismatch:
            state = {}          # stale entry: overwrite
        state.pop("done", None)
        if plan is not None:
            state["plan"] = plan.to_dict()
        if capacities is not None:
            state["capacities"] = {k: int(v) for k, v in capacities.items()}
        # keep the hot layer coherent with what just hit (or failed to hit)
        # the disk: the merged state is what a fresh lookup would parse
        hot_plan, hot_caps, _ = self._hot.get(entry.path, (None, None, None))
        if plan is not None:
            hot_plan = plan
        if capacities is not None:
            hot_caps = dict(state["capacities"])
        ok = entry.save(state, done=True)
        if ok:
            self._hot[entry.path] = (hot_plan, hot_caps,
                                     self._stat_sig(entry.path))
        else:
            self._hot.pop(entry.path, None)
        return ok

    # ---------------------------------------------------------- manifest

    def manifest_path(self) -> str:
        return os.path.join(self.cache_dir, MANIFEST_NAME)

    def write_manifest(self, num_ranks: int, rank: int = 0) -> bool:
        """Rank 0 stamps the directory with the run topology + profile.
        Non-zero ranks are no-ops — one writer, everyone checks."""
        if rank != 0:
            return True
        mgr = CheckpointManager(
            self.manifest_path(),
            {"kind": "plan_cache_manifest"},
            measurements=None)          # manifest writes don't count CKPTSAVE
        return mgr.save({"num_ranks": int(num_ranks),
                         "profile": self.profile.fingerprint()}, done=True)

    def check_manifest(self, num_ranks: int) -> None:
        """Raise :class:`ManifestMismatch` when this directory was written
        by a different topology or profile; silently pass when no manifest
        exists yet (fresh directory)."""
        path = self.manifest_path()
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError):
            # corrupt manifest: treat like a fresh dir (entries still carry
            # their own fingerprints, so safety does not depend on it)
            if self.measurements is not None:
                self.measurements.event("manifest_corrupt", path=path)
            return
        saved_ranks = state.get("num_ranks")
        saved_profile = state.get("profile")
        if saved_ranks != int(num_ranks):
            raise ManifestMismatch(
                f"plan cache {self.cache_dir} was written by a "
                f"{saved_ranks}-rank run; this run has {num_ranks} ranks — "
                f"resuming would desynchronize the ranks' collectives. Use a "
                f"fresh --plan-cache-dir or rerun at the original size.")
        if saved_profile != self.profile.fingerprint():
            raise ManifestMismatch(
                f"plan cache {self.cache_dir} was written under profile "
                f"{(saved_profile or {}).get('name')!r} with different "
                f"constants than {self.profile.name!r} — cached capacities "
                f"are not transferable across calibrations. Use a fresh "
                f"--plan-cache-dir.")
