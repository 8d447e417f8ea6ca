"""Elastic recovery: re-plan on shrink or growth, resume by partition.

The port's copy of ``tpu_radix_join/robustness/recovery.py``.  Once a rank
is declared lost (:class:`~tpu_radix_join_torch.robustness.membership.
RankLost`), the aborted join becomes a bounded recompute instead of a
restart:

  1. **Resume** — read the partition manifest (``checkpoint.
     PartitionManifest``): every partition some rank realised before the
     death is done and its count is trusted (a line is written only after
     its count is on the host, so trusting it never overclaims).
  2. **Re-plan** — the partitions not done are assigned over the
     survivors with the boot mesh's own machinery
     (``histograms/assignment_map``): load-aware LPT over per-partition
     weights when they are known, round-robin otherwise.  ``joined_ranks``
     (admitted through the membership view's ``joining`` lease) enlarge
     the survivor set, so an admission re-expands the map onto the
     newcomer as a loss shrinks it.  Every survivor computes the same map
     from the shared lease and manifest state, with no coordinator.  The
     planner re-prices the strategies for the changed mesh under the
     port's ``h100`` profile, as advice only: a missing profile never
     blocks recovery.
  3. **Recompute out of band** — each unfinished partition re-joins as its
     own masked ``ops/chunked.chunked_join_grid`` (``(key & (P-1)) == p``),
     the machinery ``verify="repair"`` trusts, over inputs regenerated on
     the host from the seeded relations (:func:`host_keys`, the native
     generator).  On the card that grid is K2's slab sorts and K6's window
     scans, or it raises: there is no host or library fallback.  Nothing
     touches the process group: a survivor never enters a collective on a
     group that holds a dead rank.

Counters: ``RECOVERN`` a partition recomputed (below the partition count
whenever the manifest resumed anything: the sign that resume was by
partition, not a disguised restart), ``RECOVERMS`` the recovery's
milliseconds.  A recovered result's diagnostics carry the recovery record
(lost ranks, epoch, resumed and recomputed partitions, reassignment,
re-priced plan), which forensics bundles render as the recovery timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_radix_join_torch.core.device import resolve_device
from tpu_radix_join_torch.data.relation import key_hi_lane_np
from tpu_radix_join_torch.data.tuples import (TupleBatch, lane_from_numpy,
                                              narrow)
from tpu_radix_join_torch.histograms.assignment_map import (
    load_aware_assignment, round_robin_assignment)
from tpu_radix_join_torch.performance.measurements import RECOVERMS, RECOVERN
from tpu_radix_join_torch.robustness.membership import RankLost


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """The survivors' decision record (the same on every survivor)."""

    epoch: int                      # membership epoch the recovery fences to
    lost_ranks: Tuple[int, ...]
    survivors: Tuple[int, ...]
    num_partitions: int
    #: partitions whose counts resume from the manifest (trusted, done)
    resumed: Dict[int, int]
    #: partitions to recompute, in ascending order
    recompute: Tuple[int, ...]
    #: recompute partition -> survivor rank that owns the recompute
    reassignment: Dict[int, int]
    #: re-priced strategy for the changed mesh (advisory; "" = no profile)
    replan_strategy: str = ""
    replan_predicted_ms: float = 0.0

    def to_diag(self) -> dict:
        return {
            "recovered": True,
            "membership_epoch": self.epoch,
            "lost_ranks": list(self.lost_ranks),
            "survivors": list(self.survivors),
            "resumed_partitions": sorted(self.resumed),
            "recovered_partitions": list(self.recompute),
            "recovery_assignment": {str(p): r
                                    for p, r in self.reassignment.items()},
            "replan_strategy": self.replan_strategy,
            "replan_predicted_ms": round(self.replan_predicted_ms, 3),
        }


def plan_recovery(*, num_nodes: int, num_partitions: int,
                  lost_ranks, epoch: int, manifest=None,
                  weights: Optional[np.ndarray] = None,
                  profile=None, workload=None,
                  joined_ranks=()) -> RecoveryPlan:
    """The survivors' :class:`RecoveryPlan`.

    ``manifest`` supplies the resumable counts; ``weights`` (per-partition
    R + S tuple counts, a host array of ``num_partitions``) switches the
    reassignment from round-robin to load-aware LPT; ``profile`` and
    ``workload`` (``planner.profile.DeviceProfile``, ``planner.cost_model.
    Workload``) re-price the strategies for the changed mesh.

    ``joined_ranks`` is the growth half: ranks the membership view admitted
    beyond (or back into) the boot mesh.  The survivor set, and with it the
    reassignment and the re-priced workload, expands over them; a newcomer
    computes the same :func:`host_keys` every incumbent does, so nothing of
    the old group is read."""
    lost = tuple(sorted(set(int(r) for r in lost_ranks)))
    members = set(range(num_nodes)) | {int(r) for r in joined_ranks}
    survivors = tuple(sorted(members - set(lost)))
    if not survivors:
        raise RankLost(lost[0] if lost else 0, epoch,
                       "no survivors to recover onto")
    resumed: Dict[int, int] = {}
    if manifest is not None:
        for p, rec in manifest.completed().items():
            if 0 <= p < num_partitions:
                resumed[p] = rec["count"]
    recompute = tuple(p for p in range(num_partitions) if p not in resumed)
    # the assignment over the survivor count, mapped back to survivor ids:
    # every survivor computes the same map without a broadcast
    if weights is not None and len(recompute) > 0:
        w = np.zeros(num_partitions, np.float32)
        w[list(recompute)] = np.asarray(weights, np.float32)[list(recompute)]
        # integral float32 weights travel exactly as uint32 lanes
        lane = narrow(torch.from_numpy(w.astype(np.int64)))
        amap = load_aware_assignment(lane, torch.zeros_like(lane),
                                     len(survivors)).numpy()
    else:
        amap = round_robin_assignment(num_partitions,
                                      max(1, len(survivors))).numpy()
    reassignment = {int(p): int(survivors[int(amap[p])]) for p in recompute}
    strategy, predicted_ms = "", 0.0
    if profile is not None and workload is not None:
        try:
            from tpu_radix_join_torch.planner.plan import plan_join
            shrunk = dataclasses.replace(workload, num_nodes=len(survivors))
            plan, _ = plan_join(profile, shrunk)
            strategy, predicted_ms = plan.strategy, plan.predicted_ms
        except Exception:   # noqa: BLE001 — re-pricing is advice only
            pass
    return RecoveryPlan(epoch=epoch, lost_ranks=lost, survivors=survivors,
                        num_partitions=num_partitions, resumed=resumed,
                        recompute=recompute, reassignment=reassignment,
                        replan_strategy=strategy,
                        replan_predicted_ms=predicted_ms)


def host_keys(rel, num_threads: int = 0
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A relation's global key lanes, regenerated on the host.

    Recovery's input path: the seeded generators are deterministic, so a
    survivor rebuilds the global relation, the dead rank's shards
    included, without reading anything of the group.  The shards lie in
    node order, so one native fill of the global index range is their
    concatenation (``Relation.shard_np`` node by node, as JAX's
    ``host_keys`` reads them)."""
    keys, _ = rel.fill_np(0, rel.global_size, num_threads)
    return keys, (key_hi_lane_np(keys) if rel.key_bits == 64 else None)


def relation_inputs(inner, outer):
    """``HashJoin.elastic_inputs`` for a join of two Relation specs: the
    global host lanes ``(r_keys, r_hi, s_keys, s_hi)`` regenerated from
    the seeded specs (:func:`host_keys`), never from the group's
    tensors."""
    return lambda: (*host_keys(inner), *host_keys(outer))


def partition_weights(r_keys: np.ndarray, s_keys: np.ndarray,
                      num_partitions: int) -> np.ndarray:
    """Per-partition R + S tuple counts (the LPT weights) from host key
    lanes, one bincount each."""
    mask = np.uint32(num_partitions - 1)
    rw = np.bincount(np.asarray(r_keys, np.uint32) & mask,
                     minlength=num_partitions)
    sw = np.bincount(np.asarray(s_keys, np.uint32) & mask,
                     minlength=num_partitions)
    return (rw + sw).astype(np.float32)


def _owners(only_rank):
    if only_rank is None:
        return None
    if isinstance(only_rank, int):
        return {int(only_rank)}
    return {int(r) for r in only_rank}


def execute_recovery(plan: RecoveryPlan,
                     r_keys: np.ndarray, s_keys: np.ndarray,
                     r_hi: Optional[np.ndarray] = None,
                     s_hi: Optional[np.ndarray] = None,
                     *, only_rank=None,
                     slab: int = 1 << 20, pipeline: str = "off",
                     measurements=None, manifest=None,
                     clock=time.monotonic, device="cuda",
                     sort_impl: str = "auto") -> Tuple[int, Dict[int, int]]:
    """Recompute the plan's unfinished partitions on ``device`` (the card
    unless the caller asks for the CPU); returns ``(matches, counts)``,
    ``counts`` mapping every partition this call accounted for (resumed and
    recomputed) to its count.

    ``only_rank`` (an int or an iterable of them) restricts the recompute to
    the partitions the reassignment gave those survivors: each appends its
    partitions to the shared ``manifest`` and the totals merge through it;
    None recomputes them all (one survivor, or the simulated death).  The
    host lanes go to the device once; each partition is one masked
    ``chunked_join_grid`` under a ``recover_partition`` span, marked done in
    the manifest only after its count is on the host."""
    from tpu_radix_join_torch.ops.chunked import chunked_join_grid
    m = measurements
    t0 = clock()
    counts: Dict[int, int] = dict(plan.resumed)
    num_p = plan.num_partitions
    mine = _owners(only_rank)
    todo = [p for p in plan.recompute
            if mine is None or plan.reassignment[p] in mine]
    lanes = None
    if todo:
        dev = resolve_device(device)
        rk, sk = (lane_from_numpy(a, dev) for a in (r_keys, s_keys))
        rh, sh = (None if a is None else lane_from_numpy(a, dev)
                  for a in (r_hi, s_hi))
        # partition ids of the low key bits, and their sizes in one readback
        rp, sp = rk & (num_p - 1), sk & (num_p - 1)
        sizes = torch.stack([torch.bincount(rp, minlength=num_p),
                             torch.bincount(sp, minlength=num_p)]).cpu()
        lanes = (rk, rh, rp, sk, sh, sp)
    recovered = 0
    for p in todo:
        rk, rh, rp, sk, sh, sp = lanes
        n_r, n_s = int(sizes[0, p]), int(sizes[1, p])
        cnt = 0
        if n_r and n_s:
            span = (m.span("recover_partition", partition=int(p),
                           owner=plan.reassignment[p])
                    if m is not None else contextlib.nullcontext())
            with span:
                sides = []
                for key, hi, pid in ((rk, rh, rp), (sk, sh, sp)):
                    sel = pid == p
                    k = torch.masked_select(key, sel)
                    sides.append(TupleBatch(
                        key=k, rid=torch.zeros_like(k),
                        key_hi=None if hi is None
                        else torch.masked_select(hi, sel)))
                cnt = chunked_join_grid(
                    [sides[0]], [sides[1]], max(1, min(slab, n_s)),
                    measurements=m, pipeline=pipeline, sort_impl=sort_impl)
        counts[p] = int(cnt)
        recovered += 1
        if manifest is not None:
            manifest.mark_done(p, int(cnt), plan.reassignment[p],
                               epoch=plan.epoch)
    if manifest is not None and only_rank is not None:
        # the merge over the survivors: partitions others realised (their
        # lines follow their counts, so this under- but never over-counts)
        for p, rec in manifest.completed().items():
            counts.setdefault(int(p), rec["count"])
    matches = int(sum(counts.values()))
    if m is not None:
        m.incr(RECOVERN, recovered)
        m.incr(RECOVERMS, int((clock() - t0) * 1000))
        m.event("recovery", epoch=plan.epoch,
                lost_ranks=list(plan.lost_ranks),
                resumed=len(plan.resumed), recomputed=recovered,
                matches=matches)
    return matches, counts
