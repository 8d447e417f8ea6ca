"""The single-GPU join engine.

Counterpart of the ``num_nodes == 1`` sort-probe specialisation of
``tpu_radix_join/operators/hash_join.py`` (``_pipeline_fn``'s n == 1 branch,
``join``, ``join_arrays``, ``place``, ``_finish_join``).  At one node the
shuffle is an identity, so the whole join is:

  1. pack both key lanes partition-major (ops/merge_count._pack_pm);
  2. sort the packed union (K2, the LSD radix sort);
  3. the fused merge-scan probe (K3): per-partition uint32 counts and the
     largest single weight;
  4. the uint32 overflow-risk guard, which runs the partition histogram
     (K1) only when the one scalar readback says a count might wrap;
  5. a host uint64 sum of the per-partition counts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_radix_join_torch.core.config import JoinConfig
from tpu_radix_join_torch.core.device import resolve_device
from tpu_radix_join_torch.data.relation import Relation
from tpu_radix_join_torch.data.tuples import TupleBatch, _sentinel_lane
from tpu_radix_join_torch.ops.merge_count import (MAX_MERGE_KEY,
                                                  merge_count_per_partition)
from tpu_radix_join_torch.ops.radix import local_histogram

# failure classes, in priority order (robustness/retry.classify_diagnostics
# of the JAX package): fatal flags outrank capacity shortfalls
_FATAL_FLAGS = (
    ("key_contract_violations", "key_contract"),
    ("conservation_violations", "conservation"),
    ("data_corruption_partitions", "data_corruption"),
    ("count_overflow_risk", "count_overflow_risk"),
)
_CAPACITY_FLAGS = ("shuffle_overflow_r_tuples", "shuffle_overflow_s_tuples",
                   "local_overflow", "hot_overflow")


def classify_diagnostics(diag: dict) -> str:
    """Map a diagnostics dict to its failure-class string."""
    for flag, cls in _FATAL_FLAGS:
        if diag.get(flag, 0):
            return cls
    if any(diag.get(flag, 0) for flag in _CAPACITY_FLAGS):
        return "capacity_overflow"
    return "ok"


class JoinResult(NamedTuple):
    matches: int                  # exact match count (host uint64 sum)
    ok: bool                      # no flag raised
    partition_counts: np.ndarray  # uint32 [P] per-partition counts
    diagnostics: Optional[dict] = None   # failure breakdown (_flags_to_diag)


def _minmax_i32(lane: torch.Tensor) -> torch.Tensor:
    """int64 [2]: (min, max) of an int32 lane as signed values; a uint32
    lane lies below 2**31 exactly when its signed min is non-negative."""
    if lane.numel() == 0:
        return torch.tensor([0, 0], dtype=torch.int64, device=lane.device)
    lo, hi = torch.aminmax(lane)
    return torch.stack([lo, hi]).to(torch.int64)


def _all_below(minmax: np.ndarray, cap: int) -> bool:
    """True when every uint32 value of a lane with signed (min, max)
    ``minmax`` is below ``cap`` (<= 2**31)."""
    return bool(minmax[0] >= 0 and minmax[1] < cap)


class HashJoin:
    """The join engine; ``device`` is "cuda" unless the caller asks for
    "cpu", where every kernel takes its plain PyTorch version."""

    def __init__(self, config: Optional[JoinConfig] = None, device="cuda"):
        self.config = config if config is not None else JoinConfig()
        self.device = resolve_device(device)

    # ------------------------------------------------------------- checks
    def _check_batches(self, r: TupleBatch, s: TupleBatch) -> None:
        for name, b in (("inner", r), ("outer", s)):
            if b.key_hi is not None:
                raise NotImplementedError(
                    f"the {name} batch carries a key_hi lane: 64-bit keys "
                    "are not ported to PyTorch yet (ROADMAP.md A9)")
            for lane in (b.key, b.rid):
                if lane.dtype != torch.int32 or lane.dim() != 1:
                    raise ValueError(
                        f"{name} lanes must be 1-D int32 (uint32 bits), got "
                        f"{lane.dtype} rank {lane.dim()}")
                if lane.device != self.device:
                    raise ValueError(
                        f"{name} lanes live on {lane.device}, the engine "
                        f"on {self.device}")
            if b.key.shape != b.rid.shape:
                raise ValueError(f"{name} key and rid lanes differ in length")
        if r.size + s.size >= 1 << 31:
            raise ValueError("the sort probe counts in 32 bits: |R| + |S| "
                             "must stay below 2**31")

    def _resolve_key_range(self, key_minmax: torch.Tensor,
                           key_bound: Optional[int]) -> None:
        """``key_range``: "narrow" takes the packed probe as is; "auto"
        decides from the relations' static key bound when one is known,
        else from the device (min, max) of both key lanes (one readback).
        A full-range result is not ported yet."""
        if self.config.key_range == "narrow":
            return
        if key_bound is not None:
            full = key_bound - 1 > MAX_MERGE_KEY
        else:
            mm = key_minmax.cpu().numpy()
            full = not _all_below(np.array([mm[:, 0].min(), mm[:, 1].max()]),
                                  MAX_MERGE_KEY + 1)
        if full:
            raise NotImplementedError(
                "keys above MAX_MERGE_KEY need the full-range probe, which "
                "is not ported to PyTorch yet (ROADMAP.md A9); "
                "key_range='narrow' flags them instead")

    @staticmethod
    def _count_risk(max_weight: int, s_hist: np.ndarray) -> bool:
        """True when some partition's uint32 match count could have wrapped:
        count_p <= max_weight * outer_p, so ``outer_p > (2**32 - 1) //
        max_weight`` flags every count that might reach 2**32."""
        limit = 0xFFFFFFFF // max(max_weight, 1)
        return bool((s_hist.astype(np.uint64) > limit).any())

    @staticmethod
    def _flags_to_diag(flags: np.ndarray) -> dict:
        """Failure breakdown from the 7-entry flag vector (the JAX
        package's layout: the shuffle and local entries stay 0 here)."""
        diag = {
            "key_contract_violations": int(flags[0]),
            "shuffle_overflow_r_tuples": int(flags[1]),
            "shuffle_overflow_s_tuples": int(flags[2]),
            "conservation_violations": int(flags[3]),
            "local_overflow": int(flags[4]),
            "hot_overflow": int(flags[5]),
            "count_overflow_risk": int(flags[6]) if len(flags) > 6 else 0,
        }
        diag["failure_class"] = classify_diagnostics(diag)
        return diag

    # ------------------------------------------------------------- joins
    def join_arrays(self, r: TupleBatch, s: TupleBatch,
                    key_bound: Optional[int] = None) -> JoinResult:
        """Join two placed batches (lanes on the engine's device).
        ``key_bound``, when known, is an exclusive bound on both relations'
        keys; with ``key_range="auto"`` it spares the device max-key probe
        (:meth:`join` passes the relations' static bounds)."""
        self._check_batches(r, s)
        cfg = self.config
        num_p = cfg.network_partition_count
        # (min, max) of both sentinel lanes: the contract check, and the
        # key-range probe when no static bound is known
        key_minmax = torch.stack([_minmax_i32(_sentinel_lane(r)),
                                  _minmax_i32(_sentinel_lane(s))])
        self._resolve_key_range(key_minmax, key_bound)
        counts, maxw = merge_count_per_partition(
            r.key, s.key, cfg.network_fanout_bits, return_max_weight=True)
        # the join's one readback: contract check, max weight, counts
        host = torch.cat([key_minmax.flatten(), maxw.reshape(1).to(torch.int64),
                          counts.to(torch.int64)]).cpu().numpy()
        keys_ok = (_all_below(host[0:2], MAX_MERGE_KEY + 1)
                   and _all_below(host[2:4], MAX_MERGE_KEY + 1))
        maxw = int(host[4]) & 0xFFFFFFFF
        counts = (host[5:] & 0xFFFFFFFF).astype(np.uint32)
        # overflow-risk bound: the scalar pre-test maxw * |S| < 2**32
        # clears every realistic workload with no extra pass; only a
        # suspect workload pays the per-partition histogram
        scalar_limit = (2**32 - 1) // max(1, s.size)
        if maxw > scalar_limit:
            s_pid = torch.bitwise_and(s.key, num_p - 1)
            s_hist = local_histogram(s_pid, num_p)
            count_risk = self._count_risk(
                maxw, s_hist.cpu().numpy().view(np.uint32))
        else:
            count_risk = False
        flags = np.array([int(not keys_ok), 0, 0, 0, 0, 0, int(count_risk)],
                         dtype=np.uint32)
        diag = self._flags_to_diag(flags)
        # host uint64 sum: a device sum of uint32 counts would wrap at scale
        matches = int(counts.astype(np.uint64).sum())
        return JoinResult(matches=matches, ok=not flags.any(),
                          partition_counts=counts, diagnostics=diag)

    def place(self, rel: Relation) -> TupleBatch:
        """Generate a relation on the engine's device."""
        if rel.num_nodes != self.config.num_nodes:
            raise ValueError("relation num_nodes must match config.num_nodes")
        batch = rel.generate(self.device)
        if self.device.type == "cuda":
            # generation is asynchronous: it must not finish inside a
            # later join's timers
            torch.cuda.synchronize(self.device)
        return batch

    def join(self, inner: Relation, outer: Relation) -> JoinResult:
        """Join two relation specs; their static key bounds resolve
        ``key_range="auto"`` without the device max-key probe."""
        return self.join_arrays(
            self.place(inner), self.place(outer),
            key_bound=max(inner.key_bound(), outer.key_bound()))
