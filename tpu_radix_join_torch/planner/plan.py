"""The planner's decision, in command-line vocabulary, and its
serialisation.

The port's :class:`JoinPlan` of ``tpu_radix_join/planner/plan.py``
(schema v5), as far as the plan cache needs it: the dataclass with
``to_dict`` / ``from_dict`` / ``save`` / ``load``.
Choosing a plan (``plan_join``, the cost model) is ROADMAP A17.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

PLAN_SCHEMA_VERSION = 5


class PlanError(ValueError):
    """No feasible strategy, or a malformed plan file."""


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """``engine`` routes between the in-core join (HashJoin) and the
    out-of-core grid (ops/chunked.py); the other fields map onto
    JoinConfig and the command line; ``strategy`` / ``predicted_ms`` /
    ``predicted_terms`` record the winning cost row."""

    engine: str                       # "incore" | "chunked"
    fused: bool = True                # False -> measure_phases
    probe: str = "sort"               # "sort" | "bucket"
    two_level: bool = False
    key_range: str = "auto"           # "narrow" | "full" | "auto"
    network_fanout_bits: int = 5
    local_fanout_bits: int = 5
    chunk_tuples: Optional[int] = None   # chunked engine only
    grid_pipeline: str = "auto"          # "off" | "on" | "auto"
    exchange_codec: str = "off"          # "off" | "pack"
    exchange_stages: int = 1             # 1 = fused, k > 1 staged
    sort_impl: str = "auto"
    pipeline_repeats: bool = False
    strategy: str = ""
    predicted_ms: float = 0.0
    predicted_terms: dict = dataclasses.field(default_factory=dict)
    profile_name: str = ""
    schema_version: int = PLAN_SCHEMA_VERSION

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, doc: dict) -> "JoinPlan":
        doc = dict(doc)
        version = int(doc.get("schema_version", 1))
        if version > PLAN_SCHEMA_VERSION:
            raise PlanError(
                f"plan schema_version {version} is newer than this build "
                f"understands (<= {PLAN_SCHEMA_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - known
        if unknown:
            raise PlanError(f"unknown plan fields {sorted(unknown)}")
        if doc.get("engine") not in ("incore", "chunked"):
            raise PlanError(f"plan engine must be incore|chunked, "
                            f"got {doc.get('engine')!r}")
        return cls(**doc)

    def save(self, path: str) -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "JoinPlan":
        try:
            with open(path) as f:
                return cls.from_dict(json.load(f))
        except (OSError, json.JSONDecodeError) as e:
            raise PlanError(f"unreadable plan file {path}: {e!r}") from e

