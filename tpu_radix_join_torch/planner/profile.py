"""Device profiles: the calibration constants a plan is keyed under.

The port's part of ``tpu_radix_join/planner/profile.py`` that the plan
cache needs (ROADMAP A17 holds the rest): :class:`DeviceProfile` with its
schema check, citation check and :meth:`~DeviceProfile.fingerprint`, and
:func:`load_profile`.  A constant is ``{"value": x, "source": tag}``; the
port's own profile, ``"h100"``, leaves every constant unset (``"value":
None``) until a calibration on the card measures it — no TPU number is
carried over — so its fingerprint still names the profile and its schema,
and a plan cached under it can never warm-start a run under another.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

#: the JAX package's profile schema (v6: ``result_cache_lookup_ms``)
SCHEMA_VERSION = 6

#: constants the cost model (ROADMAP A17) reads, the JAX package's names
REQUIRED_CONSTANTS = (
    "sort_stage_unit_ms", "full_range_sort_factor", "dispatch_floor_ms",
    "hbm_gbps", "hbm_bytes", "scatter_loop_melems_s", "gather_melems_s",
    "ici_gbps", "ici_bytes_per_s", "partition_pass_unit_ms",
    "radix_sort_pass_unit_ms", "result_cache_lookup_ms",
)

DEFAULT_PROFILE = "h100"
_UNSET = "unset: no calibration on the card yet (ROADMAP A17)"


class ProfileError(ValueError):
    """Malformed, uncited, or incompatible profile document."""


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Immutable view of one device's calibration constants."""

    name: str
    constants: Dict[str, dict]   # key -> {"value": float | None, "source"}
    schema_version: int = SCHEMA_VERSION
    notes: str = ""

    def __post_init__(self):
        if self.schema_version > SCHEMA_VERSION:
            raise ProfileError(
                f"profile {self.name!r} has schema_version "
                f"{self.schema_version}; this build understands "
                f"<= {SCHEMA_VERSION}")
        for key in REQUIRED_CONSTANTS:
            if key not in self.constants:
                raise ProfileError(
                    f"profile {self.name!r} is missing constant {key!r}")
        for key, entry in self.constants.items():
            if (not isinstance(entry, dict) or "value" not in entry
                    or not str(entry.get("source", "")).strip()):
                raise ProfileError(
                    f"profile {self.name!r} constant {key!r} must be "
                    f"{{'value': ..., 'source': <measurement tag>}}")

    def value(self, key: str) -> float:
        """The constant's value; an unset one raises, naming its source."""
        entry = self.constants.get(key)
        if entry is None:
            raise ProfileError(f"profile {self.name!r} has no constant "
                               f"{key!r}")
        if entry["value"] is None:
            raise ProfileError(f"profile {self.name!r} constant {key!r} is "
                               f"{entry['source']}")
        return float(entry["value"])

    def fingerprint(self) -> dict:
        """Stable identity for cache keys and manifests: a plan or capacity
        cached under one profile never warm-starts a run under another."""
        return {"name": self.name, "schema_version": self.schema_version,
                "constants": {k: self.constants[k]["value"]
                              for k in sorted(self.constants)}}


#: the port's packaged profiles, by name
_BUILTIN = {
    "h100": DeviceProfile(
        name="h100",
        constants={k: {"value": None, "source": _UNSET}
                   for k in REQUIRED_CONSTANTS},
        notes="NVIDIA H100 (sm_90a); every constant unset until a "
              "calibration on the card measures it"),
}


def load_profile(name_or_path: str = DEFAULT_PROFILE) -> DeviceProfile:
    """A packaged profile by name (``"h100"``), or a profile JSON file by
    path."""
    if not os.path.exists(name_or_path):
        if name_or_path in _BUILTIN:
            return _BUILTIN[name_or_path]
        raise ProfileError(
            f"no profile {name_or_path!r}: not a file, and the port "
            f"packages only {sorted(_BUILTIN)}")
    try:
        with open(name_or_path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ProfileError(f"unreadable profile {name_or_path}: {e!r}") from e
    try:
        return DeviceProfile(
            name=doc["name"], constants=dict(doc["constants"]),
            schema_version=int(doc.get("schema_version", 1)),
            notes=doc.get("notes", ""))
    except KeyError as e:
        raise ProfileError(f"profile {name_or_path} missing field {e}") from e
