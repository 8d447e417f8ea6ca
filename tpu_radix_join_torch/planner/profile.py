"""Device profiles: versioned, cited calibration constants.

The port's copy of ``tpu_radix_join/planner/profile.py``.  A profile is a
small JSON document holding every hardware constant the cost model
(planner/cost_model.py) reads; each constant is ``{"value": x, "source":
tag}``, the tag naming the measurement it came from, and may carry a
schema-v3 ``"provenance"`` block (fit origin, ledger run ids, sample
count, 95% CI, residual, fit time) that planner/calibrate.py writes.
Profiles of schema v1-v5 load through the JAX package's shims.

The packaged profiles live in ``profiles/`` beside this module.  The
port's own, ``profiles/h100.json``, was fitted on the card by
``chip_smoke.py``'s phase (u) (:func:`calibrate` and
``calibrate.fit_profile``); no TPU number is carried over.  A constant
nothing on one card can measure stays unset (``"value": null``, its
source saying why): :meth:`DeviceProfile.value` raises on it, naming the
reason, so a plan that needs it is refused rather than priced on a guess.

:func:`calibrate` times the device it is given with CUDA events (the host
clock around synchronous work on the CPU): the elementwise envelope, the
sort stage unit on stable ``torch.sort`` (the cost model's ``xla`` arm),
the dispatch floor, and the card's memory.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional

#: the JAX package's profile schema: v2 ``ici_bytes_per_s``, v3 provenance
#: blocks, v4 ``partition_pass_unit_ms``, v5 ``radix_sort_pass_unit_ms``,
#: v6 ``result_cache_lookup_ms``
SCHEMA_VERSION = 6

#: constants the cost model reads, the JAX package's names and meanings
REQUIRED_CONSTANTS = (
    # sort emitter cost: ms per stage-unit at the 33.5M reference size
    # (t = unit * (M / 33.5M) * U(M), U = k(k+1)/2); the xla arm
    "sort_stage_unit_ms",
    # the full-range (or 2-lane) sort over the packed single-lane sort at
    # an equal element count
    "full_range_sort_factor",
    # per-program dispatch round trip (does not pipeline)
    "dispatch_floor_ms",
    # sustained bandwidth of one elementwise pass (read + write)
    "hbm_gbps",
    # device memory envelope the in-core engine may occupy
    "hbm_bytes",
    # the sort-backed grouping arm's rate, M elements/s
    "scatter_loop_melems_s",
    # random-gather rate, M elements/s
    "gather_melems_s",
    # per-device interconnect bandwidth the exchange rides, GB/s
    "ici_gbps",
    # the same link in bytes/s (the codec-aware wire time's unit)
    "ici_bytes_per_s",
    # the grouping kernel (K4): ms per million tuples per streaming pass
    # (the model charges two passes)
    "partition_pass_unit_ms",
    # the radix sort (K2): ms per million tuples per digit pass
    "radix_sort_pass_unit_ms",
    # the serving result cache: ms per fingerprint + LRU probe on the host
    "result_cache_lookup_ms",
)

#: reference element count of the sort stage model's unit (the JAX
#: package's 33.5M packed union)
SORT_REF_ELEMS = 33_554_432


class ProfileError(ValueError):
    """Malformed, uncited, unset or incompatible profile document."""


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
                    f"{{'value': ..., 'source': <measurement tag>}} — an "
                    f"uncited constant cannot be audited against chip logs")

    def value(self, key: str) -> float:
        """The constant's value; an unset one raises, naming its source."""
        entry = self.constants.get(key)
        if entry is None:
            raise ProfileError(f"profile {self.name!r} has no constant "
                               f"{key!r}")
        if entry["value"] is None:
            raise ProfileError(f"profile {self.name!r} constant {key!r} is "
                               f"unset: {entry['source']}")
        return float(entry["value"])

    def is_set(self, key: str) -> bool:
        return self.constants.get(key, {}).get("value") is not None

    def source(self, key: str) -> str:
        return str(self.constants[key]["source"])

    def provenance(self, key: str) -> Optional[dict]:
        """The schema-v3 provenance block of one constant, or None for an
        entry that carries only its citation."""
        entry = self.constants.get(key) or {}
        prov = entry.get("provenance")
        return dict(prov) if isinstance(prov, dict) else None

    def freshness(self) -> Optional[float]:
        """Newest ``fitted_at_epoch_s`` across the provenance blocks (what
        ``--profile auto`` compares with its window); None if never
        fitted."""
        stamps = [p["fitted_at_epoch_s"]
                  for p in (self.provenance(k) for k in self.constants)
                  if p and isinstance(p.get("fitted_at_epoch_s"),
                                      (int, float))]
        return max(stamps) if stamps else None

    def fingerprint(self) -> dict:
        """Stable identity for cache keys and manifests: a plan or capacity
        cached under one profile never warm-starts a run under another."""
        return {"name": self.name, "schema_version": self.schema_version,
                "constants": {k: self.constants[k]["value"]
                              for k in sorted(self.constants)}}

    def to_dict(self) -> dict:
        return {"schema_version": self.schema_version, "name": self.name,
                "notes": self.notes, "constants": self.constants}

    def save(self, path: str) -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def replace_constants(self, name: Optional[str] = None,
                          **updates: dict) -> "DeviceProfile":
        """New profile with some constants replaced (each update a full
        ``{"value", "source"}`` entry: a recalibration keeps a citation)."""
        merged = {**self.constants, **updates}
        return dataclasses.replace(self, name=name or self.name,
                                   constants=merged)


def _profiles_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "profiles")


def _shim(constants: dict, version: int, key: str, since: int, basis: str,
          derive) -> None:
    """Schema shim: a profile older than ``since`` that lacks ``key``
    derives it from its cited ``basis`` constant, the derivation in the
    source tag (the JAX package's rules)."""
    entry = constants.get(basis)
    if (version >= since or key in constants or not isinstance(entry, dict)
            or not entry.get("value")):
        return
    constants[key] = {
        "value": derive(float(entry["value"])),
        "source": (f"shim:derived from {basis} (schema v{version} profile; "
                   f"{entry.get('source', 'uncited')})")}


def load_profile(name_or_path: str = "h100") -> DeviceProfile:
    """A packaged profile by bare name (``profiles/<name>.json``), or a
    profile JSON file by path."""
    path = name_or_path
    if not os.path.exists(path):
        candidate = os.path.join(_profiles_dir(), f"{name_or_path}.json")
        if not os.path.exists(candidate):
            raise ProfileError(
                f"no profile {name_or_path!r}: not a file, and "
                f"{candidate} does not exist")
        path = candidate
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ProfileError(f"unreadable profile {path}: {e!r}") from e
    try:
        constants = dict(doc["constants"])
        version = int(doc.get("schema_version", 1))
        # v1: the codec-aware wire time's bytes/s from the cited GB/s
        entry = constants.get("ici_gbps")
        if (version < 2 and "ici_bytes_per_s" not in constants
                and isinstance(entry, dict) and "value" in entry):
            constants["ici_bytes_per_s"] = {
                "value": float(entry["value"]) * 1e9,
                "source": ("shim:derived from ici_gbps (schema v1 profile; "
                           f"{entry.get('source', 'uncited')})")}
        # v1-v3: one grouping pass streams 4 B in and 4 B out a tuple
        _shim(constants, version, "partition_pass_unit_ms", 4, "hbm_gbps",
              lambda gbps: round(8.0 / gbps, 5))
        # v1-v4: a digit pass reads the key lane twice, writes 4 B of slots
        _shim(constants, version, "radix_sort_pass_unit_ms", 5, "hbm_gbps",
              lambda gbps: round(12.0 / gbps, 5))
        # v1-v5: a host hash probe is at most a tenth of a round trip
        _shim(constants, version, "result_cache_lookup_ms", 6,
              "dispatch_floor_ms", lambda ms: round(ms / 10.0, 5))
        return DeviceProfile(name=doc["name"], constants=constants,
                             schema_version=version,
                             notes=doc.get("notes", ""))
    except KeyError as e:
        raise ProfileError(f"profile {path} missing field {e}") from e


#: what the fitter writes beside a ledger; ``--profile auto`` prefers it
#: over the packaged profile while it is fresh
FITTED_PROFILE_BASENAME = "profile_fitted.json"
DEFAULT_PROFILE = "h100"

#: how old a fitted profile may be before ``auto`` falls back to the
#: packaged one (override: TPU_RADIX_PROFILE_FRESH_S)
DEFAULT_FRESH_S = 30 * 86400.0


def resolve_profile(spec: str, ledger_dir: Optional[str] = None,
                    fresh_s: Optional[float] = None) -> str:
    """The command line's ``--profile`` value as a loadable name or path.  Only
    ``auto`` resolves: to ``<ledger_dir>/profile_fitted.json`` when it
    loads and its newest fit is inside the freshness window, else to the
    packaged ``"h100"``."""
    if spec != "auto":
        return spec
    if ledger_dir is None:
        from tpu_radix_join_torch.observability.ledger import \
            default_ledger_dir
        ledger_dir = default_ledger_dir()
    if fresh_s is None:
        fresh_s = float(os.environ.get("TPU_RADIX_PROFILE_FRESH_S",
                                       DEFAULT_FRESH_S))
    candidate = os.path.join(ledger_dir, FITTED_PROFILE_BASENAME)
    if os.path.exists(candidate):
        try:
            fitted_at = load_profile(candidate).freshness()
        except ProfileError:
            return DEFAULT_PROFILE     # an unloadable fit never wins
        if fitted_at is not None and time.time() - fitted_at <= fresh_s:
            return candidate
    return DEFAULT_PROFILE


def format_provenance(profile: DeviceProfile,
                      stale: Optional[dict] = None,
                      now_s: Optional[float] = None) -> str:
    """Per-constant provenance and staleness table, the constants half of
    ``--plan explain``.  ``stale`` is ``calibrate.detect_stale``'s result
    (or any collection of constant names); a flagged row says STALE and
    names its drift.  An unset constant's value cell reads ``unset``."""
    stale = stale or {}
    now_s = time.time() if now_s is None else now_s
    header = ["constant", "value", "origin", "n", "ci95", "residual",
              "age_h", "stale", "runs"]
    rows = []
    for key in sorted(profile.constants):
        prov = profile.provenance(key) or {}
        origin = (prov.get("origin")
                  or profile.source(key).split(":", 1)[0] or "committed")
        n = prov.get("n")
        ci = prov.get("ci95")
        resid = prov.get("residual")
        ts = prov.get("fitted_at_epoch_s")
        runs_cell = ",".join(str(r) for r in prov.get("runs") or [])
        if len(runs_cell) > 40:
            runs_cell = runs_cell[:37] + "..."
        cell = ""
        if key in stale:
            info = stale[key] if isinstance(stale, dict) else None
            cell = "STALE"
            if isinstance(info, dict) and info.get("mean_drift_pct"):
                cell += f" ({info['mean_drift_pct']:.0f}% drift)"
        rows.append([
            key,
            f"{profile.value(key):g}" if profile.is_set(key) else "unset",
            str(origin), str(n) if n else "-",
            (f"[{ci[0]:g}, {ci[1]:g}]"
             if isinstance(ci, (list, tuple)) and len(ci) == 2 else "-"),
            f"{resid:.3f}" if isinstance(resid, (int, float)) else "-",
            (f"{(now_s - ts) / 3600:.1f}"
             if isinstance(ts, (int, float)) else "-"),
            cell, runs_cell])
    widths = [max(len(header[i]), *(len(r[i]) for r in rows))
              for i in range(len(header))]

    def fmt(cells):
        return "| " + " | ".join(c.ljust(widths[i])
                                 for i, c in enumerate(cells)) + " |"

    lines = [f"profile {profile.name} (schema v{profile.schema_version}) "
             f"constants — provenance/staleness:",
             fmt(header),
             "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
    lines += [fmt(r) for r in rows]
    flagged = [k for k in sorted(profile.constants) if k in stale]
    if flagged:
        lines.append(f"stale: {', '.join(flagged)} — re-fit with "
                     f"tools_profile_fit.py refresh")
    return "\n".join(lines)


def sort_stage_units(elems: int) -> float:
    """U(M) = k(k+1)/2 for k = ceil(log2 M): the sort stage model's stage
    count."""
    if elems <= 1:
        return 1.0
    k = math.ceil(math.log2(elems))
    return k * (k + 1) / 2


def _device_label(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def calibrate(base: Optional[DeviceProfile] = None,
              name: Optional[str] = None,
              sort_elems: int = 1 << 21,
              device="cuda") -> DeviceProfile:
    """Measure the microbenchmark constants on ``device`` (the card unless
    the caller asks for the CPU); the others keep ``base``'s entries.

    Each measurement is warmed up once, then ten runs are timed between two
    CUDA events and divided; on the CPU, where every op is synchronous, the
    host clock brackets them.  Every source is tagged ``calibrate:<probe>``
    and names the device, so a calibrated constant is told apart from a fit
    or a committed one:

      * ``hbm_gbps``: one elementwise read-and-write pass (``x + 1``) over
        2**22 uint32 (16 MiB: the card's L2 holds it, so this is the
        envelope of a cache-resident pass);
      * ``sort_stage_unit_ms``: stable ``torch.sort`` of ``sort_elems``
        random keys through the stage model — the ``xla`` arm the unit
        prices (``impl=xla(torch.sort)`` in the tag);
      * ``dispatch_floor_ms``: a trivial op then a synchronize, 20 times;
      * ``hbm_bytes``: the card's total memory (``mem_get_info``); the
        host's physical memory on the CPU.
    """
    import torch

    from tpu_radix_join_torch.core.device import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    label = _device_label(dev)
    base = base or load_profile()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed_s(fn, iters=10) -> float:
        fn()
        sync()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    updates = {}
    n = 1 << 22
    x = torch.arange(n, dtype=torch.int32, device=dev)
    dt = timed_s(lambda: x + 1)
    updates["hbm_gbps"] = {
        "value": round(2 * 4 * n / dt / 1e9, 2),
        "source": f"calibrate:elementwise_pass on {label}"}
    gen = torch.Generator(device="cpu").manual_seed(0)
    keys = torch.randint(0, 1 << 31, (sort_elems,), dtype=torch.int64,
                         generator=gen).to(dev)
    dt = timed_s(lambda: torch.sort(keys, stable=True))
    unit = dt * 1e3 / (sort_elems / SORT_REF_ELEMS) / sort_stage_units(
        sort_elems)
    updates["sort_stage_unit_ms"] = {
        "value": round(unit, 5),
        "source": f"calibrate:flat_sort impl=xla(torch.sort) on {label}"}
    tiny = torch.zeros(8, dtype=torch.int32, device=dev)
    tiny + 1                      # first launch outside the loop
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        tiny + 1
        sync()
    updates["dispatch_floor_ms"] = {
        "value": round((time.perf_counter() - t0) / 20 * 1e3, 5),
        "source": f"calibrate:empty_dispatch on {label}"}
    if cuda:
        updates["hbm_bytes"] = {
            "value": int(torch.cuda.mem_get_info(dev)[1]),
            "source": f"calibrate:mem_get_info on {label}"}
    else:
        updates["hbm_bytes"] = {
            "value": os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"),
            "source": f"calibrate:phys_pages on {label}"}
    return base.replace_constants(
        name=name or f"{base.name}+calibrated", **updates)
