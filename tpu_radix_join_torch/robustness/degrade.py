"""Graceful degradation: build the engine somewhere, even when the card
is gone.

The port's ``tpu_radix_join/robustness/degrade.py``:

  * :func:`build_cpu_engine` (``:29-52``): a ``HashJoin`` on the host CPUs
    (every kernel then takes its plain PyTorch version), with
    ``num_hosts`` collapsed to 1.  The join service's circuit breaker
    serves from it after it has tripped on classified backend failures,
    counts every query it serves (QDEGRADED, a ``degrade`` event) and
    stamps their outcomes ``engine="cpu_fallback", degraded=True``
    (service/session.py).  Over several ranks it joins over a gloo
    process group of its own (``host_group``), since the primary's NCCL
    group cannot carry CPU tensors.
  * :func:`engine_with_cpu_fallback` (``:55-89``), opt-in
    (``--cpu-fallback``): when constructing the engine on the card fails
    (no card, a process group of the wrong backend or size, the
    ``engine.device_init`` fault site), it builds the CPU engine instead
    and says so three ways: a ``RuntimeWarning``, a ``degrade`` event and
    ``info["degraded"]`` with ``failure_class="device_unavailable"``.
    Only construction is wrapped: kernels build and launch at first use,
    inside the join, and a failure there still raises.

Kept out of ``robustness/__init__``: it imports the engine.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

from tpu_radix_join_torch.robustness.retry import DEVICE_UNAVAILABLE


def build_cpu_engine(config, measurements=None, plan_cache=None,
                     host_group=None) -> Tuple[object, dict]:
    """(engine, info): a ``HashJoin`` on ``device="cpu"`` over
    ``host_group`` (a gloo process group of ``config.num_nodes`` ranks;
    None at one rank), with ``num_hosts=1``.  ``info`` carries
    ``backend="cpu"`` and ``num_nodes``."""
    from tpu_radix_join_torch.operators.hash_join import HashJoin

    cfg = dataclasses.replace(config, num_hosts=1)
    engine = HashJoin(cfg, device="cpu", group=host_group,
                      measurements=measurements, plan_cache=plan_cache)
    return engine, {"backend": "cpu", "num_nodes": cfg.num_nodes}


def engine_with_cpu_fallback(config, device="cuda", group=None,
                             measurements=None, plan_cache=None
                             ) -> Tuple[object, dict]:
    """(engine, info): a ``HashJoin`` on ``device`` over ``group``, or,
    when that construction raises, :func:`build_cpu_engine`'s engine at
    one rank (a degraded run is local: the primary's process group is
    what may have failed).  ``info["degraded"]`` is False on the primary
    path (``backend`` is the device type); on the fallback it is True and
    ``info`` carries ``failure_class``, ``error`` (the primary failure's
    repr), ``backend="cpu"`` and ``num_nodes``.  A failure of the CPU
    construction propagates: there is nothing left to degrade to."""
    from tpu_radix_join_torch.operators.hash_join import HashJoin

    try:
        engine = HashJoin(config, device=device, group=group,
                          measurements=measurements, plan_cache=plan_cache)
        return engine, {"degraded": False, "backend": engine.device.type}
    except Exception as e:   # noqa: BLE001 — any construction failure
        primary_error = e
    engine, cpu_info = build_cpu_engine(
        dataclasses.replace(config, num_nodes=1, num_hosts=1),
        measurements=measurements,
        plan_cache=plan_cache)
    n = cpu_info["num_nodes"]
    info = {"degraded": True, "backend": "cpu",
            "failure_class": DEVICE_UNAVAILABLE, "num_nodes": n,
            "error": repr(primary_error)}
    warnings.warn(
        f"[DEGRADE] device init failed ({primary_error!r}); running on "
        f"the host CPU ({n} node) — expect reduced throughput",
        RuntimeWarning, stacklevel=2)
    if measurements is not None:
        measurements.event("degrade", to="cpu", num_nodes=n,
                           error=repr(primary_error))
    return engine, info
