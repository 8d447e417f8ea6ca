"""The degraded CPU engine the join service's circuit breaker serves from.

The port's ``build_cpu_engine`` of ``tpu_radix_join/robustness/
degrade.py:40-89``: a ``HashJoin`` on the host CPUs (every kernel then
takes its plain PyTorch version), with ``num_hosts`` collapsed to 1.  The
session builds it only after its breaker has tripped on classified
backend failures, counts every query it serves (QDEGRADED, a ``degrade``
event) and stamps their outcomes ``engine="cpu_fallback",
degraded=True`` (service/session.py): an explicit, counted mode, never a
silent fallback.  Over several ranks it joins over a gloo process group
of its own (``host_group``), since the primary's NCCL group cannot carry
CPU tensors.  Construction-time fallback (``engine_with_cpu_fallback``,
``--cpu-fallback`` and the ``engine.device_init`` fault site) is ROADMAP
A18.

Kept out of ``robustness/__init__``: it imports the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


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
