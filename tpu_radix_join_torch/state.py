"""Carrying a join's state from the JAX package into the port.

A join has no weights: its state is the configuration and the relations'
lanes.  :func:`from_jax_state` takes ``dataclasses.asdict`` of a JAX
``JoinConfig`` and the JAX lanes as numpy arrays, and returns the port's
``JoinConfig`` and ``TupleBatch`` — so the port can be held against the JAX
package on exactly the same inputs, without importing it.  A join
service's ``ServiceConfig`` carries across through
:func:`service_config_from_jax`.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np

from tpu_radix_join_torch.core.config import JoinConfig, ServiceConfig
from tpu_radix_join_torch.core.device import resolve_device
from tpu_radix_join_torch.data.tuples import TupleBatch, lane_from_numpy

#: JAX config fields the port's joins never read: the payload width, the
#: mesh axis's name and the result's aggregation rank
_UNREAD = frozenset({
    "payload_bits", "mesh_axis", "result_aggregation_node",
})


def config_from_jax(config_dict: Mapping) -> JoinConfig:
    """The port's JoinConfig for ``dataclasses.asdict(jax_config)``.

    ``sort_impl`` and ``partition_impl`` carry across as they are: "auto",
    "pallas" and "pallas_interpret" run the kernels, "xla" / "sort" the
    library baseline arms.  ``num_nodes``, ``num_hosts``, ``skew_threshold``, ``debug_checks``,
    ``chunk_size``, ``measure_phases``, ``match_rate_cap``, ``generation``,
    ``exchange_codec``, ``exchange_stages``, ``verify``, ``grid_pipeline``
    and the four retry-backoff fields carry across, as do the fanouts at
    every width; an unknown field raises ``ValueError``."""
    own = {f for f in JoinConfig.__dataclass_fields__}
    kw = {}
    for name, value in config_dict.items():
        if name in own:
            kw[name] = value
        elif name not in _UNREAD:
            raise ValueError(f"unknown JoinConfig field {name!r}")
    return JoinConfig(**kw)


def service_config_from_jax(config_dict: Mapping) -> ServiceConfig:
    """The port's ServiceConfig for ``dataclasses.asdict`` of a JAX
    ``ServiceConfig``: every field carries across; an unknown one raises
    ``ValueError``."""
    own = set(ServiceConfig.__dataclass_fields__)
    unknown = set(config_dict) - own
    if unknown:
        raise ValueError(f"unknown ServiceConfig fields {sorted(unknown)}")
    return ServiceConfig(**config_dict)


def batch_from_numpy(key: np.ndarray, rid: np.ndarray,
                     key_hi: Optional[np.ndarray] = None,
                     device="cuda") -> TupleBatch:
    """A TupleBatch on ``device`` from uint32 numpy lanes (bits kept);
    ``key_hi`` is the upper lane of 64-bit keys."""
    if np.shape(key) != np.shape(rid) or np.ndim(key) != 1:
        raise ValueError("key and rid must be 1-D lanes of one length")
    if key_hi is not None and np.shape(key_hi) != np.shape(key):
        raise ValueError("key_hi must be a lane of the key's length")
    dev = resolve_device(device)
    return TupleBatch(key=lane_from_numpy(key, dev),
                      rid=lane_from_numpy(rid, dev),
                      key_hi=None if key_hi is None
                      else lane_from_numpy(key_hi, dev))


def from_jax_state(config_dict: Mapping, key: np.ndarray, rid: np.ndarray,
                   key_hi: Optional[np.ndarray] = None,
                   device="cuda") -> Tuple[JoinConfig, TupleBatch]:
    """(port JoinConfig, port TupleBatch) for a JAX config dict and one
    relation's JAX lanes as numpy arrays."""
    return (config_from_jax(config_dict),
            batch_from_numpy(key, rid, key_hi, device=device))
