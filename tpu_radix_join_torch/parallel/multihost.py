"""Joining a ``torch.distributed`` process group: the ``MPI_Init`` analog.

Counterpart of ``tpu_radix_join/parallel/multihost.py:42-169``
(``initialize``, ``process_info``, ``CoordinatorTimeout``).  A distributed
join of the port is N processes, one GPU each, launched by ``torchrun`` (or
by hand with an explicit address, world size and rank); after
:func:`initialize` each passes ``torch.distributed.group.WORLD`` to
``HashJoin(config, group=...)``.

  * Opt-in: with no ``init_method`` argument and no torchrun environment
    (``MASTER_ADDR`` and ``MASTER_PORT``) it does nothing and returns
    False, so an entry point may call it unconditionally.  ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` fill what the arguments leave out.
  * The backend follows the device: NCCL for ``cuda`` (the default), after
    ``torch.cuda.set_device(local_rank)``; gloo for ``device="cpu"``.
    A CUDA device without NCCL raises; nothing switches to gloo.  Only a
    caller that names it, ``initialize(device="cuda", backend="gloo")``,
    starts a gloo group whose ranks hold CUDA tensors (gloo's CUDA
    collectives go through the host): several ranks on one card, as
    ``chip_smoke.py``'s phase (p) runs four.  :func:`gloo_on_card` tells the
    join engine that the group was started so.
  * The connect runs under a :class:`~..robustness.retry.RetryPolicy`: a
    rank that races ahead of a slow rendezvous backs off and retries, and
    one that never connects raises :class:`CoordinatorTimeout` (failure
    class ``coordinator_timeout``) after a bounded schedule.  Knobs:
    ``TPU_RJ_COORD_ATTEMPTS``, ``TPU_RJ_COORD_BACKOFF_S``,
    ``TPU_RJ_COORD_TIMEOUT_S``, or the arguments.
  * An elastic group (``elastic_lapse_s``, the lease's lapse window) bounds
    every collective by :func:`elastic_timeout_s`, the lapse window plus
    :data:`ELASTIC_MARGIN_S`, unless ``timeout_s`` or
    ``TPU_RJ_COORD_TIMEOUT_S`` sets the timeout: no survivor blocks on a
    dead or frozen peer longer than that.
    gloo then raises in the survivor (at once with a reset connection for a
    killed peer, at the timeout for a frozen one); over NCCL the
    environment asks for the same (``TORCH_NCCL_BLOCKING_WAIT=1``: a
    timed-out collective raises in the caller;
    ``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``: the watchdog aborts the
    communicators without killing the process).  The elastic path has
    never run over NCCL across cards.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_radix_join_torch.core.device import resolve_device
from tpu_radix_join_torch.parallel.world import clear_subgroups
from tpu_radix_join_torch.robustness import faults as _faults
from tpu_radix_join_torch.robustness.retry import (COORDINATOR_TIMEOUT,
                                                   RetriesExhausted,
                                                   RetryPolicy, execute)

#: seconds a connect attempt (and each collective of the group) may take
DEFAULT_TIMEOUT_S = 300.0

#: seconds past the lapse window an elastic group's collective may wait:
#: a healthy rank's longest phase between two collectives must fit in it
ELASTIC_MARGIN_S = 30.0

#: set by :func:`initialize` when it started a gloo group on a card
_GLOO_ON_CARD = False


class CoordinatorTimeout(ConnectionError):
    """Could not join the process group within policy.  ``attempts`` and
    ``backoff_s`` (seconds slept between attempts) carry the retry
    history."""

    failure_class = COORDINATOR_TIMEOUT

    def __init__(self, msg: str, attempts: int = 1, backoff_s: float = 0.0):
        super().__init__(msg)
        self.attempts = attempts
        self.backoff_s = backoff_s


def _default_policy(rank: int) -> RetryPolicy:
    env = os.environ
    return RetryPolicy(
        max_attempts=int(env.get("TPU_RJ_COORD_ATTEMPTS", "3")),
        base_delay_s=float(env.get("TPU_RJ_COORD_BACKOFF_S", "1.0")),
        multiplier=2.0, max_delay_s=30.0, jitter=0.1,
        # per-rank seed: ranks de-synchronise their retries
        seed=rank)


def elastic_timeout_s(lapse_window_s: float) -> float:
    """The default collective timeout of an elastic group: the lease's
    lapse window (``lease_s`` x ``missed_beats``) plus
    :data:`ELASTIC_MARGIN_S`."""
    return float(lapse_window_s) + ELASTIC_MARGIN_S


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               device="cuda",
               backend: Optional[str] = None,
               retry_policy: Optional[RetryPolicy] = None,
               timeout_s: Optional[float] = None,
               measurements=None,
               elastic_lapse_s: Optional[float] = None,
               _sleep: Optional[Callable[[float], None]] = None) -> bool:
    """Join the process group if one is configured; True when the world
    has more than one rank.

    ``init_method`` is a ``torch.distributed`` URL (``tcp://host:port``,
    ``file://path``); without it, torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT`` select ``env://``.  ``timeout_s`` bounds each connect
    attempt and every collective of the group (default
    ``TPU_RJ_COORD_TIMEOUT_S``, else 300, else on an elastic group
    :func:`elastic_timeout_s`).  ``backend`` is None (the
    device's: NCCL or gloo), or "gloo" with a CUDA device for a gloo group
    of CUDA tensors.  ``elastic_lapse_s`` (the membership lease's lapse
    window) makes the group elastic: an NCCL group then raises a timed-out
    collective instead of aborting the process.  A second call after a
    successful one returns at once."""
    global _GLOO_ON_CARD
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            return False   # one process: nothing to join
        init_method = "env://"
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or rank is None:
        raise ValueError("initialize needs the world size and this "
                         "process's rank (arguments, or WORLD_SIZE and RANK)")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK") or 0
    dev = resolve_device(device)
    if dev.type == "cuda":
        if backend != "gloo" and not dist.is_nccl_available():
            raise RuntimeError(
                "NCCL is not available in this torch build; the port runs "
                "its collectives on the card through NCCL and never falls "
                "back to gloo (pass device='cpu' for a host run on gloo, or "
                "backend='gloo' to ask for gloo on the card)")
        torch.cuda.set_device(local_rank)
        backend = backend or "nccl"
    elif backend == "nccl":
        raise ValueError("NCCL runs on CUDA devices, not on the CPU")
    else:
        backend = "gloo"
    if timeout_s is None and "TPU_RJ_COORD_TIMEOUT_S" in env:
        timeout_s = float(env["TPU_RJ_COORD_TIMEOUT_S"])
    if timeout_s is None:
        timeout_s = (DEFAULT_TIMEOUT_S if elastic_lapse_s is None
                     else elastic_timeout_s(elastic_lapse_s))
    if elastic_lapse_s is not None and backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")

    def connect():
        _faults.check(_faults.COORD_CONNECT, measurements)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))

    policy = retry_policy or _default_policy(rank)
    try:
        execute(connect, policy,
                retryable=(ConnectionError, TimeoutError,
                           dist.DistNetworkError, dist.DistStoreError,
                           _faults.InjectedFault),
                sleep=_sleep or time.sleep, measurements=measurements,
                label="coordinator_connect")
    except RetriesExhausted as e:
        backoff_s = sum(policy.schedule()[:max(0, e.attempts - 1)])
        raise CoordinatorTimeout(
            f"could not join the {backend} process group at {init_method} "
            f"(rank {rank} of {world_size}) after {e.attempts} attempt(s) "
            f"({backoff_s:.1f}s of backoff): {e.last_error!r}",
            attempts=e.attempts, backoff_s=backoff_s) from e
    _GLOO_ON_CARD = dev.type == "cuda" and backend == "gloo"
    return world_size > 1


def gloo_on_card() -> bool:
    """True when :func:`initialize` started this process's group as gloo on
    a CUDA device (``backend="gloo"``)."""
    return _GLOO_ON_CARD and dist.is_initialized()


def process_info() -> Tuple[int, int]:
    """(rank, world size), the ``Comm_rank``/``Comm_size`` pair; (0, 1)
    without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    global _GLOO_ON_CARD
    _GLOO_ON_CARD = False
    clear_subgroups()
    if dist.is_initialized():
        dist.destroy_process_group()
