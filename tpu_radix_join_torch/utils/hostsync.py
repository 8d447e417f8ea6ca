"""Explicit device↔host copies and fences: the sanctioned sync points.

Counterpart of ``tpu_radix_join/utils/hostsync.py``.  The engine's hot
paths must not hold an *implicit* host sync — ``.item()``, ``int(t)``,
``.cpu()``, ``.tolist()``, a bare ``.synchronize()`` — because each one
stalls the host until the card drains its queue, and an accidental one
reads exactly like a deliberate one.  Two witnesses police this:

  * statically, the ``sync-point`` lint rule (``analysis/rules_sync.py``)
    flags the implicit spellings in the port's hot files;
  * at run time, :func:`sync_guard` (``main.py --transfer-guard``) arms
    ``torch.cuda.set_sync_debug_mode``: ``"log"`` warns and ``"disallow"``
    raises on every synchronizing CUDA call of the process.

:func:`host_readback`, :func:`host_upload` and :func:`host_fence` are the
escape hatches both accept: each pauses the guard for its own copy or
fence only, so every surviving sync point is a visible, greppable
decision.  ``host_readback`` has the semantics of ``np.asarray`` over
tensors, numpy arrays, scalars and lists of them; a uint32 lane stays
its int32 bit pattern (callers keep their ``.view(np.uint32)``).

**The mode is process-global.**  c10 keeps one sync debug mode for the
whole process, not one a thread.  A pause therefore disarms the guard on
every thread for the length of one copy: while the engine's thread reads
back its counts, a sync made at that instant by another thread (the grid's
prefetcher, the host stream's fill thread, the metrics sampler, the
watchdog) goes unreported.  The lock and the depth count below make sure
that no interleaving of pauses and guards, nested or on other threads,
leaves the mode disarmed once the last pause has ended and a guard is
still open, or armed once the last guard has closed.

What the mode sees is c10's: ``Stream.synchronize`` and the synchronizing
copies (``.item()``, ``int()`` / ``bool()`` of a CUDA tensor, a blocking
``.cpu()`` / ``.tolist()``, ``torch.tensor(..., device=cuda)`` and
``.to(cuda)`` from pageable memory), ``nonzero``, ``masked_select``,
boolean indexing, ``unique``, ``bincount`` and ``repeat_interleave``
without ``output_size``.  On an H100 with torch 2.11 it did not see
``torch.cuda.synchronize`` or ``Event.synchronize``, and PyTorch documents
that ``torch.distributed`` collectives are not covered; ``host_fence``
pauses it all the same, so a later PyTorch that reports device-wide
fences finds them sanctioned.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

#: ``--transfer-guard`` modes -> ``torch.cuda.set_sync_debug_mode`` values
GUARD_MODES = {"log": "warn", "disallow": "error"}

_LOCK = threading.Lock()
_ARMED: list = []        # the modes of the open guards, innermost last
_BASE = [0]              # the mode found when the outermost guard opened
_PAUSES = [0]            # sanctioned copies in flight, on any thread


def _apply() -> None:
    """Set the process's mode from the state (under ``_LOCK``)."""
    if not _ARMED:
        mode = _BASE[0]
    elif _PAUSES[0]:
        mode = 0
    else:
        mode = _ARMED[-1]
    torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def sync_guard(mode: str = "off"):
    """Arm the sync guard for the block: ``off`` does nothing, ``log``
    warns and ``disallow`` raises on every implicit sync of the process.
    The mode found on entry is restored on exit, also on an exception."""
    if mode == "off":
        yield
        return
    if mode not in GUARD_MODES:
        raise ValueError(f"sync_guard mode must be off, log or disallow, "
                         f"got {mode!r}")
    with _LOCK:
        if not _ARMED:
            _BASE[0] = torch.cuda.get_sync_debug_mode()
        _ARMED.append(GUARD_MODES[mode])
        try:
            _apply()
        except BaseException:
            _ARMED.pop()
            raise
    try:
        yield
    finally:
        with _LOCK:
            _ARMED.pop()
            _apply()


@contextlib.contextmanager
def _paused():
    """The guard disarmed for one sanctioned copy or fence; nothing is
    touched when no guard is open (so the CPU never reaches c10's mode)."""
    with _LOCK:
        _PAUSES[0] += 1
        if _ARMED and _PAUSES[0] == 1:
            _apply()
    try:
        yield
    finally:
        with _LOCK:
            _PAUSES[0] -= 1
            if _ARMED and _PAUSES[0] == 0:
                _apply()


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return [_to_numpy(v) for v in x]
    return x


def host_readback(x) -> np.ndarray:
    """Blocking device→host copy as a numpy array (a sanctioned sync)."""
    if isinstance(x, np.ndarray):
        return x
    with _paused():
        return np.asarray(_to_numpy(x))


def host_upload(a, device, dtype=None) -> torch.Tensor:
    """Blocking host→device copy of ``a`` (a numpy array, a list or a
    scalar) as a tensor on ``device`` (a sanctioned sync)."""
    with _paused():
        return torch.as_tensor(a, dtype=dtype, device=device)


def host_fence(device=None) -> None:
    """Wait until the card has run everything queued on ``device`` (a
    sanctioned sync; nothing on the CPU)."""
    if device is not None and torch.device(device).type != "cuda":
        return
    with _paused():
        torch.cuda.synchronize(device)


def stream_fence(stream) -> None:
    """Wait for one CUDA stream or event (a sanctioned sync)."""
    with _paused():
        stream.synchronize()
