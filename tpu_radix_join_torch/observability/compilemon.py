"""Compile telemetry: first-use kernel builds -> NCOMPILE / COMPILEMS.

The counterpart of ``tpu_radix_join/observability/compilemon.py``, which
hears every XLA backend compile through ``jax.monitoring``.  The port has
no runtime compiler in its join: its compiles are the first-use builds and
loads of the hand-written CUDA kernels (ops/kernels/_build.py: ``nvcc`` for
a source whose library is not built yet, then ``ctypes`` loading it).
``_build.library`` reports each one to its build hooks; this monitor
installs one hook and mirrors every report into the installed registries:

  * ``NCOMPILE`` — one count is one CUDA source's library built (or found
    built on disk) and loaded into this process, the first time a wrapper
    calls one of its kernels.  A process counts each source at most once,
    so a warm session reads a flat NCOMPILE;
  * ``COMPILEMS`` — the build and load's wall milliseconds, summed.

JCOMPILE, the engine's bracket around the same builds, keeps timing them
inside a join; these counters hear the builds wherever they happen (a
service's fast paths, a grid).  A serving session reads the per-query
NCOMPILE delta as its recompile-storm canary (service/session.py).
"""

from __future__ import annotations

from typing import List

from tpu_radix_join_torch.performance.measurements import COMPILEMS, NCOMPILE

_active: List[object] = []      # installed Measurements registries


def _on_build(name: str, seconds: float) -> None:
    ms = max(0, int(round(seconds * 1e3)))
    for m in list(_active):
        try:
            m.incr(NCOMPILE)
            m.incr(COMPILEMS, by=ms)
        except Exception:   # noqa: BLE001 — telemetry must not fail a build
            pass


def install_compile_monitor(measurements):
    """Start mirroring first-use kernel builds into ``measurements``'
    NCOMPILE / COMPILEMS counters.  Idempotent per registry; returns the
    registry.  The build hook is installed with the first registry and
    removed with the last."""
    from tpu_radix_join_torch.ops.kernels import _build
    if not _active:
        _build.add_build_hook(_on_build)
    if measurements not in _active:
        _active.append(measurements)
    return measurements


def uninstall_compile_monitor(measurements) -> None:
    """Stop mirroring into ``measurements``."""
    from tpu_radix_join_torch.ops.kernels import _build
    if measurements in _active:
        _active.remove(measurements)
        if not _active:
            _build.remove_build_hook(_on_build)
