"""PID-stamped coordination files for a shared card.

The grid's side of ``tpu_radix_join/utils/locks.py`` (``:22-51``,
``:125-143``), with the same paths, so a benchmark of the JAX package and a
grid of either package see each other; the benchmark's side
(``acquire_pid_file``) comes with the port's benchmark, ROADMAP A8b.  The
benchmark holds a pause file while its timed window runs and the grid
parks between chunk pairs; the grid holds a presence file (and
``<presence>.parked`` while it parks).  Both files carry the owner's PID,
so a holder killed hard never wedges the other side.
"""

from __future__ import annotations

import os
from typing import Optional

_ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts")


def bench_pause_file() -> str:
    """The benchmark's hold file (``TPU_RJ_PAUSE_FILE`` overrides it)."""
    return os.environ.get("TPU_RJ_PAUSE_FILE",
                          os.path.join(_ARTIFACTS, "BENCH_RUNNING"))


def grid_presence_file() -> str:
    """The grid's presence file (``TPU_RJ_GRID_FILE`` overrides it)."""
    return os.environ.get("TPU_RJ_GRID_FILE",
                          os.path.join(_ARTIFACTS, "GRID_RUNNING"))


def write_pid_file(path: str) -> bool:
    """Stamp ``path`` with this process's PID; False if unwritable."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(str(os.getpid()))
        return True
    except OSError:
        return False


def remove_pid_file(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def pid_file_alive(path: str) -> Optional[bool]:
    """Whether the process that stamped ``path`` lives: True/False for a
    checkable PID, None for a missing, unreadable or PID-less file.  A PID
    of another user counts as alive."""
    try:
        with open(path) as f:
            pid = int(f.read().strip() or "0")
    except (OSError, ValueError):
        return None
    if pid <= 0:
        return None
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
