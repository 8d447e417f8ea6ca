"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Libraries land in
``tpu_radix_join_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  Nothing here runs at import: the first wrapper call on a
CUDA tensor builds its library, and :func:`build` builds them all at once,
one ``nvcc`` process per source started together.  A first-use build and
load is timed and reported to the hooks installed with :func:`on_build`
(the join engine's records it as JCOMPILE, kept out of its phase timers)
or :func:`add_build_hook` (observability/compilemon.py's NCOMPILE and
COMPILEMS).

    python -m tpu_radix_join_torch.ops.kernels._build   # build all, print ptxas -v
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("histogram", "radix_sort", "merge_scan", "partition",
           "merge_scan_wide", "merge_scan_chunks", "partition_wide",
           "partition_msd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
#: callables ``hook(name, seconds)`` told of each first-use build and load
_hooks: List[Callable[[str, float], None]] = []


def add_build_hook(hook: Callable[[str, float], None]) -> None:
    """Call ``hook(name, seconds)`` after each library's first-use build
    and load (:func:`library`) until :func:`remove_build_hook`; a build
    that fails raises and calls no hook."""
    _hooks.append(hook)


def remove_build_hook(hook: Callable[[str, float], None]) -> None:
    _hooks.remove(hook)


@contextlib.contextmanager
def on_build(hook: Callable[[str, float], None]):
    """:func:`add_build_hook` for the block."""
    add_build_hook(hook)
    try:
        yield hook
    finally:
        remove_build_hook(hook)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of tpu_radix_join_torch cannot be built")


def _flags(ptxas_verbose: bool) -> Sequence[str]:
    return NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_verbose else ())


def library_path(name: str, ptxas_verbose: bool = False) -> Path:
    """Where ``name``'s library lives for the current sources and flags."""
    h = hashlib.sha256()
    h.update(" ".join(_flags(ptxas_verbose)).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the compiler's
    diagnostics per source (empty for a library that was already built);
    raises ``RuntimeError`` with them when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name, ptxas_verbose)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.tmp.{os.getpid()}")
        cmd = [nvcc_path(), *_flags(ptxas_verbose), "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for "
                           + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        t0 = time.perf_counter()
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
        seconds = time.perf_counter() - t0
        for hook in list(_hooks):
            hook(name, seconds)
    return lib


def c_function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """``symbol`` of library ``name`` with its C signature declared."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


if __name__ == "__main__":
    for src, log in build(ptxas_verbose=True).items():
        print(f"== {src}\n{log}", file=sys.stderr)
