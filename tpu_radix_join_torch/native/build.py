"""Compile-on-first-use loader of the native host library.

The port's ``tpu_radix_join/native/build.py``: ``pool.cc`` (the bump
allocator behind ``memory/pool.py``) and ``datagen.cc`` (the multithreaded
relation generators behind ``Relation.fill_np``) compile once with ``g++
-O3 -std=c++17 -shared -fPIC -pthread`` into ``tpu_radix_join_torch/
_build/`` (listed in ``.gitignore``), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
A build writes a temporary file and renames it into place, so concurrent
processes never load a half-written library.

Unlike the JAX package, which falls back to numpy when the build fails,
:func:`load` raises with the compiler's message: a host with a CUDA
toolkit has ``g++`` (``nvcc`` needs it), and a quiet fallback would hide a
broken build behind a slower generator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = ("pool.cc", "datagen.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(sources: Sequence[Path] = (), flags=CXX_FLAGS) -> Path:
    """Where the library of ``sources`` (default: :data:`SOURCES`) built
    with ``flags`` lives: ``_build/libtrj_native_<hash>.so``."""
    srcs = list(sources) or [_DIR / s for s in SOURCES]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"libtrj_native_{h.hexdigest()[:16]}.so"


def compile_library(sources: Sequence[Path], out: Path,
                    flags=CXX_FLAGS) -> Path:
    """Build ``sources`` into ``out`` unless it exists; raises
    ``RuntimeError`` carrying the compiler's stderr when the build fails."""
    out = Path(out)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}."
                        f"{threading.get_ident()}")
    cmd = ["g++", *flags, "-o", str(tmp), *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build failed to run {cmd[0]}: {e!r}") \
            from e
    if proc.returncode != 0:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise RuntimeError(
            f"native build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures (the JAX package's ``_bind``, with
    ``pool_base``)."""
    u64, u32, i32 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int
    p_u32 = ctypes.POINTER(ctypes.c_uint32)
    lib.pool_create.restype = ctypes.c_void_p
    lib.pool_create.argtypes = [ctypes.c_size_t]
    lib.pool_get_memory.restype = ctypes.c_void_p
    lib.pool_get_memory.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.pool_reset.argtypes = [ctypes.c_void_p]
    lib.pool_used.restype = ctypes.c_size_t
    lib.pool_used.argtypes = [ctypes.c_void_p]
    lib.pool_base.restype = ctypes.c_void_p
    lib.pool_base.argtypes = [ctypes.c_void_p]
    lib.pool_capacity.restype = ctypes.c_size_t
    lib.pool_capacity.argtypes = [ctypes.c_void_p]
    lib.pool_destroy.argtypes = [ctypes.c_void_p]
    lib.fill_unique.argtypes = [p_u32, u64, u64, u64, u32, p_u32, i32]
    lib.fill_modulo.argtypes = [p_u32, u64, u64, u32, i32]
    lib.fill_zipf.argtypes = [p_u32, u64, u64, p_u32, u64, p_u32, u64,
                              u64, i32]
    lib.fill_rids.argtypes = [p_u32, u64, u64, i32]
    return lib


def load() -> ctypes.CDLL:
    """The native library, built at the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = [_DIR / s for s in SOURCES]
            path = library_path(srcs)
            try:
                lib = ctypes.CDLL(str(compile_library(srcs, path)))
            except OSError:
                # a library built on another host (a copied tree) that this
                # one cannot load: build it here
                path.unlink(missing_ok=True)
                lib = ctypes.CDLL(str(compile_library(srcs, path)))
            _lib = _bind(lib)
        return _lib


if __name__ == "__main__":
    print(load()._name)
