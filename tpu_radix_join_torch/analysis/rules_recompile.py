"""Rule ``recompile-hazard``: compiles and builds that churn.

Counterpart of ``tpu_radix_join/analysis/rules_recompile.py`` where the
hazard has a PyTorch meaning.  The port compiles nothing per shape: its
kernels are CUDA sources built once a process by ``nvcc``
(``ops/kernels/_build.py``) and its native runtime once by ``g++``
(``native/build.py``), each library named by a hash of its sources and
flags.  Two hazards stay statically visible:

  * **compile in a loop** — ``torch.compile`` / ``torch.jit.script`` /
    ``torch.jit.trace`` called inside a ``for`` / ``while`` body builds a
    fresh compiled callable (and cache entry) every iteration.  Hoist it
    or cache the compiled callable.
  * **f-string build keys** — an ``ast.JoinedStr`` in the library-naming
    argument (the first, or ``name=`` / ``names=``) of a kernel or native
    build entry (:data:`BUILD_CALLS`: ``build``, ``library``,
    ``library_path``, ``c_function``, ``compile_library``) bakes runtime
    values into the library's name: one ``nvcc`` or ``g++``
    run per distinct value, unbounded.  A build is keyed by its sources'
    hash, never by the values it will be called with.

Not applicable, and not ported: JAX's dynamic ``static_argnums`` /
``static_argnames`` check (the port has no ``jax.jit``, and its kernels
take every shape as a runtime argument) and the engine's
``_compile_timed`` key tuples (the port has no compiled-program cache).
Deliberate sites carry ``# lint: recompile-ok(<reason>)``.
"""

from __future__ import annotations

import ast
from typing import List

from tpu_radix_join_torch.analysis.core import Finding, Repo, dotted_name, rule

COMPILE_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}
#: the kernel and native build entries whose arguments name a library
BUILD_CALLS = {"build", "library", "library_path", "c_function",
               "compile_library"}


def _contains_fstring(node: ast.AST) -> bool:
    return any(isinstance(n, ast.JoinedStr) for n in ast.walk(node))


@rule("recompile-hazard",
      "torch.compile/jit in a loop and f-string kernel build keys cause "
      "silent recompile churn",
      token="recompile")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for src in repo.files:
        loop_compiles = set()
        for loop in ast.walk(src.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if (isinstance(node, ast.Call)
                        and dotted_name(node.func) in COMPILE_CALLS
                        and node.lineno not in loop_compiles):
                    loop_compiles.add(node.lineno)
                    out.append(Finding(
                        rule="recompile-hazard", path=src.rel,
                        line=node.lineno, key="compile-in-loop",
                        message=(f"{dotted_name(node.func)} inside a loop "
                                 f"body recompiles every iteration — hoist "
                                 f"it out of the loop or cache the "
                                 f"compiled callable")))
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = (dotted_name(node.func) or "").split(".")[-1]
            if name not in BUILD_CALLS:
                continue
            named = node.args[:1] + [kw.value for kw in node.keywords
                                     if kw.arg in ("name", "names")]
            if any(_contains_fstring(a) for a in named):
                out.append(Finding(
                    rule="recompile-hazard", path=src.rel,
                    line=node.lineno, key="fstring-build-key",
                    message=("f-string among a kernel build's arguments "
                             "keys the library by runtime values — key "
                             "it by its sources' hash")))
    return out
