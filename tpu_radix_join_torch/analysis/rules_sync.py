"""Rule ``sync-point``: no implicit host syncs in the engine hot paths.

Counterpart of ``tpu_radix_join/analysis/rules_sync.py`` with PyTorch's
spellings.  Every ``.item()``, ``int(tensor)``, ``.cpu()`` or bare
``.synchronize()`` stalls the host until the card drains its queue, and
the implicit spellings are invisible at review: an accidental one reads
exactly like a load-bearing one.  The sanctioned spellings are
``utils.hostsync.host_readback`` (and ``host_upload``, ``host_fence``,
``stream_fence``), which pause the runtime guard for their own copy, so
this static rule and ``sync_guard`` (``main.py --transfer-guard``)
witness each other: code the rule passes runs clean under the guard, and
a guard trip points at a spelling the rule missed.

Checks:

  * ``.item()`` — flagged everywhere in the package;
  * ``int(...)`` / ``float(...)`` / ``bool(...)`` of a tensor expression
    — flagged everywhere in the package.  A tensor expression is, as far
    as one function's text shows: a call rooted at ``torch`` (not
    ``torch.cuda`` or ``torch.distributed``), a call of a tensor helper
    (:data:`TENSOR_HELPERS`, or a function of the same module annotated
    ``-> torch.Tensor``), a collective (``.all_reduce(...)``,
    ``.all_gather(...)``), a method, subscript, comparison or arithmetic
    on one, or a local name whose latest assignment above the use is one —
    unless it is built from host values alone (a constructor without
    ``device=`` of literals or constants).  What the text does not show
    (a name bound by an unannotated call) the runtime guard witnesses;
  * in the **hot files** (:data:`HOT_FILES`, the modules that drive device
    programs mid-join): ``.cpu()``, ``.tolist()``, ``.numpy()`` and a bare
    ``.synchronize()`` (any receiver: a stream, an event,
    ``torch.cuda``), except on a value already on the host
    (``host_readback(x).tolist()``).

``utils/hostsync.py`` is exempt: it is the implementation.  A deliberate
implicit sync can carry ``# lint: sync-ok(<reason>)``, but the hostsync
helpers are the preferred fix.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from tpu_radix_join_torch.analysis.core import (Finding, Repo, dotted_name,
                                                rule)

#: modules that drive device programs mid-join: every readback here is a
#: stall of the card's queue until proven otherwise
HOT_FILES = {
    "tpu_radix_join_torch/operators/hash_join.py",
    "tpu_radix_join_torch/ops/chunked.py",
    "tpu_radix_join_torch/service/session.py",
    "tpu_radix_join_torch/parallel/window.py",
    "tpu_radix_join_torch/robustness/recovery.py",
}
#: the sanctioned helpers' home
EXEMPT_FILES = {"tpu_radix_join_torch/utils/hostsync.py"}

SCALAR_CASTS = {"int", "float", "bool"}
#: method calls that read a tensor back in the hot files
HOT_METHODS = {"cpu", "tolist", "numpy", "synchronize"}
#: ``torch.*`` namespaces that return host values, not tensors
HOST_TORCH = ("torch.cuda", "torch.distributed", "torch.device",
              "torch.iinfo", "torch.finfo", "torch.get_", "torch.is_")
#: the port's functions that return a device tensor of their input's
TENSOR_HELPERS = {"umax", "widen", "narrow", "local_histogram",
                  "merge_count_presorted", "merge_count_chunks",
                  "histogram"}
#: collectives of ``parallel/world.DistWorld``: they return tensors
COLLECTIVES = {"all_reduce", "all_gather"}


#: ``torch.*`` constructors: a host tensor unless given a ``device=``
CONSTRUCTORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy",
                "torch.zeros", "torch.ones", "torch.full", "torch.empty",
                "torch.arange"}
#: receivers of a hot method that hold host values already
HOST_RECEIVERS = {"host_readback", "lane_to_numpy", "np", "numpy"}


def _torch_call(name: Optional[str]) -> bool:
    return (name is not None and name.split(".")[0] == "torch"
            and not name.startswith(HOST_TORCH))


def _host(node: ast.AST, helpers=TENSOR_HELPERS) -> bool:
    """A value that never lives on the card: a literal, a constructor
    without ``device=``, or a tensor function of such values alone
    (``int(narrow(torch.tensor(PAD_RID)))`` is a host scalar)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name) and node.id.isupper():
        return True
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name in CONSTRUCTORS:
        return all(kw.arg != "device" for kw in node.keywords)
    if (name in helpers or _torch_call(name)) and node.args:
        return (all(_host(a, helpers) for a in node.args)
                and all(kw.arg == "dtype" for kw in node.keywords))
    return False


def _host_receiver(node: ast.Call) -> bool:
    """``host_readback(x).tolist()``, ``np.asarray(x).tolist()``: the
    method of a value already on the host."""
    recv = node.func.value
    while isinstance(recv, (ast.Call, ast.Attribute, ast.Subscript)):
        if isinstance(recv, ast.Call):
            name = dotted_name(recv.func) or ""
            if name.split(".")[0] in HOST_RECEIVERS or name.split(
                    ".")[-1] in HOST_RECEIVERS:
                return True
            recv = recv.func
        else:
            recv = recv.value
    return isinstance(recv, ast.Name) and recv.id in HOST_RECEIVERS


def _tensor_functions(tree: ast.Module) -> set:
    """Names of the module's functions annotated ``-> torch.Tensor``."""
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.returns is not None
            and dotted_name(n.returns) == "torch.Tensor"}


class _Tensors:
    """The tensor-expression test of one function (or module) body."""

    def __init__(self, body: ast.AST, helpers=frozenset()):
        self.helpers = TENSOR_HELPERS | set(helpers)
        #: name -> [(line, assigned value)] of its assignments
        self.assigned: Dict[str, List[Tuple[int, ast.AST]]] = {}
        for node in ast.walk(body):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                if node.value is None:
                    continue
                targets, value = [node.target], node.value
            else:
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    self.assigned.setdefault(tgt.id, []).append(
                        (node.lineno, value))

    def _name(self, name: str, line: int, depth: int) -> bool:
        hits = [(ln, v) for ln, v in self.assigned.get(name, ()) if ln < line]
        if not hits:
            return False
        _, value = max(hits, key=lambda h: h[0])
        return self.is_tensor(value, depth + 1)

    def is_tensor(self, node: ast.AST, depth: int = 0) -> bool:
        if depth > 8:
            return False
        if isinstance(node, ast.Call):
            if _host(node, self.helpers):
                return False
            name = dotted_name(node.func)
            if _torch_call(name):
                return True
            if isinstance(node.func, ast.Name):
                return node.func.id in self.helpers
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in COLLECTIVES:
                    return True
                if node.func.attr in HOT_METHODS | {"item"}:
                    return False
                return self.is_tensor(node.func.value, depth + 1)
            return False
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value, depth + 1)
        if isinstance(node, ast.BinOp):
            return (self.is_tensor(node.left, depth + 1)
                    or self.is_tensor(node.right, depth + 1))
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand, depth + 1)
        if isinstance(node, ast.Compare):
            return any(self.is_tensor(v, depth + 1)
                       for v in [node.left, *node.comparators])
        if isinstance(node, ast.Name):
            return self._name(node.id, getattr(node, "lineno", 0), depth)
        return False


def _scopes(tree: ast.Module):
    """Each function body with its own assignments; the module's top level
    as one more scope (its function bodies are scanned on their own)."""
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda))]
    yield tree, funcs
    for f in funcs:
        yield f, [n for n in ast.walk(f) if n is not f and isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))]


def _own_nodes(scope: ast.AST, inner):
    """The nodes of ``scope`` outside its nested functions."""
    skip = {id(n) for f in inner for n in ast.walk(f)}
    return [n for n in ast.walk(scope) if id(n) not in skip]


def _message(key: str) -> str:
    return (f"{key} is an implicit blocking device→host sync — use "
            f"utils.hostsync.host_readback / host_fence (guard-clean) or "
            f"annotate sync-ok with a reason")


@rule("sync-point",
      "implicit host syncs (.item(), int(tensor), .cpu()/.tolist()/"
      ".numpy()/.synchronize() in hot files) must go through "
      "utils.hostsync",
      token="sync")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for src in repo.files:
        if src.rel in EXEMPT_FILES:
            continue
        hot = src.rel in HOT_FILES
        seen = set()
        helpers = _tensor_functions(src.tree)
        for scope, inner in _scopes(src.tree):
            tensors = _Tensors(scope, helpers)
            for node in _own_nodes(scope, inner):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                key = None
                if isinstance(node.func, ast.Attribute):
                    attr = node.func.attr
                    if attr == "item" and not node.args:
                        key = ".item()"
                    elif (hot and attr in HOT_METHODS
                          and not _host_receiver(node)):
                        key = f".{attr}()"
                fname = dotted_name(node.func)
                if (key is None and fname in SCALAR_CASTS
                        and len(node.args) == 1
                        and tensors.is_tensor(node.args[0])):
                    key = f"{fname}(tensor)"
                if key is not None:
                    out.append(Finding(rule="sync-point", path=src.rel,
                                       line=node.lineno, key=key,
                                       message=_message(key)))
    return out
