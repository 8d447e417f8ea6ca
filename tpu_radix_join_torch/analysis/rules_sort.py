"""Rule ``sort-bypass``: hot sorts must route through the sort switch.

Counterpart of ``tpu_radix_join/analysis/rules_sort.py`` with PyTorch's
spellings.  Every hot reorder of the port goes through ``ops/sorting.py``
(``sort_unstable`` / ``sort_kv_unstable`` / ``sort_lex_unstable``), where
the engine's ``sort_impl`` picks K2 or the counted library arm and SORTPASS
ticks.  A direct ``torch.sort`` / ``torch.argsort`` / ``torch.msort`` (or
the ``.sort()`` / ``.argsort()`` / ``.msort()`` method of a tensor)
anywhere else silently bypasses the switch: the site never runs K2, never
ticks SORTPASS, and the planner's sort prediction stops matching what runs.

Not flagged: host ``np.sort`` / ``np.argsort``, ``sorted()`` and
``list.sort()`` (a ``.sort()`` with no argument but ``key=`` / ``reverse=``
on a name that holds no tensor is taken for a list), the sort switch's own
module and the kernels' plain versions under ``ops/kernels/``.
"""

from __future__ import annotations

import ast
from typing import List

from tpu_radix_join_torch.analysis.core import Finding, Repo, dotted_name, rule

ALLOWED_FILES = ("tpu_radix_join_torch/ops/sorting.py",)
ALLOWED_PREFIXES = ("tpu_radix_join_torch/ops/kernels/",)

#: dotted call spellings that bypass the switch
SORT_CALLS = {"torch.sort", "torch.argsort", "torch.msort"}
#: tensor methods that sort
SORT_METHODS = {"sort", "argsort", "msort"}
#: method receivers rooted here are host arrays (never flagged)
HOST_ROOTS = {"np", "numpy", "sorted", "list"}
#: keywords of ``list.sort`` alone
LIST_SORT_KWARGS = {"key", "reverse"}


def _receiver_root(node: ast.Call) -> str:
    recv = node.func.value
    while isinstance(recv, (ast.Call, ast.Subscript, ast.Attribute)):
        if isinstance(recv, ast.Call):
            recv = recv.func
        else:
            recv = recv.value
    return recv.id if isinstance(recv, ast.Name) else ""


def _list_sort(node: ast.Call, tensor_names) -> bool:
    """``x.sort()`` / ``x.sort(key=..., reverse=...)`` on a name that no
    ``torch.*`` call assigned: Python's ``list.sort``."""
    if node.func.attr != "sort" or node.args:
        return False
    if any(kw.arg not in LIST_SORT_KWARGS for kw in node.keywords):
        return False
    recv = node.func.value
    return not (isinstance(recv, ast.Name) and recv.id in tensor_names)


def _tensor_names(tree: ast.Module) -> set:
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and (dotted_name(node.value.func) or "").startswith(
                    "torch.")):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


@rule("sort-bypass",
      "direct torch.sort/argsort/msort outside ops/sorting.py bypasses "
      "the sort switch (K2, SORTPASS)",
      token="sort")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for src in repo.files:
        if (src.rel in ALLOWED_FILES
                or src.rel.startswith(ALLOWED_PREFIXES)):
            continue
        tensors = _tensor_names(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in SORT_CALLS:
                out.append(Finding(
                    rule="sort-bypass", path=src.rel, line=node.lineno,
                    key=name,
                    message=(f"direct {name} call bypasses the "
                             f"ops/sorting.py sort switch — use "
                             f"sort_unstable/sort_kv_unstable (or add a "
                             f"baseline entry with a reason)")))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in SORT_METHODS
                  and _receiver_root(node) not in HOST_ROOTS
                  and not _list_sort(node, tensors)):
                out.append(Finding(
                    rule="sort-bypass", path=src.rel, line=node.lineno,
                    key=f".{node.func.attr}()",
                    message=(f".{node.func.attr}() reorder bypasses the "
                             f"ops/sorting.py sort switch — use "
                             f"sort_kv_unstable")))
    return out
