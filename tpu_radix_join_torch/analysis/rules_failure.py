"""Rule ``failure-class``: every failure class comes from the taxonomy.

Counterpart of ``tpu_radix_join/analysis/rules_failure.py`` over the
port's ``robustness/retry.py``.

The robustness layer's whole contract is that callers branch on
``failure_class`` *data* (robustness/retry.py's closed string set) —
chaos triage, the serve loop's retry policy, and postmortem merging all
switch on those strings.  A hand-rolled class (``"oom"``, a typo like
``"rank-lost"``) silently falls through every branch: the chaos soak
books it a violation, the retry policy treats it as fatal, and the
postmortem merge shows an unknown bucket.

Flagged spellings, anywhere a *string literal* is used:

  * ``failure_class="..."`` keyword arguments,
  * ``failure_class = "..."`` / ``x.failure_class = "..."`` assigns,
  * ``...["failure_class"] = "..."`` subscript assigns,
  * ``{"failure_class": "..."}`` dict literals.

Names (``failure_class=RANK_LOST``) are not checked — constants resolve
to the taxonomy by construction.  The taxonomy is imported from
``robustness.retry`` (its UPPER_CASE string constants) plus the
service layer's ``"unclassified"`` sentinel (service/session.py: the
class stamped before triage has run).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from tpu_radix_join_torch.analysis.core import Finding, Repo, rule

#: classes that are taxonomy members without being retry.py constants:
#: "unclassified" is service/session.py's pre-triage sentinel
EXTRA_CLASSES = {"unclassified"}


def taxonomy() -> set:
    from tpu_radix_join_torch.robustness import retry
    return {val for name, val in vars(retry).items()
            if name.isupper() and not name.startswith("_")
            and isinstance(val, str)} | EXTRA_CLASSES


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _sites(tree: ast.Module):
    """Yield (line, class_string) for every literal failure-class use."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "failure_class":
                    s = _literal_str(kw.value)
                    if s is not None:
                        yield kw.value.lineno, s
        elif isinstance(node, ast.Assign):
            s = _literal_str(node.value)
            if s is None:
                continue
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name)
                        and tgt.id == "failure_class") \
                   or (isinstance(tgt, ast.Attribute)
                       and tgt.attr == "failure_class") \
                   or (isinstance(tgt, ast.Subscript)
                       and _literal_str(tgt.slice) == "failure_class"):
                    yield node.lineno, s
        elif isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (k is not None and _literal_str(k) == "failure_class"):
                    s = _literal_str(v)
                    if s is not None:
                        yield v.lineno, s


@rule("failure-class",
      "literal failure_class strings must come from the robustness/"
      "retry.py taxonomy",
      token="failure")
def check(repo: Repo) -> List[Finding]:
    classes = taxonomy()
    out: List[Finding] = []
    for src in repo.files:
        for line, s in _sites(src.tree):
            if s not in classes:
                out.append(Finding(
                    rule="failure-class", path=src.rel, line=line, key=s,
                    message=(f"failure class {s!r} is not in the "
                             f"robustness/retry.py taxonomy — use a "
                             f"declared class (or extend the taxonomy, "
                             f"never a one-off string)")))
    return out
