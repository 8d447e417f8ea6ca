"""The port's lint core: rule registry, repo walker, findings, baseline.

Counterpart of ``tpu_radix_join/analysis/core.py``, the same mechanics
over the port's own source.  The port's conventions — every hot sort
through ``ops/sorting.py``, every counter tag pinned in ``regress.py``,
every failure classified, no implicit host sync in the engine's hot
files, every background thread's writes under a lock — become AST rules,
enforced at tier-1 time rather than rediscovered on the card.

Mechanics
---------
* A **rule** is a function ``fn(repo) -> [Finding]`` registered with
  :func:`rule`; each carries an id (``sort-bypass``), a one-line doc,
  and an annotation *token*.
* The **walker** (:func:`load_repo`) parses the lintable source set
  once — the ``tpu_radix_join_torch`` package plus the repo-root
  ``chip_smoke.py`` — and hands every rule the same parsed
  :class:`SourceFile` list.  ``tests/`` is out of scope by design:
  fixtures deliberately violate conventions.
* A finding renders as ``path:line:rule-id: message`` and carries a
  stable ``key`` (the offending symbol — a call name, a tag, an
  attribute) so baseline entries survive line drift.
* **Inline waiver**: a line comment ``# lint: <token>-ok(<reason>)``
  suppresses that line's findings for rules declaring ``<token>`` —
  but only with a non-empty reason; a bare ``...-ok()`` suppresses
  nothing.
* **Baseline** (:data:`BASELINE_NAME`, beside this module): committed
  suppressions for findings kept deliberately.  Every entry must carry
  a ``reason``; a reasonless entry is a load error (exit 2 at the CLI),
  and an entry matching no current finding is *stale* — reported
  always, a failure under ``--strict`` (a fixed finding must take its
  suppression with it).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

BASELINE_NAME = "LINT_BASELINE.json"
#: the package the walker covers, and the baseline's home inside it
PACKAGE = "tpu_radix_join_torch"
#: repo-root scripts that belong to the port
ROOT_SCRIPTS = ("chip_smoke.py",)


def default_baseline(root: str) -> str:
    """The committed baseline of the checkout at ``root``."""
    return os.path.join(root, PACKAGE, "analysis", BASELINE_NAME)

#: line comment that waives one rule on one line; the reason is mandatory
ANNOTATION_RE = re.compile(r"#\s*lint:\s*([A-Za-z0-9_-]+)-ok\(([^)#]*)\)")


class LintError(Exception):
    """Configuration/IO failure (unreadable file, bad baseline schema):
    the CLI maps this to exit 2, distinct from exit 1 (findings)."""


# --------------------------------------------------------------------- model
@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    key: str           # stable content token for baseline matching
    message: str

    def record(self) -> str:
        return f"{self.path}:{self.line}:{self.rule}"

    def render(self) -> str:
        return f"{self.record()}: {self.message}"


@dataclass
class SourceFile:
    path: str                                   # absolute
    rel: str                                    # repo-relative
    source: str
    tree: ast.Module
    #: line -> [(token, reason)] from ``# lint: token-ok(reason)``
    annotations: Dict[int, List[Tuple[str, str]]] = field(default_factory=dict)

    def waived(self, line: int, token: str) -> bool:
        return any(t == token and r.strip()
                   for t, r in self.annotations.get(line, ()))


@dataclass
class Repo:
    root: str
    files: List[SourceFile]

    def get(self, rel: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.rel == rel:
                return f
        return None


@dataclass(frozen=True)
class Rule:
    id: str
    doc: str
    token: str          # annotation token: ``# lint: <token>-ok(reason)``
    fn: Callable[[Repo], List[Finding]]


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, doc: str, token: str):
    """Register a rule function under ``rule_id``."""
    def deco(fn):
        if rule_id in RULES:
            raise LintError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, doc, token, fn)
        return fn
    return deco


# -------------------------------------------------------------------- walker
def _parse_annotations(source: str) -> Dict[int, List[Tuple[str, str]]]:
    out: Dict[int, List[Tuple[str, str]]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        if "lint:" not in line:
            continue
        for m in ANNOTATION_RE.finditer(line):
            out.setdefault(lineno, []).append((m.group(1), m.group(2)))
    return out


def lintable_paths(root: str) -> List[str]:
    """The default source set: the port's package and its root scripts."""
    paths: List[str] = []
    pkg = os.path.join(root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for name in sorted(filenames):
            if name.endswith(".py"):
                paths.append(os.path.join(dirpath, name))
    for name in ROOT_SCRIPTS:
        if os.path.exists(os.path.join(root, name)):
            paths.append(os.path.join(root, name))
    return paths


def load_repo(root: str, paths: Optional[List[str]] = None) -> Repo:
    root = os.path.abspath(root)
    files = []
    for path in (paths if paths is not None else lintable_paths(root)):
        path = os.path.abspath(path)
        try:
            with open(path) as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            raise LintError(f"cannot lint {path}: {e}") from e
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        files.append(SourceFile(path=path, rel=rel, source=source, tree=tree,
                                annotations=_parse_annotations(source)))
    return Repo(root=root, files=files)


# ------------------------------------------------------------------ baseline
def load_baseline(path: str) -> List[dict]:
    """Validated suppression entries.  Schema: ``{"suppressions": [
    {"rule": ..., "path": ..., "key": ..., "reason": <non-empty>}]}``."""
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError as e:
        raise LintError(f"cannot read baseline {path}: {e}") from e
    except ValueError as e:
        raise LintError(f"baseline {path} is not valid JSON: {e}") from e
    entries = data.get("suppressions")
    if not isinstance(entries, list):
        raise LintError(f"baseline {path} has no 'suppressions' list")
    for i, e in enumerate(entries):
        for k in ("rule", "path", "key", "reason"):
            if not isinstance(e.get(k), str) or not e[k].strip():
                raise LintError(
                    f"baseline {path} entry {i} needs a non-empty {k!r} "
                    f"(every suppression carries a reason)")
        if e["rule"] not in RULES:
            raise LintError(
                f"baseline {path} entry {i} names unknown rule {e['rule']!r}")
    return entries


def apply_baseline(findings: List[Finding], entries: List[dict]):
    """(kept, suppressed, stale_entries): drop findings a suppression
    matches; entries matching nothing are stale."""
    kept, suppressed = [], []
    used = [False] * len(entries)
    for f in findings:
        hit = None
        for i, e in enumerate(entries):
            if (e["rule"] == f.rule and e["path"] == f.path
                    and e["key"] == f.key):
                hit = i
                break
        if hit is None:
            kept.append(f)
        else:
            used[hit] = True
            suppressed.append(f)
    stale = [e for i, e in enumerate(entries) if not used[i]]
    return kept, suppressed, stale


# --------------------------------------------------------------------- runner
@dataclass
class LintResult:
    findings: List[Finding]          # live (non-baselined) findings
    suppressed: List[Finding]        # matched by a baseline entry
    stale: List[dict]                # baseline entries matching nothing
    rules: List[str]                 # rule ids that ran

    def exit_code(self, strict: bool = False) -> int:
        """0/1 contract shared with tools.check_regress: findings (or,
        under strict, stale suppressions) fail; exit 2 is reserved for
        LintError at the CLI."""
        if self.findings:
            return 1
        if strict and self.stale:
            return 1
        return 0


def run_lint(root: str, rule_ids: Optional[List[str]] = None,
             baseline_path: Optional[str] = None,
             paths: Optional[List[str]] = None) -> LintResult:
    """Run ``rule_ids`` (default: all registered) over the repo at
    ``root``, applying inline waivers then the baseline."""
    # populate RULES on first use without an import cycle at module load
    from tpu_radix_join_torch.analysis import register_builtin_rules
    register_builtin_rules()
    ids = list(RULES) if rule_ids is None else list(rule_ids)
    unknown = [r for r in ids if r not in RULES]
    if unknown:
        raise LintError(f"unknown rule id(s): {', '.join(unknown)} "
                        f"(known: {', '.join(sorted(RULES))})")
    repo = load_repo(root, paths=paths)
    by_rel = {f.rel: f for f in repo.files}
    findings: List[Finding] = []
    for rid in ids:
        r = RULES[rid]
        for f in r.fn(repo):
            src = by_rel.get(f.path)
            if src is not None and src.waived(f.line, r.token):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    entries: List[dict] = []
    if baseline_path and os.path.exists(baseline_path):
        entries = load_baseline(baseline_path)
    kept, suppressed, stale = apply_baseline(findings, entries)
    # a stale entry for a rule that did not run this invocation is not
    # stale — the finding it suppresses was never looked for
    stale = [e for e in stale if e["rule"] in ids]
    return LintResult(findings=kept, suppressed=suppressed, stale=stale,
                      rules=ids)


# ----------------------------------------------------------------- ast utils
def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.sort`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_self_attr(node: ast.AST) -> Optional[str]:
    """The attribute name when ``node`` is ``self.<attr>``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None
