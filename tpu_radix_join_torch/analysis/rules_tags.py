"""Rule ``counter-tag``: every emitted tag has a direction home.

Counterpart of ``tpu_radix_join/analysis/rules_tags.py`` over the port's
registry (``performance/measurements.py``) and its copy of the regress
gate (``observability/regress.py``).

The regress gate (observability/regress.py) only means something for a
tag whose direction it knows: a counter emitted nowhere in the pin
registries is compared under the implicit "unmatched = cost" default,
which is silent — nobody decided it.  This rule cross-checks the two
vocabularies in *both* directions:

  * **emitted but undeclared** — every first argument of a
    ``Measurements`` ``incr``/``start``/``stop``/``add_time_us`` call
    (string literal, or an UPPER_CASE name resolved against the
    measurements-module constant table) must be declared in regress.py:
    exact membership in ``_HIGHER_BETTER`` / ``_COST_TAGS`` /
    ``NEUTRAL_TAGS`` / ``_SKIP``, or matched by a direction substring
    list.  "Explicitly neutral" is a real declaration: NEUTRAL_TAGS
    entries are workload/geometry descriptors with no regression
    direction, and saying so is the decision this rule demands.
  * **declared but dead** — an exact pin whose string appears nowhere
    in the lintable sources outside regress.py suppresses nothing and
    rots; it is flagged so removed tags take their pins with them.

The emitted-tag universe resolves UPPER_CASE names by importing
``performance.measurements`` (the vocabulary's single source of truth);
lower-case names are generic plumbing (``for k in keys: m.stop(k)``)
and are skipped — the loop's *sources* are literal/constant sites this
rule already sees.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from tpu_radix_join_torch.analysis.core import Finding, Repo, rule

EMIT_METHODS = {"incr", "start", "stop", "add_time_us"}

#: file holding the pin registries (never scanned for liveness hits)
REGRESS_REL = "tpu_radix_join_torch/observability/regress.py"
#: the vocabulary module: UPPER_CASE str constants define tag names
MEASUREMENTS_REL = "tpu_radix_join_torch/performance/measurements.py"


def _constant_table() -> Dict[str, str]:
    from tpu_radix_join_torch.performance import measurements
    return {name: val for name, val in vars(measurements).items()
            if name.isupper() and isinstance(val, str)}


def _declared_sets():
    from tpu_radix_join_torch.observability import regress
    exact = (set(regress._HIGHER_BETTER) | set(regress._COST_TAGS)
             | set(regress.NEUTRAL_TAGS) | set(regress._SKIP))
    substrings = (tuple(regress._HIGHER_BETTER_SUBSTRINGS)
                  + tuple(regress._LOWER_BETTER_SUBSTRINGS))
    pinned_exact = (set(regress._HIGHER_BETTER) | set(regress._COST_TAGS)
                    | set(regress.NEUTRAL_TAGS))
    return exact, substrings, pinned_exact


def _tag_declared(tag: str, exact, substrings) -> bool:
    t = tag.lower()
    return tag in exact or any(s in t for s in substrings)


def _emitted_tag(node: ast.Call, consts: Dict[str, str]
                 ) -> Optional[Tuple[str, str]]:
    """(tag, spelling) for an emit call, else None."""
    if (not isinstance(node.func, ast.Attribute)
            or node.func.attr not in EMIT_METHODS or not node.args):
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, f'"{arg.value}"'
    if isinstance(arg, ast.Name) and arg.id.isupper():
        if arg.id in consts:
            return consts[arg.id], arg.id
        return arg.id, arg.id        # unknown constant: flag under itself
    return None


@rule("counter-tag",
      "emitted Measurements tags must be pinned or explicitly neutral "
      "in regress.py; dead pins are flagged too",
      token="tag")
def check(repo: Repo) -> List[Finding]:
    consts = _constant_table()
    exact, substrings, pinned_exact = _declared_sets()
    out: List[Finding] = []
    emitted = set()
    for src in repo.files:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = _emitted_tag(node, consts)
            if hit is None:
                continue
            tag, spelling = hit
            emitted.add(tag)
            if not _tag_declared(tag, exact, substrings):
                out.append(Finding(
                    rule="counter-tag", path=src.rel, line=node.lineno,
                    key=tag,
                    message=(f"tag {spelling} is emitted here but has no "
                             f"direction declaration in regress.py — add "
                             f"it to _COST_TAGS, _HIGHER_BETTER, or "
                             f"NEUTRAL_TAGS")))
    # reverse direction: exact pins must be live somewhere outside
    # regress.py (substring patterns describe artifact keys and are
    # exempt from the liveness check)
    regress_src = repo.get(REGRESS_REL)
    corpus = [s.source.lower() for s in repo.files if s.rel != REGRESS_REL]
    for tag in sorted(pinned_exact):
        needle = tag.lower()
        if not any(needle in text for text in corpus):
            line = 1
            if regress_src is not None:
                for i, text in enumerate(regress_src.source.splitlines(),
                                         start=1):
                    if f'"{tag}"' in text or f"'{tag}'" in text:
                        line = i
                        break
            out.append(Finding(
                rule="counter-tag", path=REGRESS_REL, line=line, key=tag,
                message=(f"pin for {tag!r} matches nothing in the lintable "
                         f"sources — dead pin; remove it or restore the "
                         f"emitter")))
    return out
