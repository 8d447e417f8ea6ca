"""The port's static analysis: its conventions as AST rules.

Counterpart of ``tpu_radix_join/analysis/``.  The framework lives in
:mod:`core` (registry, walker, findings, baseline); the rules each get a
module, seven rule ids in six modules:

  =================  ===================================================
  sort-bypass        hot sorts route through ops/sorting.py (K2)
  counter-tag        emitted tags pinned/neutral in regress.py, both ways
  failure-class      failure_class strings come from the retry taxonomy
  sync-point         no implicit host syncs (utils/hostsync.py)
  recompile-hazard   no torch.compile in a loop / f-string build keys
  lock-discipline    thread-target writes hold a lock or say why not
  lock-order         the instance locks' acquisition graph is acyclic
  =================  ===================================================

Not applicable, and not ported: JAX's ``analysis/jaxpr/*`` (the
``transfer``, ``collective-axis``, ``width``, ``donation`` and
``static-memory`` rules over a traced jaxpr, with JXAUDIT, STATICMEM,
``tools_jaxpr_audit.py``, ``tools_static_gate.py`` and the planner's
static gate): the port traces no program, so there is no IR to audit.

Command line: ``python -m tpu_radix_join_torch.tools.lint``; the
baseline is ``analysis/LINT_BASELINE.json`` beside this module.
"""

from tpu_radix_join_torch.analysis.core import (BASELINE_NAME, Finding,
                                                LintError, LintResult, RULES,
                                                Repo, apply_baseline,
                                                default_baseline,
                                                load_baseline, load_repo,
                                                run_lint)

_REGISTERED = False


def register_builtin_rules() -> None:
    """Import the rule modules (idempotent): importing registers."""
    global _REGISTERED
    if _REGISTERED:
        return
    from tpu_radix_join_torch.analysis import (rules_failure,    # noqa: F401
                                               rules_locks,      # noqa: F401
                                               rules_recompile,  # noqa: F401
                                               rules_sort,       # noqa: F401
                                               rules_sync,       # noqa: F401
                                               rules_tags)       # noqa: F401
    _REGISTERED = True


__all__ = ["BASELINE_NAME", "Finding", "LintError", "LintResult", "RULES",
           "Repo", "apply_baseline", "default_baseline", "load_baseline",
           "load_repo", "run_lint", "register_builtin_rules"]
