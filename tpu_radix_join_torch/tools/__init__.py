"""The port's command-line tools, each ``main(argv) -> int`` and runnable
as ``python -m tpu_radix_join_torch.tools.<name>``: ``lint``,
``check_regress``, ``critical_path``, ``chaos``, ``postmortem``,
``make_report`` (the report over ``--output-dir`` runs, and the profile,
timeline and ledger it distills) and ``profile_fit`` (fit, refresh and
diff device profiles from a ledger), the counterparts of the JAX
package's root ``tools_*.py``.  Each exits 0 on success, 1 on findings (a
regression, a violation, no path, an unreadable bundle, nothing to merge
or ingest, stale constants) and 2 on usage or IO errors."""
