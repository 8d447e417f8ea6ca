"""Observability of the port: the run ledger (ROADMAP A18d's
``ledger.py``).  The JAX package's other observability modules (spans,
flight recorder, metrics, watchdog, forensics, critical path, status
endpoint) are ROADMAP A18d."""

from tpu_radix_join_torch.observability.ledger import (Ledger,
                                                       default_ledger_dir,
                                                       load_rows,
                                                       run_fingerprint,
                                                       run_payload)

__all__ = ["Ledger", "default_ledger_dir", "load_rows", "run_fingerprint",
           "run_payload"]
