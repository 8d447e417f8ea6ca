"""Observability of the port (the JAX package's ``observability/``):

  * :mod:`ledger` — the run ledger, one row a run or a served query;
  * :mod:`flightrec` — the always-on ring of recent registry activity;
  * :mod:`spans` and :mod:`timeline` — per-rank Chrome-trace span files
    and their merge onto one clock, with the profiler's device track;
  * :mod:`metrics` — the background heartbeat (``--metrics-interval``);
  * :mod:`compilemon` — first-use kernel builds as NCOMPILE / COMPILEMS;
  * :mod:`postmortem` — forensics bundles of failed queries and runs;
  * :mod:`watchdog` — the hang watchdog over the flight recorder;
  * :mod:`statusz` — the live read-only status endpoint (``--statusz``);
  * :mod:`regress` — the regression gate over a result's numeric tags;
  * :mod:`critpath` — critical-path attribution over the span streams
    (the ``[CRITPATH]`` line, ``/statusz``'s ``critical_paths``).
"""

from tpu_radix_join_torch.observability.compilemon import (
    install_compile_monitor, uninstall_compile_monitor)
from tpu_radix_join_torch.observability.critpath import (
    compute_critical_path, critical_path_for_dir, critical_path_from_tracer,
    format_summary, load_streams, render_report, stream_from_tracer)
from tpu_radix_join_torch.observability.flightrec import (FlightRecorder,
                                                          dump_all_stacks)
from tpu_radix_join_torch.observability.ledger import (Ledger,
                                                       default_ledger_dir,
                                                       load_rows,
                                                       run_fingerprint,
                                                       run_payload)
from tpu_radix_join_torch.observability.metrics import (MetricsSampler,
                                                        load_samples)
from tpu_radix_join_torch.observability.postmortem import (build_bundle,
                                                           list_bundles,
                                                           load_bundle,
                                                           merge_bundles,
                                                           render_bundle,
                                                           write_bundle)
from tpu_radix_join_torch.observability.spans import SpanTracer
from tpu_radix_join_torch.observability.statusz import (StatuszServer,
                                                        measurements_sections)
from tpu_radix_join_torch.observability.timeline import (find_span_files,
                                                         merge_timeline)
from tpu_radix_join_torch.observability.watchdog import (HangDetected,
                                                         Watchdog,
                                                         engine_killer)

__all__ = [
    "FlightRecorder", "HangDetected", "Ledger", "MetricsSampler",
    "SpanTracer", "StatuszServer", "Watchdog", "build_bundle",
    "compute_critical_path", "critical_path_for_dir",
    "critical_path_from_tracer", "default_ledger_dir", "dump_all_stacks",
    "engine_killer", "find_span_files", "format_summary",
    "install_compile_monitor", "list_bundles", "load_bundle", "load_rows",
    "load_samples", "load_streams", "measurements_sections",
    "merge_bundles", "merge_timeline", "render_bundle", "render_report",
    "run_fingerprint", "run_payload", "stream_from_tracer",
    "uninstall_compile_monitor", "write_bundle",
]
