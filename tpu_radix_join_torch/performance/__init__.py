"""Phase timers, counters, the ``.perf`` report and profiler traces of the
port's runs (``measurements.py``, ``trace.py``)."""

from tpu_radix_join_torch.performance.measurements import (  # noqa: F401
    BPBUILD, BPPROBE, CTOTAL, JCOMPILE, JHIST, JMPI, JPROC, JTOTAL,
    MWINWAIT, SDISPATCH, SLOCPREP, SNETCOMPL, SWINALLOC, Measurements,
    print_results)

__all__ = ["BPBUILD", "BPPROBE", "CTOTAL", "JCOMPILE", "JHIST", "JMPI",
           "JPROC", "JTOTAL", "MWINWAIT", "Measurements", "SDISPATCH",
           "SLOCPREP", "SNETCOMPL", "SWINALLOC", "print_results"]
