"""Mean milliseconds a pass of the C++ plane's scan of the PAF before its
parallel parse (slurp, line and name index, chromosome interning, contig
groups; wall time, ``stats["native_scan_s"]``), over the profiled passes:
the host plane counts only while a profiler records.  0.0 where nothing
was counted; None for a program without the counter."""


def read(run):
    return run.stat_mean_ms("native_scan_s")
