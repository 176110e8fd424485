"""Mean milliseconds a pass of the C++ plane's alt PAF merge (``-a``: the
alt file's slurp, parse and group flush, one thread after the whole
parse; wall time, ``stats["native_alt_merge_s"]``), over the profiled
passes: the host plane counts only while a profiler records.  0.0 where
nothing was counted (a pass without an alt PAF); None for a program
without the counter."""


def read(run):
    return run.stat_mean_ms("native_alt_merge_s")
