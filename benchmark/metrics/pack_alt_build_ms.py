"""Mean milliseconds a pass of the C++ plane's graph build where an alt PAF
is merged: the build pool that waits for the merge, in place of the
parse's fused build (wall time, ``stats["native_alt_build_s"]``), over
the profiled passes: the host plane counts only while a profiler
records.  0.0 where nothing was counted (a pass without an alt PAF);
None for a program without the counter."""


def read(run):
    return run.stat_mean_ms("native_alt_build_s")
