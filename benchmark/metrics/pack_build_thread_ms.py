"""Mean milliseconds a pass of contig graph building with arrival ranks,
summed over the C++ plane's parse workers (``stats["native_build_s"]``),
over the profiled passes.  Thread time."""


def read(run):
    return run.stat_mean_ms("native_build_s")
