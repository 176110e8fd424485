"""Mean milliseconds a pass of the host solve of the contigs whose gate
row the device marked not fast, summed over the finish workers
(``stats["native_fallback_s"]``), over the profiled passes.  Thread
time; 0.0 in a pass with no such contig."""


def read(run):
    return run.stat_mean_ms("native_fallback_s")
