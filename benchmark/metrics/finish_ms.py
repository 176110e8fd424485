"""Mean milliseconds a pass of the threaded C++ finish of the device's
contigs (``stats["cfinish_s"]``), over every pass of the traced window."""


def read(run):
    return run.stat_mean_ms("cfinish_s")
