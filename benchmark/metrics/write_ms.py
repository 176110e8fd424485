"""Mean milliseconds a pass of writing the three output files
(``stats["write_s"]``, the program's span "write": the flush of the
formatted parts), over every pass of the traced window."""


def read(run):
    return run.stat_mean_ms("write_s")
