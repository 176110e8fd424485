"""Mean milliseconds a pass of wire export, copy to the card and kernel
launch (``stats["launch_s"]``), over every pass of the traced window."""


def read(run):
    return run.stat_mean_ms("launch_s")
