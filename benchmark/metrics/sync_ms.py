"""Mean milliseconds a pass of waiting for the card and copying its rows
back (``stats["sync_s"]``), over every pass of the traced window."""


def read(run):
    return run.stat_mean_ms("sync_s")
