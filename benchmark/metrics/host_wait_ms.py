"""Mean milliseconds a pass that the main thread waits, after the last
bucket's finish, for the host solve of the contigs outside the device
envelope (``stats["overlap_join_s"]``, the program's span "wait (host
solve)"), over every pass of the traced window."""


def read(run):
    return run.stat_mean_ms("overlap_join_s")
