"""Mean milliseconds a pass of the native host plane's parse and graph
build (``stats["pack_s"]`` of ``solve_dataset_torch``), over every pass
of the traced window."""


def read(run):
    return run.stat_mean_ms("pack_s")
