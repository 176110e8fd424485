"""100 less the percentage of the profiled part of the window in which a
kernel or a copy ran on the card (the union of the profiler's device
intervals).  None when the profiler saw no device event."""


def read(run):
    if run.trace is None or run.trace["n_device_events"] == 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
