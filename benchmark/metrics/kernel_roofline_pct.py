"""The least time the profiled passes' DP work needs on the card
(``benchmark/roofline.py``, counted from the reference's DAGs) as a
percentage of all device kernel time in the profiled part of the window.
None when the profiler saw no kernel."""


def read(run):
    if run.trace is None or run.trace["kernel_s"] <= 0:
        return None
    return 100.0 * run.least_s_per_pass * run.traced_passes \
        / run.trace["kernel_s"]
