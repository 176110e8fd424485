"""Mean milliseconds of one background teardown of the C++ plane's
context (the ``delete`` after ``GraphExporter.close()``; wall time,
``stats["native_teardown_s"]`` over ``["native_teardown_n"]``), over the
profiled passes: one a pass.  A teardown is counted when it ends, in the
next pass's stats, so the first profiled pass holds none and the sum is
taken over the teardowns, not the passes.  0.0 where none was counted;
None for a program without the counter."""


def read(run):
    stats = [s for s in run.stats if "native_teardown_s" in s]
    if not stats:
        return None
    n = sum(s["native_teardown_n"] for s in stats)
    return 1e3 * sum(s["native_teardown_s"] for s in stats) / n if n else 0.0
