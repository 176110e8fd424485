"""Mean milliseconds a pass of record and cs parsing, summed over the C++
plane's parse workers (``stats["native_parse_s"]``), over the profiled
passes.  Thread time: divide by the workers for its share of pack."""


def read(run):
    return run.stat_mean_ms("native_parse_s")
