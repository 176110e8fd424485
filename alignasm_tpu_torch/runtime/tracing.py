"""Stage spans and host-plane counters of the native route, on the
profiler's clock.

``span(stats, key, label)`` times one stage of ``solve_dataset_torch``:
it always adds the stage's seconds to ``stats[key]``, and only while a
``torch.profiler`` records it also opens ``record_function(label)``, so
the stage lies in the profiler's trace on the clock of the card's
events.  Whether one records is a single flag read a call.  ``LABELS``
holds every label the native route opens, the outer ``SOLVE`` first;
the stages that ``benchmark/probes.py`` labels from outside keep its
strings.  ``native_counters`` switches the C++ host plane's counter
table (``native.trace``) on for a call while a profiler records, and
hands its slots on as ``native_<slot>_s`` (seconds) and
``native_<slot>_n`` (scopes counted).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

from alignasm_tpu_torch import native

SOLVE = "solve_dataset_torch"  # one a call, the parent of the rest
PACK = "pack (parse, build)"  # stats["pack_s"]
BUCKET = "bucket (sort, prepare)"  # ["bucket_s"]
LAUNCH = "launch (export, copy, kernels)"  # ["launch_s"]
START = "start (host solve)"  # ["overlap_start_s"]
SYNC = "sync (wait, copy back)"  # ["sync_s"], a bucket each
FINISH = "finish"  # ["cfinish_s"], a bucket each
WAIT = "wait (host solve)"  # ["overlap_join_s"]
NATIVE_SOLVE = "native solve"  # ["remaining_s"]
WRITE = "write"  # ["write_s"]
CLOSE = "close"  # ["close_s"]
LABELS = (SOLVE, PACK, BUCKET, LAUNCH, START, SYNC, FINISH, WAIT,
          NATIVE_SOLVE, WRITE, CLOSE)

recording = torch._C._autograd._profiler_enabled


class span:
    """One stage: adds its seconds to ``stats[key]`` (no key when
    ``key`` is None) and, while a profiler records, runs inside
    ``record_function(label)`` (no span when ``label`` is None).  The
    stage's own seconds are ``seconds`` after it."""

    __slots__ = ("_stats", "_key", "_label", "_rf", "_t0", "seconds")

    def __init__(self, stats, key, label=None):
        self._stats, self._key, self._label = stats, key, label

    def __enter__(self):
        self._rf = None
        if self._label is not None and recording():
            self._rf = record_function(self._label)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._key is not None:
            self._stats[self._key] = self._stats.get(self._key, 0.0) \
                + self.seconds
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


@contextlib.contextmanager
def native_counters(publish):
    """While a profiler records at entry: the host plane's counter table
    on for the block, then off, read and handed to ``publish`` as stats
    keys when the block ends without an exception.  A background
    teardown the block starts is counted when it ends, in the next read.
    Without a profiler: nothing."""
    if not recording():
        yield
        return
    native.trace(True)
    try:
        yield
    finally:
        native.trace(False)
        slots = native.trace_read()
    counters = {}
    for name, (seconds, count) in slots.items():
        counters[f"native_{name}_s"] = seconds
        counters[f"native_{name}_n"] = count
    publish(counters)
