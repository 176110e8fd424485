"""Readers of a ``torch.profiler`` trace: the device's busy time, kernel
time, and the breakdown the result line carries.

The busy time is ``chip_smoke.py:union_ms``'s method (the union of every
kernel and copy interval the profiler saw on the device); the rest is the
benchmark's own.  Times in the profiler's events are microseconds.
"""

from __future__ import annotations

NO_SPAN = "native host code (no span)"
PASS = "pass"  # the span of a whole pass, never an idle gap's label


def merged(spans):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _is_copy(name: str) -> bool:
    n = name.lower()
    return "memcpy" in n or "memset" in n


def summarize(events, window, labels=()) -> dict:
    """From the profiler's events and the traced stretch ``window`` (start,
    end) in the trace's time base: device intervals, kernel time, busy
    time, the device operations by total time, and the idle time by the
    innermost of the benchmark's spans (``labels``) open over each stretch
    of it."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type != cuda:
            host.append((a, b, e.name))
        elif not getattr(e, "is_user_annotation", False) \
                and e.name not in labels:
            dev.append((a, b, e.name))  # not a span's mark on the stream
    lo, hi = window
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    by_name: dict = {}
    kernel_us = 0.0
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        if not _is_copy(n):
            kernel_us += b - a
    busy = merged([(a, b) for a, b, _ in dev])
    gaps = []
    t = lo
    for a, b in busy + [[hi, hi]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host = [h for h in host if h[2] in labels and h[2] != PASS]
    idle: dict = {}
    for a, b in gaps:
        # each stretch of the gap goes to the innermost span open over it
        over = [h for h in host if h[0] < b and h[1] > a]
        cuts = sorted({a, b} | {x for s, e, _ in over for x in (s, e)
                                if a < x < b})
        for lo_, hi_ in zip(cuts, cuts[1:]):
            mid = (lo_ + hi_) / 2
            inner = [(e - s, name) for s, e, name in over if s <= mid <= e]
            label = min(inner)[1] if inner else NO_SPAN
            idle[label] = idle.get(label, 0.0) + (hi_ - lo_)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_ops": [[n, s / 1e6] for n, s in top],
        "idle_gaps": [[n, s / 1e6] for n, s in gap_top],
        "n_device_events": len(dev),
    }
