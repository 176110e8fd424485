"""Where a benchmark cell's passes spend their time by the program's own
spans, and what tracing costs.

    python3 trace_breakdown.py breakdown --workload W --seed N [--seconds S]
    python3 trace_breakdown.py oncost --workload W --seed N [--rounds R]
        [--passes P]

from the root of a checkout (``--device cpu`` rehearses either on the
plain PyTorch versions).  One JSON line on standard output.

``breakdown`` runs the cell once with ``--trace 1`` through the
benchmark's harness (``benchmark/run.py``) and adds, beside the harness's
breakdown, the card's idle time by the innermost open span when the
program's labels (``alignasm_tpu_torch/runtime/tracing.py:LABELS``) join
the harness's, and the profiled passes' mean of each host-plane counter
(``native_<slot>_s`` in ms, ``native_<slot>_n``).  ``idle_other_s`` is
the idle time outside the ten largest entries.

``oncost`` runs the cell's corpus for R rounds of three modes, P passes
each, the order turning every round: ``off`` (untraced), ``counters``
(the host plane's counter table on alone, ``native.trace``) and
``profiled`` (under ``torch.profiler`` with CPU and CUDA activities, which
turns the program's spans and the table on).  A pass is the harness's:
the solve of the corpus and its alt PAF, where the traffic has one, into
named pipes, draining them, joining the teardown.  Prints
each mode's median, quartiles and count of pass seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import sys
import tempfile
import time


def _means(stats) -> dict:
    keys = sorted({k for s in stats for k in s if k.startswith("native_")
                   and k[-2:] in ("_s", "_n") and k != "native_direct"})
    out = {}
    for k in keys:
        vals = [s[k] for s in stats if k in s]
        scale = 1e3 if k.endswith("_s") else 1
        out[k] = scale * sum(vals) / len(vals)
    return out


def breakdown(workload: str, seed: int, seconds: float, device: str) -> dict:
    import benchmark.trace as bt
    from alignasm_tpu_torch.runtime.tracing import LABELS
    from benchmark import run

    orig = bt.summarize
    mine = {}

    def summarize(events, window, labels=()):
        mine.update(orig(events, window, labels=set(labels) | set(LABELS)))
        return orig(events, window, labels)

    captured = []

    class Readings(run.Readings):
        def __init__(self, *args):
            super().__init__(*args)
            captured.append(self)

    bt.summarize, run.Readings = summarize, Readings
    try:
        result, _checks = run.run_cell(
            workload, seed, seconds, True, device=device,
            require_card=device.startswith("cuda"))
    finally:
        bt.summarize, run.Readings = orig, run.Readings.__base__
    readings = captured[0]
    idle_s = mine["window_s"] - mine["busy_s"]
    return {
        "workload": workload, "seed": seed, "correct": result["correct"],
        "device": result["device"], "metrics": result["metrics"],
        "traced_passes": readings.traced_passes,
        "harness_breakdown": result.get("breakdown"),
        "program_idle_gaps": mine["idle_gaps"],
        "idle_other_s": idle_s - sum(s for _n, s in mine["idle_gaps"]),
        "program_device_ops": mine["device_ops"],
        "native_means": _means(readings.stats),
    }


def _quartiles(values) -> list:
    q = statistics.quantiles(values, n=4) if len(values) > 1 else values * 3
    return [q[0], statistics.median(values), q[2]]


def oncost(workload: str, seed: int, rounds: int, passes: int,
           device: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch
    from benchmark import run
    from benchmark.sink import PipeSink

    spec = run.load_cell(workload)
    paf, text = run.corpus(workload, spec["traffic"], spec["config"], seed,
                           run.CACHE)
    alt, _ = run.alt_corpus(paf, spec["traffic"], spec["config"], seed, text)
    src_paths = (str(paf), str(alt) if alt else None)
    cfg = dataclasses.replace(DEFAULT_CONFIG, **spec["config"]["settings"])
    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    scratch = tempfile.mkdtemp(prefix="alignasm_oncost_")
    sink = PipeSink(scratch)

    def one_pass() -> float:
        t = time.perf_counter()
        solve_dataset_torch(None, cfg, src_paths=src_paths,
                            write_prefix=sink.prefix, device=device)
        sink.collect()
        native.drain_teardowns()
        return time.perf_counter() - t

    modes = ("off", "counters", "profiled")
    times = {m: [] for m in modes}
    try:
        for _ in range(int(spec["traffic"]["warm_passes"])):
            one_pass()
        warm = profile(activities=acts)  # CUPTI's first start
        warm.start()
        warm.stop()
        for r in range(rounds):
            for mode in modes[r % 3:] + modes[:r % 3]:
                prof = profile(activities=acts) if mode == "profiled" \
                    else None
                if prof is not None:
                    prof.start()
                native.trace(mode == "counters")
                for _ in range(passes):
                    times[mode].append(one_pass())
                native.trace(False)
                native.trace_read()
                if prof is not None:
                    prof.stop()
    finally:
        sink.close()
        shutil.rmtree(scratch, ignore_errors=True)
    name = torch.cuda.get_device_name(0) if device.startswith("cuda") \
        else "cpu"
    out = {"workload": workload, "seed": seed, "device": name}
    for m in modes:
        out[m] = {"pass_s_q1_median_q3": _quartiles(times[m]),
                  "passes": len(times[m])}
    base = statistics.median(times["off"])
    for m in modes[1:]:
        out[m]["median_over_off"] = statistics.median(times[m]) / base
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("breakdown", "oncost"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--passes", type=int, default=10)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    if args.what == "breakdown":
        out = breakdown(args.workload, args.seed, args.seconds, args.device)
    else:
        out = oncost(args.workload, args.seed, args.rounds, args.passes,
                     args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
