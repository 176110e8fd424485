"""One run of one cell of the benchmark of ``alignasm_tpu_torch``.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``benchmark/configs/<name>.json``:
the program's settings) and a traffic mix (``benchmark/traffic/<name>.json``:
the corpus, ``benchmark/corpus.py``).  A run:

1. makes the corpus from the seed, and the alt PAF where the traffic has an
   ``alt`` block, or finds them cached by (cell, seed, traffic and
   configuration) under ``benchmark/.cache/`` (timed apart from the
   set-up);
2. sets up the program (imports, the C++ plane's and the kernels' builds on
   a first run, the CUDA context) and runs ``warm_passes`` whole passes;
3. runs whole passes back to back for ``--seconds``, a closed loop of one
   client: a pass is one user job, ``solve_dataset_torch(None, cfg,
   src_paths=(paf, alt or None), write_prefix=..., device="cuda:0")`` with
   the three output files on named pipes (``benchmark/sink.py``), until its
   files are drained and the native plane's teardown has ended;
4. checks every contig's lines in the newest pass's three files, the
   gate rows the device returned and which contigs it finished against the
   plain reference (``benchmark/reference``, the alt PAF merged, cached
   with the corpus), and every pass against the newest
   (``benchmark/check.py``);
5. prints the result as the last line of standard output, and each
   compared number beside its limit as the last lines of standard error.

With ``--trace 1`` the window runs the same, a steady stretch of it under
``torch.profiler``, and the result carries the cell's per-layer metrics
(one reader a metric, ``benchmark/metrics/<name>.py``) instead of its
end-to-end ones.  Nothing here imports JAX or the JAX package; a run that
finds one of them loaded exits without a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from benchmark.trace import PASS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "alignasm_tpu")
# the profiled stretch: this many passes from this share of the window on
TRACE_FROM, TRACE_PASSES = 1 / 3, 20


class RunError(RuntimeError):
    """A run that cannot give a result; the message says why."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(workload: str, root: pathlib.Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic and metrics, found by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": spec["end_to_end"], "per_layer": spec["per_layer"]}


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


class Readings:
    """What a per-layer reader reads: every pass's stats, the trace summary
    (``benchmark/trace.py``) or None, the passes it covers, and the least
    time a pass's DP work needs (``benchmark/roofline.py``)."""

    def __init__(self, stats, trace, traced_passes, least_s_per_pass):
        self.stats = stats
        self.trace = trace
        self.traced_passes = traced_passes
        self.least_s_per_pass = least_s_per_pass

    def stat_mean_ms(self, key: str):
        vals = [s[key] for s in self.stats if key in s]
        return 1e3 * sum(vals) / len(vals) if vals else None


def _write_atomic(path: pathlib.Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def corpus(name: str, traffic: dict, config: dict, seed: int,
           cache: pathlib.Path):
    """(path, text) of the cell's corpus for ``seed``, made once and
    cached in a directory of (cell, seed, traffic and configuration), so
    corpora of one cell and seed with and without an alt PAF stay
    apart."""
    from benchmark.corpus import generate

    key = hashlib.sha256(json.dumps([traffic, config], sort_keys=True)
                         .encode()).hexdigest()[:16]
    path = cache / name / str(seed) / key / "corpus.paf"
    if not path.exists():
        _write_atomic(path, generate(traffic, seed, config))
    return path, path.read_text()


def alt_corpus(paf: pathlib.Path, traffic: dict, config: dict, seed: int,
               text: str):
    """(path, text) of the alt PAF beside the corpus ``paf`` (whose text is
    ``text``), made once and cached, where the traffic has an ``alt``
    block; else (None, None)."""
    from benchmark.corpus import generate_alt

    if "alt" not in traffic:
        return None, None
    path = paf.with_name("corpus.alt.paf")
    if not path.exists():
        _write_atomic(path, generate_alt(traffic, seed, config, text))
    return path, path.read_text()


def reference(cfg_fields, paf, text, alt_text, workers):
    """The plain reference of the corpus ``paf`` and its alt PAF, computed
    once and cached beside them."""
    from benchmark.reference import solve
    from benchmark.reference.config import AlignasmConfig

    ref = solve.load(paf.parent)
    if ref is None:
        ref = solve.compute(text, AlignasmConfig(**cfg_fields), workers,
                            alt_text=alt_text)
        solve.save(ref, paf.parent)
    return ref


def _device_block(torch, device: str, chips: int) -> dict:
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(i) for i in range(chips)))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def _bytes_written() -> int | None:
    try:
        for line in pathlib.Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except OSError:
        return None
    return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda:0", require_card: bool = True,
             root: pathlib.Path = ROOT, cache: pathlib.Path = CACHE,
             traffic: dict | None = None, workers: int | None = None,
             log=None) -> tuple[dict, list]:
    """Run one cell once; returns (result, check lines).  ``device``,
    ``require_card``, ``cache``, ``traffic`` and ``workers`` exist for the
    benchmark's own tests, which drive a run on the CPU at a small size."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = load_cell(workload, root)
    cell, config = spec["cell"], spec["config"]
    traffic = traffic or spec["traffic"]
    chips = int(cell["chips"])

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if require_card and found < chips:
        raise RunError(f"the cell needs {chips} CUDA card(s); found {found}")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)

    t0 = time.perf_counter()
    paf, text = corpus(workload, traffic, config, seed, cache)
    alt, alt_text = alt_corpus(paf, traffic, config, seed, text)
    corpus_s = time.perf_counter() - t0
    n_contigs = sum(1 for _ in _contig_names(text))
    src_paths = (str(paf), str(alt) if alt else None)

    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    from benchmark import check, probes
    from benchmark.sink import PipeSink

    native.build()
    cfg = dataclasses.replace(DEFAULT_CONFIG, **config["settings"])
    scratch = tempfile.mkdtemp(prefix="alignasm_bench_")
    sink = PipeSink(scratch)
    rows = probes.RowCapture(native.GraphExporter)
    spans = None
    prof = None
    profiling = False
    try:
        if trace:
            spans = probes.Spans()
        from torch.profiler import record_function

        def one_pass():
            t = time.perf_counter()
            with record_function(PASS):
                solve_dataset_torch(None, cfg, src_paths=src_paths,
                                    write_prefix=sink.prefix, device=device)
                with record_function("drain pipes"):
                    sizes = sink.collect()
                with record_function("teardown"):
                    native.drain_teardowns()
            dt = time.perf_counter() - t
            st = dict(solve_dataset_torch.last_stats)
            t = time.perf_counter()
            sig = (tuple(sizes), rows.end_pass())
            harness[0] += sink.cpu_s
            harness[1] += time.perf_counter() - t
            return dt, st, sig

        harness = [0.0, 0.0]  # drain threads' CPU s, row signatures' s
        last = 0.0
        for _ in range(int(traffic["warm_passes"])):
            last = one_pass()[0]
        harness = [0.0, 0.0]
        if trace:  # the profiler's first start (CUPTI) belongs to set-up
            warm = _profiler(device)
            warm.start()
            warm.stop()
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        t_window = time.perf_counter()
        setup_s = t_window - T_START - corpus_s
        host0 = _host_cpu_s()

        times, stats, sigs = [], [], []
        traced = 0
        while True:
            now = time.perf_counter() - t_window
            if now >= seconds:
                break
            # the stretch starts a third in, or at the last pass that
            # starts, so a window of few passes is traced too
            if trace and prof is None and (now >= TRACE_FROM * seconds
                                           or now + last >= seconds):
                prof = _profiler(device)
                prof.start()
                profiling = True
            dt, st, sig = one_pass()
            last = dt
            times.append(dt)
            stats.append(st)
            sigs.append(sig)
            if profiling:
                traced += 1
                if traced == TRACE_PASSES:
                    prof.stop()
                    profiling = False
        window_s = time.perf_counter() - t_window
        host1 = _host_cpu_s()
        if profiling:  # the window ended inside the stretch
            prof.stop()
            profiling = False
        dev = _device_block(torch, device, chips)
        texts = [sink.last_text(k) for k in range(3)]
        last_rows = rows.last
    finally:
        if profiling:
            prof.stop()
        if spans is not None:
            spans.close()
        rows.close()
        sink.close()
        shutil.rmtree(scratch, ignore_errors=True)
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    trace_summary = None
    if trace and traced:
        from benchmark.trace import summarize
        events = prof.events()
        passes = [(e.time_range.start, e.time_range.end) for e in events
                  if e.name == PASS and not _on_device(e)]
        trace_summary = summarize(
            events, (min(a for a, _ in passes), max(b for _, b in passes)),
            labels={label for *_, label in probes.SPANS}
            | {PASS, "drain pipes", "teardown"})

    t0 = time.perf_counter()
    cfg_fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    ref = reference(cfg_fields, paf, text, alt_text,
                    workers or os.cpu_count() or 1)
    ref_s = time.perf_counter() - t0
    numbers = check.compare(
        ref, texts, last_rows, sigs,
        [(s.get("device", 0), s.get("fallback", 0)) for s in stats])

    if trace:
        from benchmark.roofline import least_seconds, pass_work
        readings = Readings(stats, trace_summary, traced, least_seconds(
            *pass_work(ref["n_v"], ref["n_e"], ref["eligible"])))
        metrics = {}
        for m in spec["per_layer"]:
            value = metric_reader(m["name"], root)(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"contigs_per_s": n_contigs * len(times) / window_s,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in e2e}

    result = {"correct": check.verdict(numbers), "attempted": len(times),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace_summary is not None:
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {"device_ops": trace_summary["device_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
    log(f"cell {workload} seed {seed}: {len(times)} passes of {n_contigs} "
        f"contigs in {window_s:.4f} s; set-up {setup_s:.4f} s; corpus "
        f"{corpus_s:.4f} s; reference {ref_s:.4f} s; traced passes {traced}")
    log(f"pass seconds: min {min(times):.6f} median "
        f"{nearest_rank(times, 0.5):.6f} p90 {nearest_rank(times, 0.9):.6f} "
        f"p95 {nearest_rank(times, 0.95):.6f} max {max(times):.6f}"
        if times else "no pass in the window")
    log(f"harness a pass: drain threads {harness[0] / max(1, len(times)):.6f}"
        f" CPU s, row signatures {harness[1] / max(1, len(times)):.6f} s")
    tenths = [times[len(times) * k // 10:len(times) * (k + 1) // 10]
              for k in range(10)]
    log("median pass seconds by tenth of the window: " + " ".join(
        f"{nearest_rank(t, 0.5):.4f}" for t in tenths if t))
    cpu_s = host1 - host0
    log(f"host CPU over the window: {cpu_s:.4f} s of this process's threads,"
        f" {cpu_s / window_s:.4f} cores on average, "
        f"{1e3 * cpu_s / max(1, n_contigs * len(times)):.6f} ms a contig")
    log("median ms a pass by stage: " + " ".join(
        f"{k} {1e3 * nearest_rank([s_[k] for s_ in stats if k in s_], 0.5):.3f}"
        for k in ("pack_s", "launch_s", "sync_s", "cfinish_s", "write_s")
        if any(k in s_ for s_ in stats)))
    if alt_text is not None:
        alt_rows = alt_text.splitlines()
        groups = len({ln.split("\t", 1)[0] for ln in alt_rows})
        merged = int(ref["n_records"].sum()) - text.count("\n")
        log(f"alt PAF: {len(alt_rows)} records in {groups} groups a pass, "
            f"{merged} of them merged into their contigs")
    buckets = collections.Counter()
    for idx, _dp, V in last_rows:
        buckets[V] += len(idx)
    log("contigs a V bucket in the newest pass: " + " ".join(
        f"V {V} {n}" for V, n in sorted(buckets.items())))
    log(f"bytes this process wrote to storage: {_bytes_written()}; the "
        f"cache for (cell, seed, traffic) holds {_du(paf.parent)}")
    return result, check.lines(numbers)


def _host_cpu_s() -> float:
    """User and system CPU seconds of this process, every thread's."""
    t = os.times()
    return t.user + t.system


def _du(path: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _contig_names(text: str):
    """Contig names in file order (a contig is a run of one query name)."""
    prev = None
    for line in text.splitlines():
        name = line.split("\t", 1)[0]
        if name != prev:
            prev = name
            yield name


def _on_device(event) -> bool:
    import torch
    return event.device_type == torch.autograd.DeviceType.CUDA


def _profiler(device: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result, checks = run_cell(args.workload, args.seed % 2**64,
                                  args.seconds, bool(args.trace))
    except RunError as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in checks:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
