"""Command line of the port: the JAX package's command line
(``alignasm_tpu/cli.py``) with the device engine on PyTorch and CUDA.

    python -m alignasm_tpu_torch.cli input.paf [--engine cuda|native|exact]
        [-t THREAD] [-a ALT] [-b 0.5] [--non_skip_linkable]
        [--upgrade_mode MODE] [--progress] [--resume JOURNAL]
        [--profile DIR]

writes ``<input>.aln.paf``, ``<input>.aln.alt.paf`` and
``<input>.aln.all.paf``, byte-identical to ``python -m alignasm_tpu.cli``.
Engines: ``cuda`` (the default, the counterpart of the JAX package's
``tpu``): the device engine with ``DEFAULT_CONFIG``'s ``"auto"`` routing,
so the port's calibrated cost model (runtime/costmodel.py) decides which
buckets go to the card; without a CUDA device it raises.  ``native``: the
C++ host plane.  ``exact``: the Python engine, in ``-t N`` worker
processes when N > 1.  When the native host plane fails (NativeError),
the cuda engine degrades visibly to the Python plane on the parsed PAF.
``--resume JOURNAL`` skips contigs already in the journal (every engine;
runtime/checkpoint.py).  ``--profile DIR`` writes a ``torch.profiler``
trace to ``DIR/trace.json``: of the cuda engine from its native route on
(the program's stage spans, ``runtime/tracing.py``, beside the card's
kernels), else of the section the JAX command line traces (the
Python-side solve of ``--resume``, the exact engine).  ``--progress``
prints the engine's stats; with ``--profile`` they include the C++ host
plane's counters, one line.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from alignasm_tpu_torch.config import DEFAULT_CONFIG


def output_paths(paf_loc: str):
    """The three output paths of ``paf_loc`` (copy of
    ``alignasm_tpu.cli.output_paths``)."""
    base = os.path.abspath(paf_loc)
    root, _ext = os.path.splitext(base)
    return root + ".aln.paf", root + ".aln.alt.paf", root + ".aln.all.paf"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "alignasm_tpu_torch", description="assembly alignment engine, "
        "device path on PyTorch and CUDA")
    p.add_argument("paf_loc", metavar="PAF_LOC", help="Location of PAF file")
    p.add_argument("-t", "--thread", type=int, default=1, metavar="THREAD",
                   help="Number of worker processes for the host engine")
    p.add_argument("-a", "--alt", metavar="PAF_ALT_LOC",
                   help="Location of alternative PAF file")
    p.add_argument("-b", "--alt_baseline", type=float, default=0.5,
                   metavar="ALT_BASELINE",
                   help="Baseline for coverage of alternative PAF file")
    p.add_argument("--non_skip_linkable", action="store_true",
                   help="Drop a->b edges when a->c->b exists")
    p.add_argument("--upgrade_mode",
                   choices=["alt_path", "single_piece", "no_update"],
                   default="alt_path", help="Path upgrade mode")
    p.add_argument("--engine", choices=["cuda", "native", "exact"],
                   default="cuda",
                   help="cuda: the device engine on the CUDA kernels "
                        "(default); native: C++ host plane; exact: Python "
                        "reference engine")
    p.add_argument("--progress", action="store_true",
                   help="print the engine's stats (exact engine: a "
                        "progress bar)")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace of the solve to "
                        "DIR/trace.json")
    p.add_argument("--resume", metavar="JOURNAL",
                   help="journal file for per-contig checkpoint/resume "
                        "(works with every --engine)")
    return p


def _progress_bar(width: int = 40):
    """In-place progress bar of the serial exact engine (copy of
    ``alignasm_tpu.cli._progress_bar``)."""
    state = {"last": -1}

    def tick(done: int, total: int) -> None:
        pct = done * 100 // max(total, 1)
        if pct == state["last"] and done != total:
            return
        state["last"] = pct
        filled = width * done // max(total, 1)
        sys.stderr.write(
            f"\r[{'#' * filled}{'-' * (width - filled)}] {pct:3d}% "
            f"({done}/{total} contigs)"
        )
        sys.stderr.flush()

    return tick


def _profiler(out_dir: str, device):
    """A started torch.profiler over the CPU, and the card when ``device``
    is CUDA."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, out_dir: str) -> None:
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def _native_counter_line(stats) -> str | None:
    """The host plane's counters in ``stats`` (present when the solve ran
    under a profiler) as one line: ms and count a slot."""
    slots = [k[len("native_"):-2] for k in stats
             if k.startswith("native_") and k.endswith("_s")
             and k[:-2] + "_n" in stats]
    if not slots:
        return None
    return "native host plane, ms (count): " + ", ".join(
        f"{s} {1e3 * stats[f'native_{s}_s']:.3f} ({stats[f'native_{s}_n']})"
        for s in slots)


def run(argv=None, device="cuda") -> int:
    """The command line on ``argv``; the cuda engine runs on ``device``
    (the command line always runs on CUDA; tests pass "cpu")."""
    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.io.paf import merge_alt_paf, read_paf, write_outputs

    args = build_arg_parser().parse_args(argv)
    if not args.paf_loc.endswith(".paf"):
        print(f"Wrong PAF file : {os.path.abspath(args.paf_loc)}",
              file=sys.stderr)
        return 1
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        alt_baseline=args.alt_baseline,
        non_skip_linkable=args.non_skip_linkable,
        upgrade_mode=args.upgrade_mode,
    )
    if args.alt and not args.alt.endswith(".paf"):
        print(f"Wrong PAF file : {os.path.abspath(args.alt)}",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    if args.engine == "native" and not args.resume:
        alt = args.alt
        if alt and os.path.getsize(alt) == 0:
            alt = None  # a zero-size alt disables the merge, as in the reference
        try:
            stats = native.run(
                args.paf_loc, alt_path=alt, alt_baseline=cfg.alt_baseline,
                non_skip_linkable=cfg.non_skip_linkable,
                threads=args.thread, config=cfg,
            )
        except native.NativeError as exc:
            print(f"alignasm_tpu_torch: {exc}", file=sys.stderr)
            return 1
        elapsed = time.perf_counter() - t0
        cps = stats["contigs"] / elapsed if elapsed else 0.0
        print(
            f"{stats['contigs']} contigs, {stats['records']} records in "
            f"{elapsed:.2f}s ({cps:.0f} contigs/s; read {stats['read_s']:.2f}s "
            f"solve {stats['solve_s']:.2f}s write {stats['write_s']:.2f}s)"
        )
        return 0

    prof = None
    if args.engine == "cuda" and not args.resume:
        from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

        out_p, _alt_p, _all_p = output_paths(args.paf_loc)
        prof = _profiler(args.profile, device) if args.profile else None
        try:
            solve_dataset_torch(
                None, cfg, src_paths=(args.paf_loc, args.alt or None),
                write_prefix=out_p[: -len(".aln.paf")], device=device)
            if prof is not None:
                _stop_profiler(prof, args.profile)
            stats = solve_dataset_torch.last_stats
            if args.progress:
                print(f"device engine stats: {stats}")
                line = _native_counter_line(stats)
                if line is not None:
                    print(line)
            elapsed = time.perf_counter() - t0
            n_ctg = stats.get("n_contigs", 0)
            print("Write output PAF file")
            print(f"{n_ctg} contigs, {stats.get('n_records', 0)} records "
                  f"in {elapsed:.2f}s ({n_ctg / elapsed:.1f} contigs/s)")
            return 0
        except native.NativeError as exc:
            print(f"native host plane unavailable ({exc}); degrading to the "
                  f"Python plane", file=sys.stderr)

    dataset = read_paf(args.paf_loc)
    if args.alt:
        merge_alt_paf(dataset, args.alt, cfg.alt_baseline)
    print("File read complete")

    if args.profile and prof is None:
        prof = _profiler(args.profile, device)

    if args.resume:
        from alignasm_tpu_torch.runtime.checkpoint import (
            solve_dataset_resumable,
        )

        outs, alt_outs, max_outs, stats = solve_dataset_resumable(
            dataset, cfg, args.resume, engine=args.engine,
            src_paths=(args.paf_loc, args.alt or None),
            threads=args.thread, device=device,
        )
        print(f"resume: {stats}")
    elif args.engine == "cuda":
        # degraded path: the native plane failed above, so the Python
        # plane solves the parsed dataset
        from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

        outs, alt_outs, max_outs = solve_dataset_torch(dataset, cfg,
                                                       device=device)
        if args.progress:
            print(f"device engine stats: {solve_dataset_torch.last_stats}")
    elif args.thread > 1:
        from alignasm_tpu_torch.runtime.parallel_host import (
            solve_dataset_parallel,
        )

        outs, alt_outs, max_outs = solve_dataset_parallel(dataset, cfg,
                                                          args.thread)
    else:
        from alignasm_tpu_torch.engine.exact import solve_dataset

        bar = _progress_bar() if args.progress else None
        outs, alt_outs, max_outs = solve_dataset(dataset, cfg, progress=bar)
        if bar is not None:
            print(file=sys.stderr)

    if prof is not None:
        _stop_profiler(prof, args.profile)

    print("Write output PAF file")
    out_p, alt_p, all_p = output_paths(args.paf_loc)
    with open(out_p, "w") as fh:
        write_outputs(dataset, outs, fh)
    with open(alt_p, "w") as fh:
        write_outputs(dataset, alt_outs, fh)
    with open(all_p, "w") as fh:
        write_outputs(dataset, max_outs, fh, name_suffix_counts=True)

    elapsed = time.perf_counter() - t0
    n_rec = sum(len(c) for c in dataset.contigs)
    print(f"{len(dataset.contigs)} contigs, {n_rec} records in {elapsed:.2f}s "
          f"({len(dataset.contigs) / elapsed:.1f} contigs/s)")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
