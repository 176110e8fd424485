"""Command line of the port's device engine.

    python -m alignasm_tpu_torch.cli input.paf --engine cuda [-a ALT]
        [-b 0.5] [--non_skip_linkable] [--upgrade_mode MODE]

writes ``<input>.aln.paf``, ``<input>.aln.alt.paf`` and
``<input>.aln.all.paf``, byte-identical to ``python -m alignasm_tpu.cli``.
It runs the CUDA kernels (``--engine cuda``, the only engine, named as in
``alignasm_tpu.cli``); without a CUDA device it raises.  The native plane
covers contigs of up to 8192 vertices on the device (the default
``device_max_v``): the reverse-topological scan up to 256, the blocked
solve above; larger contigs solve natively.  When the native host plane
fails (NativeError), the command degrades visibly to the Python plane
on the parsed PAF, as ``alignasm_tpu.cli`` does.
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
    p.add_argument("--engine", choices=["cuda"], default="cuda",
                   help="cuda: the CUDA kernels")
    p.add_argument("--progress", action="store_true",
                   help="print the engine's stats")
    return p


def run(argv=None, device="cuda") -> int:
    """The command line on ``argv``, its engine on ``device`` (the command
    line always runs on CUDA)."""
    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.io.paf import merge_alt_paf, read_paf, write_outputs
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    args = build_arg_parser().parse_args(argv)
    for path in (args.paf_loc, args.alt):
        if path and not path.endswith(".paf"):
            print(f"Wrong PAF file : {path}", file=sys.stderr)
            return 1
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        alt_baseline=args.alt_baseline,
        non_skip_linkable=args.non_skip_linkable,
        upgrade_mode=args.upgrade_mode,
        device_routing="always",
    )
    t0 = time.perf_counter()
    out_p, alt_p, all_p = output_paths(args.paf_loc)
    try:
        solve_dataset_torch(None, cfg, src_paths=(args.paf_loc, args.alt or None),
                            write_prefix=out_p[: -len(".aln.paf")],
                            device=device)
        stats = solve_dataset_torch.last_stats
        n_ctg, n_rec = stats.get("n_contigs", 0), stats.get("n_records", 0)
    except native.NativeError as exc:
        print(f"native host plane unavailable ({exc}); degrading to the "
              f"Python plane", file=sys.stderr)
        dataset = read_paf(args.paf_loc)
        if args.alt:
            merge_alt_paf(dataset, args.alt, cfg.alt_baseline)
        outs, alt_outs, max_outs = solve_dataset_torch(dataset, cfg,
                                                       device=device)
        stats = solve_dataset_torch.last_stats
        stats["native_error"] = str(exc)[:500]
        with open(out_p, "w") as fh:
            write_outputs(dataset, outs, fh)
        with open(alt_p, "w") as fh:
            write_outputs(dataset, alt_outs, fh)
        with open(all_p, "w") as fh:
            write_outputs(dataset, max_outs, fh, name_suffix_counts=True)
        n_ctg = len(dataset.contigs)
        n_rec = sum(len(c) for c in dataset.contigs)
    if args.progress:
        print(f"device engine stats: {stats}")
    elapsed = time.perf_counter() - t0
    print("Write output PAF file")
    print(f"{n_ctg} contigs, {n_rec} records "
          f"in {elapsed:.2f}s ({n_ctg / elapsed:.1f} contigs/s)")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
