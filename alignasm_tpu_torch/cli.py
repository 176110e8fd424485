"""Command line of the port's device engine.

    python -m alignasm_tpu_torch.cli input.paf --engine cuda [-a ALT]
        [-b 0.5] [--non_skip_linkable] [--upgrade_mode MODE]

writes ``<input>.aln.paf``, ``<input>.aln.alt.paf`` and
``<input>.aln.all.paf``, byte-identical to ``python -m alignasm_tpu.cli``.
It runs the CUDA kernels (``--engine cuda``, the only engine, named as in
``alignasm_tpu.cli``); without a CUDA device it raises.  The device path
covers contigs of up to 8192 vertices (the default ``device_max_v``): the
reverse-topological scan up to 256, the blocked solve above; larger
contigs solve natively.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from alignasm_tpu.cli import output_paths
from alignasm_tpu.config import DEFAULT_CONFIG


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
    from alignasm_tpu import native
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
    out_p = output_paths(args.paf_loc)[0]
    try:
        solve_dataset_torch(None, cfg, src_paths=(args.paf_loc, args.alt or None),
                            write_prefix=out_p[: -len(".aln.paf")],
                            device=device)
    except native.NativeError as exc:
        print(f"alignasm_tpu_torch: {exc}", file=sys.stderr)
        return 1
    stats = solve_dataset_torch.last_stats
    if args.progress:
        print(f"device engine stats: {stats}")
    elapsed = time.perf_counter() - t0
    n_ctg = stats.get("n_contigs", 0)
    print("Write output PAF file")
    print(f"{n_ctg} contigs, {stats.get('n_records', 0)} records "
          f"in {elapsed:.2f}s ({n_ctg / elapsed:.1f} contigs/s)")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
