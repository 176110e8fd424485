"""The control of ``correct``: the plain reference put in the program's
place, its path sums rounded to a float's significand, and held to the
same comparison.

    python3 -m benchmark.control --workload NAME --seeds S [S ...] \\
        [--sig-bits 24 11]

For each seed it makes the cell's corpus and alt PAF (cached as a run
caches them), computes the exact reference and, for each significand (24:
float32, the nearest precision below the configuration's exact int32; 11:
float16), the gate rows with every path sum rounded to it.  Those rows stand in
for the device's, with the count of their fast flags for the program's
``device`` count, and ``check.compare`` gives the numbers the run would
print; the files and the passes are left out (the control only decides
rows).  One JSON line a (seed, significand).  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def control_numbers(ref: dict, low: dict) -> dict:
    """``check.compare``'s row numbers with ``low``'s rows in the
    program's place."""
    from benchmark import check
    from benchmark.reference.solve import row_of

    idx = np.flatnonzero(low["eligible"])
    rows = [(np.array([i]), row_of(low, int(i))[None, :],
             len(row_of(low, int(i))) - 2) for i in idx]
    n_fast = sum(int(r[1][0, -2]) for r in rows)
    numbers = check.compare(
        dict(ref, lines={}), [""] * 3, rows, [0],
        [(n_fast, len(idx) - n_fast)])
    return {k: numbers[k] for k in ("route_gap", "rows_bad", "count_gap")}


def main(argv=None) -> int:
    import dataclasses

    from benchmark import run
    from benchmark.reference import solve
    from benchmark.reference.config import DEFAULT_CONFIG

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sig-bits", type=int, nargs="+", default=[24, 11])
    args = p.parse_args(argv)
    spec = run.load_cell(args.workload)
    cfg = dataclasses.replace(DEFAULT_CONFIG, **spec["config"]["settings"])
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    workers = os.cpu_count() or 1
    for seed in args.seeds:
        seed %= 2**64
        paf, text = run.corpus(args.workload, spec["traffic"],
                               spec["config"], seed, run.CACHE)
        _alt, alt_text = run.alt_corpus(paf, spec["traffic"], spec["config"],
                                        seed, text)
        ref = run.reference(fields, paf, text, alt_text, workers)
        for bits in args.sig_bits:
            low = solve.compute(text, cfg, workers, sig_bits=bits,
                                alt_text=alt_text)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "sig_bits": bits,
                              **control_numbers(ref, low)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
