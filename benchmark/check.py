"""The comparison that decides ``correct``.

Each number is a count of disagreements with the plain reference, held to
the limit 0 (an exact comparison):

* ``files_bad``: contigs whose lines in any of the three files of the
  newest pass differ from the exact engine's, plus lines of no contig of
  the corpus;
* ``files_missing``: contigs of the corpus with no line in ``.aln.paf``;
* ``passes_unlike``: passes whose files differ in length, or whose gate
  rows differ (by CRC-32), from the newest pass's;
* ``route_gap``: contigs the device route took that the reference's
  envelope leaves out, plus the converse;
* ``rows_bad``: contigs whose gate row differs from the reference's;
* ``count_gap``: the largest gap, over the passes, between the program's
  ``device`` and ``fallback`` counts and the reference's fast and slow
  contigs of the envelope.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import dag
from benchmark.reference.solve import row_of

LIMITS = {"files_bad": 0, "files_missing": 0, "passes_unlike": 0,
          "route_gap": 0, "rows_bad": 0, "count_gap": 0}


def _by_contig(text: str, grouped: bool) -> dict:
    """Lines of one output file by contig name (the .all file's
    ``<name>.<k>`` groups under ``<name>``)."""
    out: dict = {}
    for line in text.splitlines():
        name = line.split("\t", 1)[0]
        if grouped:
            name = name.rsplit(".", 1)[0]
        out.setdefault(name, []).append(line)
    return out


def compare(ref: dict, texts, rows, pass_sigs, counts) -> dict:
    """The numbers of ``LIMITS`` for one run.

    ``texts``: the newest pass's three files; ``rows``: its (contig
    indices, rows, V) triples; ``pass_sigs``: one hashable signature a
    pass; ``counts``: each pass's (device, fallback) counts."""
    names = ref["names"]
    files = [_by_contig(t, k == 2) for k, t in enumerate(texts)]
    bad = 0
    for name, want in ref["lines"].items():
        if any(f.get(name, []) != list(w) for f, w in zip(files, want)):
            bad += 1
    bad += sum(1 for f in files for name in f if name not in ref["lines"])
    missing = sum(1 for n in names if n not in files[0])

    elig = ref["eligible"]
    taken = np.zeros(len(names), bool)
    rows_bad = 0
    for idx, dp, _V in rows:
        for i, got in zip(idx.tolist(), dp):
            if not 0 <= i < len(names) or taken[i]:
                rows_bad += 1
                continue
            taken[i] = True
            if elig[i] and not dag.rows_match(got, row_of(ref, i),
                                              int(ref["dest"][i])):
                rows_bad += 1
    route_gap = int(np.count_nonzero(taken != elig))
    n_fast = sum(int(row_of(ref, i)[-2]) for i in np.flatnonzero(elig))
    want = (n_fast, int(elig.sum()) - n_fast)
    count_gap = max((abs(d - want[0]) + abs(f - want[1]) for d, f in counts),
                    default=0)
    unlike = sum(1 for s in pass_sigs if s != pass_sigs[-1])
    return {"files_bad": bad, "files_missing": missing,
            "passes_unlike": unlike, "route_gap": route_gap,
            "rows_bad": rows_bad, "count_gap": count_gap}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def lines(numbers: dict) -> list:
    """One ``name value (limit L)`` line a number, for standard error."""
    return [f"check {k}: {numbers[k]} (limit {lim})"
            for k, lim in LIMITS.items()]

