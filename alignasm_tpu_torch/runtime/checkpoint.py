"""Per-contig checkpoint/resume.

A copy of ``alignasm_tpu/runtime/checkpoint.py``.  Edits of the copy
(tests/test_torch_resume.py holds it to the original): import prefixes;
``solve_dataset_resumable`` takes ``device`` ("cuda" by default, "cpu"
for the plain PyTorch versions), and its device engine is ``cuda``, not
``tpu``: ``solve_missing_torch_native`` with ``src_paths``,
``solve_dataset_torch`` (the Python plane) without.  A journal pickles
the package's own record classes, so a journal written by the JAX
package and one written by the port are not interchangeable.

The reference is a one-shot batch program (SURVEY.md §5.4); here outputs
are per-contig and contigs are independent, so resume is "skip contigs
already solved".  A journal file accumulates solved results keyed by a
digest of the contig's input records — re-runs after a crash (or after
appending new contigs to the input) only solve what's missing.
"""

from __future__ import annotations

import hashlib
import os
import pickle


def contig_digest(records, cfg=None) -> str:
    """Key a contig's journal entry by EVERY input that determines its
    solve and its output bytes: all record fields (qry/ref totals feed
    src/dest edge scores; mat_num/aln_len are recomputed into output
    columns; map_qul feeds the tie-break fraction) plus a canonical
    serialization of the config (scoring knobs, --non_skip_linkable,
    alt_baseline all change the graph)."""
    import dataclasses

    h = hashlib.sha256()
    if cfg is not None:
        h.update(repr(dataclasses.astuple(cfg)).encode())
    for r in records:
        h.update(
            f"{r.qry_str},{r.qry_end},{r.ref_str},{r.ref_end},{r.ref_chr},"
            f"{r.qry_total_length},{r.ref_total_length},{r.mat_num},"
            f"{r.aln_len},{r.map_qul},{int(r.aln_fwd)},{r.original_cord}".encode()
        )
        h.update(r.cs.raw.encode())
    return h.hexdigest()


class Journal:
    """Append-only journal of solved contigs."""

    def __init__(self, path: str):
        self.path = path
        self._done: dict = {}
        good_end = 0
        if os.path.exists(path):
            with open(path, "rb") as fh:
                while True:
                    try:
                        key, value = pickle.load(fh)
                    except EOFError:
                        break
                    except Exception:
                        break  # truncated tail from a crash: drop below
                    self._done[key] = value
                    good_end = fh.tell()
        self._fh = open(path, "ab")
        # a crash mid-dump leaves a truncated record at the tail; if we
        # appended after it, every later entry would be unreachable on
        # the NEXT load (the loader stops at the corrupt record) — so
        # cut the journal back to the last whole record before appending
        if self._fh.tell() != good_end:
            self._fh.truncate(good_end)
            self._fh.seek(good_end)

    def get(self, key: str):
        return self._done.get(key)

    def put(self, key: str, value) -> None:
        pickle.dump((key, value), self._fh)
        self._fh.flush()
        self._done[key] = value

    def close(self) -> None:
        self._fh.close()

    def __len__(self) -> int:
        return len(self._done)


def solve_dataset_resumable(dataset, cfg, journal_path: str, solve_contig=None,
                            engine: str = "exact", src_paths=None,
                            chunk: int = 512, threads: int = 0,
                            device="cuda"):
    """Solve all contigs, skipping any already present in the journal.

    ``engine`` selects who solves the missing contigs:
      * ``exact``  — per-contig Python solve, journaled one by one;
      * ``native`` — the C++ engine solves missing contigs in chunks of
        ``chunk`` (requires ``src_paths=(paf, alt_or_None)``), the
        journal flushing after every chunk so a crash loses at most one
        chunk of work;
      * ``cuda``   — the batched device engine solves the missing subset
        in chunks, on ``device``.

    Returns (outs, alt_outs, max_outs, stats) where stats counts
    resumed vs solved contigs.
    """
    journal = Journal(journal_path)
    n = len(dataset.contigs)
    outs = [None] * n
    alt_outs = [None] * n
    max_outs = [None] * n
    stats = {"resumed": 0, "solved": 0}
    try:
        keys = [contig_digest(c, cfg) for c in dataset.contigs]
        missing = []
        for i, key in enumerate(keys):
            hit = journal.get(key)
            if hit is not None:
                outs[i], alt_outs[i], max_outs[i] = hit
                stats["resumed"] += 1
            else:
                missing.append(i)
        stats["solved"] = len(missing)

        def put(i, o, a, m):
            journal.put(keys[i], (o, a, m))
            outs[i], alt_outs[i], max_outs[i] = o, a, m

        if engine == "native":
            from alignasm_tpu_torch import native

            if src_paths is None:
                raise ValueError("native resume needs src_paths")
            exporter = native.GraphExporter(
                src_paths[0], alt_path=src_paths[1],
                alt_baseline=cfg.alt_baseline,
                non_skip_linkable=cfg.non_skip_linkable,
                threads=threads, max_records=0, config=cfg,
            )
            try:
                # load-bearing: a count mismatch means src_paths does
                # not describe `dataset`, and chunk indices would store
                # C++-solved contigs under the WRONG digests (silent
                # journal cross-contamination) — never an assert (which
                # vanishes under python -O)
                if len(exporter) != n:
                    raise RuntimeError(
                        f"native parse found {len(exporter)} contigs but the "
                        f"dataset has {n}: src_paths does not match dataset")
                for lo in range(0, len(missing), chunk):
                    part = missing[lo:lo + chunk]
                    exporter.solve_subset(part, threads=threads)
                    ch_o, ch_a, ch_m = exporter.fetch_results_for(part)
                    for j, i in enumerate(part):
                        put(i, ch_o[j], ch_a[j], ch_m[j])
            finally:
                exporter.close()
        elif engine == "cuda" and src_paths is not None:
            # PRODUCTION plane: one native parse, the bucket device
            # pipeline over the device-eligible missing contigs (the
            # non-eligible ones solve natively under the tunnel sync),
            # results journaled in chunk-sized slices.  A resumed
            # 50k-contig cuda run must NOT crawl on the Python plane.
            from alignasm_tpu_torch.runtime.scheduler import (
                solve_missing_torch_native,
            )

            def put_chunk(part, so, sa, sm):
                for k, i in enumerate(part):
                    put(int(i), so[k], sa[k], sm[k])

            if missing:
                # expected_n guards digest integrity: a contig-count
                # mismatch between file and dataset raises before any
                # journal write (same invariant as the native branch)
                tstats = solve_missing_torch_native(
                    cfg, src_paths, missing, put_chunk=put_chunk,
                    chunk=chunk, threads=threads, expected_n=n,
                    device=device,
                )
                stats["host_plane"] = tstats.get("host_plane", "native")
        elif engine == "cuda":
            from alignasm_tpu_torch.io.paf import PafDataset
            from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

            for lo in range(0, len(missing), chunk):
                part = missing[lo:lo + chunk]
                # records are handed to the solver uncopied, exactly as
                # the exact branch and the non-resume scheduler do —
                # solvers never mutate digest-relevant record fields
                # (they do refresh the derived ctg_sorted_index scratch
                # field, which contig_digest deliberately excludes)
                sub = PafDataset(
                    contigs=[dataset.contigs[i] for i in part],
                    ctg_names=[dataset.ctg_names[i] for i in part],
                    chr_table=dataset.chr_table, paf_map={},
                )
                so, sa, sm = solve_dataset_torch(sub, cfg, device=device)
                for k, i in enumerate(part):
                    put(i, so[k], sa[k], sm[k])
        else:
            if solve_contig is None:
                from alignasm_tpu_torch.engine.exact import solve_contig as solve_fn
            else:
                solve_fn = solve_contig
            for i in missing:
                o, a, m = solve_fn(dataset.contigs[i], cfg)
                put(i, o, a, m)
    finally:
        journal.close()
    return outs, alt_outs, max_outs, stats
