"""The plain reference over a whole corpus, in worker processes, cached by
(cell, seed).

For every contig: its record count, whether the device route takes it
(``dag``), and then its gate row, dest position, vertex and edge counts,
and the lines the exact engine writes for it in each of the three files.
With an alt PAF, each contig's alt records are merged first, as
``paf.merge_alt_paf`` merges them over the whole corpus, so all of these
include them.  Workers are spawned
(``multiprocessing.get_context("spawn")``) and import only this package,
numpy and the standard library.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import pathlib

import numpy as np

from benchmark.reference import dag
from benchmark.reference.config import AlignasmConfig
from benchmark.reference.exact import solve_contig, solve_from_graph
from benchmark.reference.graph import build_graph
from benchmark.reference.paf import (
    PAF_ALN_LEN, PAF_QRY_CHR, PAF_QRY_TOT, ChrTable, PafParseError,
    _parse_alt_query_name, _parse_record_fields, format_output_row,
)
from benchmark.reference.records import TYPE_ALT, TYPE_MAIN

def split_contigs(text: str):
    """[(name, first row index, lines)] in file order, a contig being a run
    of rows with one query name (``paf.read_paf``'s grouping)."""
    groups, cur, name, row = [], [], None, 0
    first = 0
    for line in text.split("\n"):
        line = line.rstrip("\r")
        if not line:
            continue
        q = line.split("\t", 1)[0]
        if q != name:
            if cur:
                groups.append((name, first, cur))
            cur, name, first = [], q, row
        cur.append(line)
        row += 1
    if cur:
        groups.append((name, first, cur))
    return groups


def merge_alt(groups, alt_text: str, baseline: float) -> list:
    """Per contig of ``groups`` (``split_contigs``), the alt records
    ``paf.merge_alt_paf`` appends to it, in order, as (line, query offset,
    alt row): a name maps to its last contig, every alt line takes the next
    row, a group (a run of one contig and offset) appends each record whose
    ``aln_len / qry_total`` exceeds ``baseline`` or, where none does, the
    first of its best ratio."""
    paf_map = {name: i for i, (name, _first, _lines) in enumerate(groups)}
    merged = [[] for _ in groups]
    group, passed, best, best_ratio = None, False, None, 0.0

    def flush():
        if group is None or passed:
            return
        if best is None:
            raise PafParseError(
                "alt group has no record with positive aln_len/qry_total")
        merged[paf_map[group[0]]].append(best)

    row = 0
    for line in alt_text.split("\n"):
        line = line.rstrip("\r")
        if not line:
            continue
        fields = line.split("\t")
        real, offset = _parse_alt_query_name(fields[PAF_QRY_CHR])
        target = merged[paf_map[real]]
        if (real, offset) != group:
            flush()
            group, passed, best, best_ratio = (real, offset), False, None, 0.0
        ratio = float(fields[PAF_ALN_LEN]) / float(fields[PAF_QRY_TOT])
        if ratio > best_ratio:
            best_ratio, best = ratio, (line, offset, row)
        if ratio > baseline:
            target.append((line, offset, row))
            passed = True
        row += 1
    flush()
    return merged


def _contig_lines(name, records, chr_table, outs):
    """The three files' lines of one contig, as ``paf.write_outputs``
    writes them (the .all file's groups named ``<name>.<k>``)."""
    out, alt, max_out = outs

    def rows(label, group):
        return ["\t".join(format_output_row(
            label, o, records[o.ctg_index],
            chr_table.id_to_name[records[o.ctg_index].ref_chr]))
            for o in group]
    return (rows(name, out), rows(name, alt),
            [ln for k, grp in enumerate(max_out)
             for ln in rows(f"{name}.{k + 1}", grp)])


def _solve_group(args):
    """One worker task: a list of (contig index, name, first row, lines,
    alt records) -> per contig its device-layer facts and, unless
    ``sig_bits`` rounds the sums, its lines."""
    cfg_fields, sig_bits, items = args
    cfg = AlignasmConfig(**cfg_fields)
    max_records = max(cfg.max_device_records, min(cfg.device_max_v, 32767))
    cap = min(cfg.device_max_v, 32767)
    res = []
    for i, name, first, lines, alts in items:
        chr_table = ChrTable()
        records = []
        for k, line in enumerate(lines):
            rec = _parse_record_fields(line.split("\t"), chr_table)
            rec.paf_index = i
            rec.ctg_index = k
            rec.original_cord = (TYPE_MAIN, first + k)
            records.append(rec)
        for line, offset, row in alts:
            rec = _parse_record_fields(line.split("\t"), chr_table,
                                       qry_offset=offset)
            rec.paf_index = i
            rec.qry_total_length = records[len(lines) - 1].qry_total_length
            rec.ctg_index = len(records)
            rec.original_cord = (TYPE_ALT, row)
            records.append(rec)
        item = {"i": i, "n_records": len(records), "eligible": False}
        g = build_graph(records, cfg) if len(records) > 1 else None
        if g is not None and len(records) <= max_records:
            edges, ok, dest, src = dag.device_edges(g)
            n = g.n_vertices
            item.update(n_v=n, n_e=len(edges))
            if ok and n <= cap and dag.path_bound(g) < 2**27:
                item.update(eligible=True, dest=dest,
                            row=dag.gate_row(n, edges, dest, src, sig_bits))
        if sig_bits is None:
            outs = solve_contig(records, cfg) if g is None \
                else solve_from_graph(g, cfg)
            item["lines"] = _contig_lines(name, records, chr_table, outs)
        res.append(item)
    return res


def _tasks(groups, alts, n_tasks: int):
    """Contigs dealt into ``n_tasks`` lists of about equal cost, the
    costliest first."""
    cost = [(len(g[2]) + len(a)) ** 1.5 for g, a in zip(groups, alts)]
    order = sorted(range(len(groups)), key=lambda i: -cost[i])
    tasks = [[] for _ in range(n_tasks)]
    load = [0.0] * n_tasks
    for i in order:
        t = min(range(n_tasks), key=load.__getitem__)
        name, first, lines = groups[i]
        tasks[t].append((i, name, first, lines, alts[i]))
        load[t] += cost[i]
    return [t for t in tasks if t]


def compute(text: str, cfg: AlignasmConfig, workers: int,
            sig_bits=None, alt_text: str | None = None) -> dict:
    """The reference of one corpus (see ``save`` for its layout), with the
    alt PAF ``alt_text`` merged where given.  ``sig_bits`` rounds the gate
    rows' path sums (``dag.gate_row``) and leaves the files out: the
    control, never the reference."""
    groups = split_contigs(text)
    alts = merge_alt(groups, alt_text or "", cfg.alt_baseline)
    cfg_fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    workers = max(1, workers)
    tasks = [(cfg_fields, sig_bits, t)
             for t in _tasks(groups, alts, workers * 4)]
    if workers == 1:
        parts = [_solve_group(t) for t in tasks]
    else:
        with mp.get_context("spawn").Pool(workers) as pool:
            parts = list(pool.imap_unordered(_solve_group, tasks))
    items = sorted((it for p in parts for it in p), key=lambda it: it["i"])
    n = len(items)
    elig = np.array([it["eligible"] for it in items], bool)
    rows = [items[i]["row"] for i in np.flatnonzero(elig)]
    return {
        "names": [g[0] for g in groups],
        "n_records": np.array([it["n_records"] for it in items], np.int64),
        "n_v": np.array([it.get("n_v", 0) for it in items], np.int64),
        "n_e": np.array([it.get("n_e", 0) for it in items], np.int64),
        "eligible": elig,
        "dest": np.array([it.get("dest", -1) for it in items], np.int64),
        "row_off": np.cumsum([0] + [len(r) for r in rows]).astype(np.int64),
        "rows": np.concatenate(rows).astype(np.int32) if rows
        else np.zeros(0, np.int32),
        "lines": {groups[it["i"]][0]: it["lines"] for it in items
                  if "lines" in it},
        "n": n,
    }


def row_of(ref: dict, i: int) -> np.ndarray:
    """Contig ``i``'s reference gate row (it must be eligible)."""
    k = int(np.count_nonzero(ref["eligible"][:i]))
    return ref["rows"][ref["row_off"][k]:ref["row_off"][k + 1]]


def save(ref: dict, directory: pathlib.Path) -> None:
    """Arrays in ``ref.npz`` and names and lines in ``ref.json``, each
    written to a temporary name and renamed into place."""
    directory.mkdir(parents=True, exist_ok=True)
    arrays = {k: v for k, v in ref.items() if isinstance(v, np.ndarray)}
    tmp = directory / "ref.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, directory / "ref.npz")
    tmp = directory / "ref.json.tmp"
    tmp.write_text(json.dumps({"names": ref["names"], "lines": ref["lines"]}))
    os.replace(tmp, directory / "ref.json")


def load(directory: pathlib.Path):
    """The reference ``save`` wrote there, or None."""
    if not (directory / "ref.npz").exists() or \
            not (directory / "ref.json").exists():
        return None
    with np.load(directory / "ref.npz", allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    meta = json.loads((directory / "ref.json").read_text())
    ref["names"], ref["lines"] = meta["names"], meta["lines"]
    ref["n"] = len(ref["names"])
    return ref
