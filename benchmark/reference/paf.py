"""Frozen copy of ``alignasm_tpu_torch/io/paf.py`` for the benchmark's plain
reference; only its imports point into ``benchmark.reference``.

PAF reading/writing and the alt-PAF merge.

Parity targets:
  * main-PAF parse loop          src/alignasm.cpp:76-184
  * alt-PAF merge                src/alignasm.cpp:186-332
  * output writers               src/alignasm.cpp:398-490

The PAF is a headerless, tab-delimited, variable-column file.  Standard
columns 0-11; the ``cs:Z:`` tag is found by scanning optional columns.
Rows group into contigs on change of query name.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, TextIO

from benchmark.reference.cs import CS_PREFIX, clip_cs, overlap_ranges, parse_cs
from benchmark.reference.records import PafOutput, PafRecord, TYPE_ALT, TYPE_MAIN

# PAF standard column indices (paf_data.hpp:36-49)
PAF_QRY_CHR = 0
PAF_QRY_TOT = 1
PAF_QRY_STR = 2
PAF_QRY_END = 3
PAF_ALN_FWD = 4
PAF_REF_CHR = 5
PAF_REF_TOT = 6
PAF_REF_STR = 7
PAF_REF_END = 8
PAF_MAT_NUM = 9
PAF_ALN_LEN = 10
PAF_MAT_QUL = 11


class PafParseError(ValueError):
    pass


@dataclasses.dataclass
class ChrTable:
    """Interns chromosome names (chr_map / chr_rev_map, alignasm.cpp:87-93)."""

    name_to_id: dict = dataclasses.field(default_factory=dict)
    id_to_name: list = dataclasses.field(default_factory=list)

    def intern(self, name: str) -> int:
        idx = self.name_to_id.get(name)
        if idx is None:
            idx = len(self.id_to_name)
            self.name_to_id[name] = idx
            self.id_to_name.append(name)
        return idx


@dataclasses.dataclass
class PafDataset:
    """All contigs of one input PAF (+ optional merged alt records)."""

    contigs: list          # list[list[PafRecord]], outer index = contig
    ctg_names: list        # contig (query) name per outer index
    chr_table: ChrTable
    paf_map: dict          # query name -> contig outer index (latest wins)


def _find_cs_tag(fields: list[str]) -> str:
    for field in fields[PAF_MAT_QUL + 1:]:
        if field.startswith(CS_PREFIX):
            return field
    return ""


def _parse_record_fields(
    fields: list[str],
    chr_table: ChrTable,
    *,
    qry_offset: int = 0,
) -> PafRecord:
    """Parse one PAF row into a normalized PafRecord (coords closed,
    rev-strand ref swap applied, overlap ranges built)."""
    rec = PafRecord()
    rec.qry_total_length = int(fields[PAF_QRY_TOT])
    rec.qry_str = int(fields[PAF_QRY_STR]) + qry_offset
    rec.qry_end = int(fields[PAF_QRY_END]) + qry_offset - 1  # half-open -> closed
    if rec.qry_str > rec.qry_end:
        raise PafParseError("query start > end")

    rec.ref_total_length = int(fields[PAF_REF_TOT])
    rec.ref_str = int(fields[PAF_REF_STR])
    rec.ref_end = int(fields[PAF_REF_END]) - 1  # half-open -> closed
    if rec.ref_str > rec.ref_end:
        raise PafParseError("reference start > end")

    rec.ref_chr = chr_table.intern(fields[PAF_REF_CHR])
    rec.aln_fwd = fields[PAF_ALN_FWD][0] == "+"
    if not rec.aln_fwd:
        # ref coords follow increasing query coords (alignasm.cpp:156-159)
        rec.ref_str, rec.ref_end = rec.ref_end, rec.ref_str

    # the reference stores mapq through uint8_t (paf_data.hpp:65,
    # alignasm.cpp:161), as does native/src/io.cc:77 — wrap identically
    # so out-of-range mapq scores qul_nonzero the same way in every engine
    rec.map_qul = int(fields[PAF_MAT_QUL]) & 0xFF
    rec.mat_num = int(fields[PAF_MAT_NUM])
    rec.aln_len = int(fields[PAF_ALN_LEN])

    cs_tag = _find_cs_tag(fields)
    if not cs_tag:
        raise PafParseError("Missing cs:Z tag in PAF record")
    rec.cs = parse_cs(cs_tag)
    rec.qry_overlap_range, rec.ref_overlap_range = overlap_ranges(
        rec.cs, rec.aln_fwd, rec.qry_str, rec.qry_end, rec.ref_str, rec.ref_end
    )
    return rec


def read_paf(path: str | os.PathLike) -> PafDataset:
    """Read a main PAF file, grouping rows into contigs on query-name change."""
    chr_table = ChrTable()
    contigs: list[list[PafRecord]] = []
    ctg_names: list[str] = []
    paf_map: dict[str, int] = {}

    cur: list[PafRecord] = []
    cur_name: str | None = None
    paf_index = 0
    row_global_index = 0
    with open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            fields = line.split("\t")
            qry_chr = fields[PAF_QRY_CHR]
            if cur_name is None:
                cur_name = qry_chr
            if qry_chr != cur_name:
                contigs.append(cur)
                ctg_names.append(cur_name)
                cur = []
                cur_name = qry_chr
                paf_index += 1

            rec = _parse_record_fields(fields, chr_table)
            paf_map[qry_chr] = paf_index
            rec.paf_index = paf_index
            rec.ctg_index = len(cur)
            rec.original_cord = (TYPE_MAIN, row_global_index)
            cur.append(rec)
            row_global_index += 1

    if cur_name is None:
        raise PafParseError("empty PAF input")
    contigs.append(cur)
    ctg_names.append(cur_name)
    return PafDataset(contigs, ctg_names, chr_table, paf_map)


def _parse_alt_query_name(name: str) -> tuple[str, int]:
    """Split ``ctg:offset-...`` alt query names (alignasm.cpp:209-233)."""
    pos = name.find(":")
    if pos < 0:
        raise PafParseError("Invalid alt query name format")
    first = name[:pos]
    end = name.find("-", pos + 1)
    if end < 0:
        end = len(name)
    try:
        offset = int(name[pos + 1:end])
    except ValueError as exc:
        raise PafParseError("Error parsing alt query offset") from exc
    return first, offset - 1  # to 0-based


def merge_alt_paf(dataset: PafDataset, path: str | os.PathLike, alt_baseline: float) -> None:
    """Merge a re-alignment PAF into the dataset (alignasm.cpp:186-332).

    Records whose aln_len/qry_total ratio exceeds ``alt_baseline`` are
    appended to their contig with query coordinates shifted by the
    encoded offset; if no record of a (contig, offset) group passes, the
    single best-ratio record is appended instead (flush_alt_group).
    """
    if os.path.getsize(path) == 0:
        return

    tar_real_qry: str | None = None
    tar_offset = -1
    tar_flag = False
    tar_initialized = False
    tar_ratio = 0.0
    ratio_max_rec: PafRecord | None = None

    def flush_group():
        if not tar_initialized or tar_flag:
            return
        target = dataset.contigs[dataset.paf_map[tar_real_qry]]
        if ratio_max_rec is None:
            # every record in the group had aln_ratio == 0.0 (0.0 > 0.0
            # never captures); the reference would append a default-
            # constructed PafReadData here (alignasm.cpp:244-252) —
            # garbage coordinates.  Deliberate deviation (COMPONENTS.md
            # "Known deviations"): reject the degenerate input instead.
            raise PafParseError(
                "alt group has no record with positive aln_len/qry_total"
            )
        ratio_max_rec.ctg_index = len(target)
        target.append(ratio_max_rec)

    row_global_index = 0
    with open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            fields = line.split("\t")
            qry_chr = fields[PAF_QRY_CHR]
            real_qry, qry_offset = _parse_alt_query_name(qry_chr)

            ctg_last = dataset.contigs[dataset.paf_map[real_qry]][-1]
            rec = _parse_record_fields(fields, dataset.chr_table, qry_offset=qry_offset)
            rec.paf_index = ctg_last.paf_index
            rec.qry_total_length = ctg_last.qry_total_length
            rec.original_cord = (TYPE_ALT, row_global_index)

            if not tar_initialized or tar_offset != qry_offset or tar_real_qry != real_qry:
                flush_group()
                tar_initialized = True
                tar_flag = False
                tar_ratio = 0.0
                tar_offset = qry_offset
                tar_real_qry = real_qry
                ratio_max_rec = None

            aln_ratio = float(fields[PAF_ALN_LEN]) / float(fields[PAF_QRY_TOT])
            if aln_ratio > tar_ratio:
                tar_ratio = aln_ratio
                ratio_max_rec = rec

            if aln_ratio > alt_baseline:
                target = dataset.contigs[dataset.paf_map[real_qry]]
                rec.ctg_index = len(target)
                target.append(rec)
                tar_flag = True
            row_global_index += 1

    flush_group()


def _cord_to_index_string(rec: PafRecord) -> str:
    kind, row = rec.original_cord
    return "xi:Z:" + ("P_" if kind == TYPE_MAIN else "A_") + str(row)


def format_output_row(
    ctg_name: str,
    out: PafOutput,
    rec: PafRecord,
    ref_chr_name: str,
) -> list:
    """One 15-column output TSV row (alignasm.cpp:426-440)."""
    edit = clip_cs(
        rec.cs,
        rec.aln_fwd,
        rec.qry_str,
        rec.qry_end,
        rec.mat_num,
        rec.aln_len,
        out.edited_qry_str,
        out.edited_qry_end,
        out.edited_ref_str,
        out.edited_ref_end,
    )
    fields = [
        ctg_name,
        str(rec.qry_total_length),
        str(out.edited_qry_str),
        str(out.edited_qry_end + 1),
        "+" if rec.aln_fwd else "-",
        ref_chr_name,
        str(rec.ref_total_length),
        str(out.edited_ref_str if rec.aln_fwd else out.edited_ref_end),
        str((out.edited_ref_end if rec.aln_fwd else out.edited_ref_str) + 1),
        str(edit.mat_num),
        str(edit.aln_len),
        str(rec.map_qul),
        "tp:A:S" if out.is_alt_path else "tp:A:P",
        _cord_to_index_string(rec),
        edit.cs_string,
    ]
    return fields


def write_outputs(
    dataset: PafDataset,
    per_ctg_outputs: Iterable[list],
    fh: TextIO,
    *,
    name_suffix_counts: bool = False,
) -> None:
    """Write one output PAF stream.

    ``per_ctg_outputs[i]`` is a list of PafOutput (plain mode) or a list
    of lists of PafOutput (max mode, ``name_suffix_counts=True``, query
    names suffixed ``.<cnt>`` per tied path — alignasm.cpp:445-485).
    """
    id_to_name = dataset.chr_table.id_to_name
    for i, outputs in enumerate(per_ctg_outputs):
        ctg_name = dataset.ctg_names[i]
        if name_suffix_counts:
            groups = [(f"{ctg_name}.{cnt + 1}", grp) for cnt, grp in enumerate(outputs)]
        else:
            groups = [(ctg_name, outputs)]
        for name, group in groups:
            for out in group:
                rec = dataset.contigs[i][out.ctg_index]
                fields = format_output_row(name, out, rec, id_to_name[rec.ref_chr])
                fh.write("\t".join(fields))
                fh.write("\n")
