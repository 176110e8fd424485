"""Short-form ``cs:Z:`` tag machinery, vectorized.

Behavioral parity targets in the reference:
  * ``parse_short_cs``                  /root/reference/src/paf_data.cpp:29-72
  * ``get_overlap_range``               /root/reference/src/paf_data.cpp:90-123
  * ``get_edited_paf_data`` (clipping)  /root/reference/src/paf_data.cpp:125-220

Design: a cs string decodes once into a struct-of-arrays :class:`CsOps`
(op codes, lengths, text spans).  Every consumer — match-run interval
construction, clipping, mat/aln recomputation — is then a numpy
computation over those arrays instead of an op-by-op walk.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

CS_PREFIX = "cs:Z:"

# op codes
OP_MATCH = 0  # :N    consumes N query, N reference
OP_SUB = 1    # *ab   consumes 1 query, 1 reference
OP_INS = 2    # +seq  consumes len query only
OP_DEL = 3    # -seq  consumes len reference only

_TOKEN_RE = re.compile(r":(\d+)|\*([A-Za-z]{2})|\+([A-Za-z]+)|-([A-Za-z]+)")


class CsError(ValueError):
    """Malformed cs tag (reference throws std::invalid_argument)."""


@dataclasses.dataclass
class CsOps:
    """Decoded cs tag as parallel arrays (file order)."""

    raw: str                # full tag including the cs:Z: prefix
    op: np.ndarray          # int8   op codes
    length: np.ndarray      # int64  consumed length per op
    span_start: np.ndarray  # int64  char span of each op token in ``raw``
    span_end: np.ndarray

    def __len__(self) -> int:
        return self.op.shape[0]


def parse_cs(cs_str: str) -> CsOps:
    """Decode a short-form cs tag, validating as strictly as the reference."""
    if not cs_str.startswith(CS_PREFIX):
        raise CsError("PAF record does not contain a short-form cs:Z tag")

    ops: list[int] = []
    lengths: list[int] = []
    starts: list[int] = []
    ends: list[int] = []
    pos = len(CS_PREFIX)
    n = len(cs_str)
    while pos < n:
        m = _TOKEN_RE.match(cs_str, pos)
        if m is None:
            raise CsError(f"Unsupported operation in short-form cs tag at {pos}")
        if m.group(1) is not None:
            length = int(m.group(1))
            if length <= 0:
                raise CsError("Invalid :length operation in cs tag")
            ops.append(OP_MATCH)
        elif m.group(2) is not None:
            length = 1
            ops.append(OP_SUB)
        elif m.group(3) is not None:
            length = len(m.group(3))
            ops.append(OP_INS)
        else:
            length = len(m.group(4))
            ops.append(OP_DEL)
        lengths.append(length)
        starts.append(pos)
        ends.append(m.end())
        pos = m.end()

    return CsOps(
        raw=cs_str,
        op=np.asarray(ops, dtype=np.int8),
        length=np.asarray(lengths, dtype=np.int64),
        span_start=np.asarray(starts, dtype=np.int64),
        span_end=np.asarray(ends, dtype=np.int64),
    )


def _query_oriented(ops: CsOps, aln_fwd: bool):
    """Op/length arrays in query orientation (reversed file order for '-')."""
    if aln_fwd:
        return ops.op, ops.length, np.arange(len(ops))
    sel = np.arange(len(ops) - 1, -1, -1)
    return ops.op[sel], ops.length[sel], sel


def _consumption(op: np.ndarray, length: np.ndarray):
    """Per-op (query, reference) base consumption."""
    qry = np.where((op == OP_MATCH) | (op == OP_INS), length, 0)
    qry = np.where(op == OP_SUB, 1, qry)
    ref = np.where((op == OP_MATCH) | (op == OP_DEL), length, 0)
    ref = np.where(op == OP_SUB, 1, ref)
    return qry, ref


def overlap_ranges(
    ops: CsOps,
    aln_fwd: bool,
    qry_str: int,
    qry_end: int,
    ref_str: int,
    ref_end: int,
):
    """Match-run closed intervals in query orientation.

    Returns ``(qry_ranges, ref_ranges)`` as ``(m, 2)`` int64 arrays: for
    every ``:N`` run, the closed query interval and the corresponding
    (strand-directed) reference interval.  Mirrors get_overlap_range
    (paf_data.cpp:90-123) including the consumption validation.
    """
    op, length, _ = _query_oriented(ops, aln_fwd)
    ref_step = 1 if aln_fwd else -1
    qry_cons, ref_cons = _consumption(op, length)

    qry_start = qry_str + np.concatenate(([0], np.cumsum(qry_cons)[:-1]))
    ref_start = ref_str + ref_step * np.concatenate(([0], np.cumsum(ref_cons)[:-1]))

    final_qry = qry_str + int(qry_cons.sum())
    final_ref = ref_str + ref_step * int(ref_cons.sum())
    if final_qry != qry_end + 1 or final_ref != ref_end + ref_step:
        raise CsError("cs tag consumption does not match PAF coordinates")

    is_match = op == OP_MATCH
    mlen = length[is_match]
    qs = qry_start[is_match]
    rs = ref_start[is_match]
    qry_ranges = np.stack([qs, qs + mlen - 1], axis=1)
    ref_ranges = np.stack([rs, rs + (mlen - 1) * ref_step], axis=1)
    return qry_ranges, ref_ranges


@dataclasses.dataclass
class ClippedCs:
    cs_string: str
    mat_num: int
    aln_len: int
    is_cut: bool


def clip_cs(
    ops: CsOps,
    aln_fwd: bool,
    qry_str: int,
    qry_end: int,
    mat_num: int,
    aln_len: int,
    edited_qry_str: int,
    edited_qry_end: int,
    edited_ref_str: int,
    edited_ref_end: int,
) -> ClippedCs:
    """Rebuild the cs tag restricted to a retained query range.

    Parity with get_edited_paf_data (paf_data.cpp:125-220): a ``:`` run is
    trimmed to the retained overlap; an insertion must lie fully inside
    the retained range (cut-inside-insertion is an error); a substitution
    is kept iff its query base is retained; a deletion at the left cut
    boundary is dropped (kept only when ``edited_qry_str < qry_index``);
    op order re-reverses for reverse-strand records; base counts are
    validated against the edited coordinates.
    """
    assert qry_str <= edited_qry_str <= edited_qry_end <= qry_end

    if edited_qry_str == qry_str and edited_qry_end == qry_end:
        return ClippedCs(ops.raw, mat_num, aln_len, False)

    op, length, file_idx = _query_oriented(ops, aln_fwd)
    qry_cons, _ = _consumption(op, length)
    q0 = qry_str + np.concatenate(([0], np.cumsum(qry_cons)[:-1]))  # op query start

    eqs, eqe = edited_qry_str, edited_qry_end

    # ---- retention masks per op class ----
    is_match = op == OP_MATCH
    is_sub = op == OP_SUB
    is_ins = op == OP_INS
    is_del = op == OP_DEL
    q_last = q0 + np.where(is_del, 0, np.maximum(qry_cons, 1)) - 1  # last query base

    m_start = np.maximum(q0, eqs)
    m_end = np.minimum(q0 + length - 1, eqe)
    keep_match = is_match & (m_start <= m_end)

    ins_overlap = is_ins & (q0 <= eqe) & (eqs <= q0 + length - 1)
    bad_ins = ins_overlap & ((q0 < eqs) | (eqe < q0 + length - 1))
    if bool(bad_ins.any()):
        raise CsError("Alignment was clipped inside a cs insertion")

    keep_sub = is_sub & (eqs <= q0) & (q0 <= eqe)
    keep_del = is_del & (eqs < q0) & (q0 <= eqe)

    keep = keep_match | ins_overlap | keep_sub | keep_del
    kept = np.nonzero(keep)[0]

    # lengths of kept ops (match runs may shrink at either cut boundary)
    out_len = np.where(keep_match, m_end - m_start + 1, length)[kept]
    out_op = op[kept]
    out_file_idx = file_idx[kept]

    # re-reverse into file orientation for the output string
    if not aln_fwd:
        out_op = out_op[::-1]
        out_len = out_len[::-1]
        out_file_idx = out_file_idx[::-1]

    pieces = [CS_PREFIX]
    raw = ops.raw
    ss, se = ops.span_start, ops.span_end
    for o, ln, fi in zip(out_op, out_len, out_file_idx):
        if o == OP_MATCH:
            pieces.append(":" + str(int(ln)))
        else:
            pieces.append(raw[ss[fi]:se[fi]])
    out_str = "".join(pieces)

    new_mat = int(out_len[out_op == OP_MATCH].sum())
    new_aln = int(out_len.sum())
    query_bases = int(out_len[(out_op == OP_MATCH) | (out_op == OP_SUB) | (out_op == OP_INS)].sum())
    ref_bases = int(out_len[(out_op == OP_MATCH) | (out_op == OP_SUB) | (out_op == OP_DEL)].sum())

    if query_bases != eqe - eqs + 1 or ref_bases != abs(edited_ref_end - edited_ref_str) + 1:
        raise CsError("Edited cs tag does not match edited PAF coordinates")

    return ClippedCs(out_str, new_mat, new_aln, True)
