"""SINGLE_PIECE upgrade mode — gap filling with one covering piece.

Parity target: ``upgrade_paf_path_with_single_piece``
(/root/reference/src/paf_data.cpp:932-1486) plus its PQVec sweep-line
candidate set (priority_queue_vector.hpp) — the reference's third
upgrade mode, selectable there only by recompiling UPGRADE_MODE
(paf_data.hpp:13-18); here a runtime config value
(``AlignasmConfig.upgrade_mode == "single_piece"``), byte-validated
against a reference build with the constant flipped
(tests/oracle/Makefile ``single`` target).

Semantics: walk the converted output path left to right; for every
query gap of length >= 2 (before the first node, between consecutive
nodes, after the last node up to the contig's global [qry_min, qry_max]
envelope), consider every sweep-line candidate record that STARTED at
or before the gap's left edge and reaches its right edge, splice the
best-scoring candidate in (clipping neighbors at match-run
boundaries), first-in-heap-array-order winning score ties — hence the
libstdc++-exact PQVec replica (engine/pqvec.py).

Sweep-line quirks preserved exactly:
  * the candidate heap and the sorted-record cursor persist ACROSS
    gaps — a record popped for one gap (qry_end < r) never returns,
    and a record skipped at insert time (qry_end < that gap's r) is
    never reconsidered for later gaps;
  * candidate iteration order is the RAW heap array, not sorted order.
"""

from __future__ import annotations

from alignasm_tpu_torch.engine.graph import edge_score
from alignasm_tpu_torch.engine.pqvec import PQVec
from alignasm_tpu_torch.model import distance as D
from alignasm_tpu_torch.model.records import PafOutput


def _sweep_l(ldata, pre_qry_str, data, range_idx):
    """Two-pointer l-boundary search (paf_data.cpp:1166-1223): find the
    first match-run collision between ``ldata``'s runs (clipped below at
    ``pre_qry_str``) and candidate ``data``'s runs from ``range_idx``.
    Returns (pre_end, str_, range_idx) or (None, None, range_idx)."""
    lq = ldata.qry_overlap_range
    lr = ldata.ref_overlap_range
    cq = data.qry_overlap_range
    cr = data.ref_overlap_range
    step_pre = 1 if ldata.aln_fwd else -1
    step = 1 if data.aln_fwd else -1
    p = 0
    while p < lq.shape[0] and range_idx < cq.shape[0]:
        if int(lq[p, 1]) < pre_qry_str:
            p += 1
            continue
        l_i, r_i = int(lq[p, 0]), int(lq[p, 1])
        l_j, r_j = int(cq[range_idx, 0]), int(cq[range_idx, 1])
        if l_i < pre_qry_str:
            l_i = pre_qry_str
        if l_i == l_j:
            if l_j == r_j:
                range_idx += 1
                continue
            pre_end = (l_i, int(lr[p, 0]) + (l_i - int(lq[p, 0])) * step_pre)
            str_ = (l_j + 1, int(cr[range_idx, 0]) + step)
            return pre_end, str_, range_idx
        if l_i < l_j:
            if l_j <= r_i + 1:
                pre_end = (l_j - 1,
                           int(lr[p, 0]) + (l_j - 1 - int(lq[p, 0])) * step_pre)
                str_ = (l_j, int(cr[range_idx, 0]))
                return pre_end, str_, range_idx
            p += 1
        else:
            if l_i <= r_j - 1:
                pre_end = (l_i,
                           int(lr[p, 0]) + (l_i - int(lq[p, 0])) * step_pre)
                str_ = (l_i + 1, int(cr[range_idx, 0]) + (l_i + 1 - l_j) * step)
                return pre_end, str_, range_idx
            range_idx += 1
    return None, None, range_idx


def _sweep_r(data, range_idx, rdata, cur_qry_end):
    """Two-pointer r-boundary search (paf_data.cpp:1011-1062): collision
    between candidate ``data``'s runs from ``range_idx`` and ``rdata``'s
    runs clipped above at ``cur_qry_end``."""
    cq = data.qry_overlap_range
    cr = data.ref_overlap_range
    rq = rdata.qry_overlap_range
    rr = rdata.ref_overlap_range
    step_pre = 1 if data.aln_fwd else -1
    step = 1 if rdata.aln_fwd else -1
    p = 0
    while p < rq.shape[0] and range_idx < cq.shape[0]:
        if int(rq[p, 0]) > cur_qry_end:
            break
        l_i, r_i = int(cq[range_idx, 0]), int(cq[range_idx, 1])
        l_j, r_j = int(rq[p, 0]), int(rq[p, 1])
        if r_j > cur_qry_end:
            r_j = cur_qry_end
        if l_i == l_j:
            if l_j == r_j:
                range_idx += 1
                continue
            pre_end = (l_i, int(cr[range_idx, 0]))
            str_ = (l_j + 1, int(rr[p, 0]) + step)
            return pre_end, str_
        if l_i < l_j:
            if l_j <= r_i + 1:
                pre_end = (l_j - 1,
                           int(cr[range_idx, 0]) + (l_j - 1 - l_i) * step_pre)
                str_ = (l_j, int(rr[p, 0]))
                return pre_end, str_
            range_idx += 1
        else:
            if l_i <= r_j - 1:
                pre_end = (l_i, int(cr[range_idx, 0]))
                str_ = (l_i + 1, int(rr[p, 0]) + (l_i + 1 - l_j) * step)
                return pre_end, str_
            p += 1
    return None, None


def _run_containing(runs, x):
    """lower_bound((x+1, -1)) then prev — the match-run containing x, or
    -1 (paf_data.cpp:995-998).  Run starts are sorted and run bounds are
    non-negative, so the tuple lower_bound equals a searchsorted on the
    start column — O(log n), no per-probe list materialization (this
    sits inside the per-gap x per-candidate sweep loops)."""
    import numpy as np

    idx = int(np.searchsorted(runs[:, 0], x + 1, side="left"))
    if idx > 0 and int(runs[idx - 1, 1]) >= x:
        return idx - 1
    return -1


def upgrade_single_piece(g, cfg, paf_path):
    """The reference lambda, on a converted output path (list of
    PafOutput).  ``g`` provides the sorted records; original records
    resolve through ctg_index."""
    recs = g.recs                       # sorted order
    orig = {r.ctg_index: r for r in recs}
    if not paf_path:
        return paf_path

    qry_min = min(r.qry_str for r in recs)
    qry_max = max(r.qry_end for r in recs)

    pq = PQVec()
    state = {"it": 0}
    out: list = []

    def advance(l, r):
        while not pq.empty() and pq.top()[0] < r:
            pq.pop()
        while state["it"] < len(recs) and recs[state["it"]].qry_str <= l:
            if recs[state["it"]].qry_end >= r:
                pq.push((recs[state["it"]].qry_end, state["it"]))
            state["it"] += 1

    def node(cur_idx, qs, qe, rs, re):
        o = PafOutput.from_record(recs[cur_idx])
        o.edited_qry_str = qs
        o.edited_qry_end = qe
        o.edited_ref_str = rs
        o.edited_ref_end = re
        return o

    def score(a_idx, b_idx, lqe, lre, lrs, rqs, rrs, rre):
        return edge_score(cfg, recs[a_idx], recs[b_idx],
                          lqe, lre, lrs, rqs, rrs, rre)

    # ---- first node (paf_data.cpp:943-1095) --------------------------
    cur = paf_path[0]
    l, r = qry_min, cur.edited_qry_str - 1
    if l >= r:
        out.append(cur)
    else:
        advance(l, r)
        if pq.empty():
            out.append(cur)
        else:
            rdata = orig[cur.ctg_index]
            r_sorted = rdata.ctg_sorted_index
            best_key = None
            ans = None
            for _end, si in pq.vector():
                data = recs[si]
                # l boundary: the candidate starts exactly at qry_min
                iv_qs, iv_rs = data.qry_str, data.ref_str
                # r boundary
                ri = _run_containing(data.qry_overlap_range, r)
                if ri >= 0:
                    step = 1 if data.aln_fwd else -1
                    iv_qe = r
                    iv_re = (int(data.ref_overlap_range[ri, 0])
                             + (r - int(data.qry_overlap_range[ri, 0])) * step)
                    ivr = (cur.edited_qry_str, cur.edited_ref_str)
                else:
                    pre_end, str_ = _sweep_r(data, 0, rdata, cur.edited_qry_end)
                    if pre_end is None:
                        continue
                    iv_qe, iv_re = pre_end
                    ivr = str_
                sc = score(si, r_sorted, iv_qe, iv_re, iv_rs,
                           ivr[0], ivr[1], cur.edited_ref_end)
                key = D.key(sc, D.CALC_SUM)
                if best_key is None or key < best_key:
                    best_key = key
                    ans = (si, iv_qs, iv_qe, iv_rs, iv_re, ivr)
            if ans is None:
                out.append(cur)
            else:
                si, iv_qs, iv_qe, iv_rs, iv_re, ivr = ans
                out.append(node(si, iv_qs, iv_qe, iv_rs, iv_re))
                out.append(node(orig[cur.ctg_index].ctg_sorted_index,
                                ivr[0], cur.edited_qry_end,
                                ivr[1], cur.edited_ref_end))

    # ---- main nodes (paf_data.cpp:1096-1336) -------------------------
    for i in range(1, len(paf_path)):
        pre = out[-1]
        cur = paf_path[i]
        l, r = pre.edited_qry_end + 1, cur.edited_qry_str - 1
        if l >= r:
            out.append(cur)
            continue
        advance(l, r)
        if pq.empty():
            out.append(cur)
            continue
        ldata = orig[pre.ctg_index]
        rdata = orig[cur.ctg_index]
        best_key = None
        ans = None
        for _end, si in pq.vector():
            data = recs[si]
            # l boundary
            li = _run_containing(data.qry_overlap_range, l)
            if li >= 0:
                step = 1 if data.aln_fwd else -1
                ivl = (pre.edited_qry_end, pre.edited_ref_end)
                iv_qs = l
                iv_rs = (int(data.ref_overlap_range[li, 0])
                         + (l - int(data.qry_overlap_range[li, 0])) * step)
                range_idx = li
            else:
                pre_end, str_, range_idx = _sweep_l(
                    ldata, pre.edited_qry_str, data, 0)
                if pre_end is None:
                    continue
                ivl = pre_end
                iv_qs, iv_rs = str_
            # r boundary
            ri = _run_containing(data.qry_overlap_range, r)
            if ri >= 0:
                step = 1 if data.aln_fwd else -1
                iv_qe = r
                iv_re = (int(data.ref_overlap_range[ri, 0])
                         + (r - int(data.qry_overlap_range[ri, 0])) * step)
                ivr = (cur.edited_qry_str, cur.edited_ref_str)
            else:
                pre_end, str_ = _sweep_r(data, range_idx, rdata,
                                         cur.edited_qry_end)
                if pre_end is None:
                    continue
                iv_qe, iv_re = pre_end
                ivr = str_
            sc = D.add(
                score(ldata.ctg_sorted_index, si,
                      ivl[0], ivl[1], pre.edited_ref_str,
                      iv_qs, iv_rs, iv_re),
                score(si, rdata.ctg_sorted_index,
                      iv_qe, iv_re, iv_rs,
                      ivr[0], ivr[1], cur.edited_ref_end),
            )
            key = D.key(sc, D.CALC_SUM)
            if best_key is None or key < best_key:
                best_key = key
                ans = (si, ivl, iv_qs, iv_qe, iv_rs, iv_re, ivr)
        if ans is None:
            out.append(cur)
        else:
            si, ivl, iv_qs, iv_qe, iv_rs, iv_re, ivr = ans
            out.pop()
            out.append(node(ldata.ctg_sorted_index,
                            pre.edited_qry_str, ivl[0],
                            pre.edited_ref_str, ivl[1]))
            out.append(node(si, iv_qs, iv_qe, iv_rs, iv_re))
            out.append(node(rdata.ctg_sorted_index,
                            ivr[0], cur.edited_qry_end,
                            ivr[1], cur.edited_ref_end))

    # ---- last node (paf_data.cpp:1337-1481) --------------------------
    pre = out[-1]
    l, r = pre.edited_qry_end + 1, qry_max
    if l < r:
        advance(l, r)
        if not pq.empty():
            ldata = orig[pre.ctg_index]
            best_key = None
            ans = None
            for _end, si in pq.vector():
                data = recs[si]
                li = _run_containing(data.qry_overlap_range, l)
                if li >= 0:
                    step = 1 if data.aln_fwd else -1
                    ivl = (pre.edited_qry_end, pre.edited_ref_end)
                    iv_qs = l
                    iv_rs = (int(data.ref_overlap_range[li, 0])
                             + (l - int(data.qry_overlap_range[li, 0])) * step)
                else:
                    pre_end, str_, _ri = _sweep_l(
                        ldata, pre.edited_qry_str, data, 0)
                    if pre_end is None:
                        continue
                    ivl = pre_end
                    iv_qs, iv_rs = str_
                # r boundary: the candidate ends exactly at qry_max
                iv_qe, iv_re = data.qry_end, data.ref_end
                sc = score(ldata.ctg_sorted_index, si,
                           ivl[0], ivl[1], pre.edited_ref_str,
                           iv_qs, iv_rs, iv_re)
                key = D.key(sc, D.CALC_SUM)
                if best_key is None or key < best_key:
                    best_key = key
                    ans = (si, ivl, iv_qs, iv_qe, iv_rs, iv_re)
            if ans is not None:
                si, ivl, iv_qs, iv_qe, iv_rs, iv_re = ans
                out.pop()
                out.append(node(ldata.ctg_sorted_index,
                                pre.edited_qry_str, ivl[0],
                                pre.edited_ref_str, ivl[1]))
                out.append(node(si, iv_qs, iv_qe, iv_rs, iv_re))

    return out
