"""Frozen copy of ``alignasm_tpu_torch/engine/graph.py`` for the benchmark's plain
reference; its imports point into ``benchmark.reference`` and one
docstring word differs (``edge_score``'s).

Per-contig alignment DAG construction.

Parity targets in the reference's ``solve_ctg_read``:
  * sort + parts partition        src/paf_data.cpp:232-262
  * pairwise cut points           src/paf_data.cpp:265-378
  * vertex set                    src/paf_data.cpp:281-372
  * linkable / get_score          src/paf_data.cpp:422-521
  * make_Graph (edge order!)      src/paf_data.cpp:531-696

Design departures from the reference:
  * cut points are stored sparsely (dict keyed by overlap pair) instead
    of three dense n×n matrices — removes the 512 GB-class memory wall
    for 10k-record contigs by construction (SURVEY.md §7 hard part 5);
  * edge insertion order is nevertheless replicated exactly, because
    first-improvement tie-breaking in every downstream relaxation
    depends on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.config import AlignasmConfig
from benchmark.reference.introsort import libstdcxx_sort
from benchmark.reference.records import PafRecord, qry_partial_overlap


@dataclasses.dataclass
class Vertex:
    """An internal vertex: a record (i==j) or a cut overlap pair (i<j).

    Mirrors Internal_Vertex (paf_data.cpp:392-411): ``qry_str/ref_str``
    come from the cut table, ``qry_end/ref_end`` from record ``cur``.
    """

    pre: int
    cur: int
    qry_str: int
    qry_end: int
    ref_str: int
    ref_end: int

    @property
    def is_one(self) -> bool:
        return self.pre == self.cur


@dataclasses.dataclass
class ContigGraph:
    n: int                       # record count
    recs: list                   # sorted records (by qry_str, qry_end)
    part_idx: np.ndarray         # part id per sorted record
    parts: list                  # part start offsets + sentinel n
    cut_pre_end: dict            # (i,j) -> (qry, ref) new end of record i
    cut_str: dict                # (i,j) -> (qry, ref) new start of record j
    cut_overlap_idx: dict        # (i,j) -> (p_i, p_j) match-run indices
    vtx_pairs: list              # vertex id -> (i, j)
    vtx_index: dict              # (i, j) -> vertex id
    adj: list                    # adjacency: adj[u] = [(v, dist), ...] in insertion order
    src: int
    dest: int

    @property
    def n_vertices(self) -> int:
        return len(self.adj)


def edge_score(cfg, a, b, lft_qry_end, lft_ref_end, lft_ref_str,
               rht_qry_str, rht_ref_str, rht_ref_end):
    """Gap / inversion / translocation scoring between two internal
    vertices (get_score, paf_data.cpp:449-521).  ``a``/``b`` are the
    lft/rht records (chr, strand, mapq); the coordinate arguments are
    the (possibly edited) internal-vertex coords.  Module-level so the
    single-piece upgrade can score candidate splices with exactly the
    graph construction's arithmetic."""
    ref_neg = cfg.ref_negative_penalty

    def ref_abs(x: int) -> int:
        return -x * ref_neg if x < 0 else x

    qry_diff = rht_qry_str - lft_qry_end - 1
    assert qry_diff >= 0
    anom = 0
    if a.ref_chr == b.ref_chr and a.aln_fwd == b.aln_fwd:
        signed_gap = (
            rht_ref_str - (lft_ref_end + 1)
            if a.aln_fwd
            else lft_ref_end - (rht_ref_str + 1)
        )
        ref_diff = ref_abs(signed_gap)
        if ref_diff > cfg.sv_baseline:
            anom += 1
            ref_diff = cfg.sv_baseline
    elif a.ref_chr == b.ref_chr:
        anom += 1
        ref_diff = cfg.sv_inv_penalty
        if a.aln_fwd:
            ref_diff += ref_abs(rht_ref_end - (lft_ref_end + 1))
        else:
            ref_diff += ref_abs(rht_ref_str - (lft_ref_str + 1))
        if ref_diff > cfg.sv_baseline:
            anom += 1
            ref_diff = cfg.sv_baseline
    else:
        anom += 1
        ref_diff = cfg.sv_trans_penalty
    return (
        qry_diff * cfg.qry_weight,
        ref_diff * cfg.ref_weight,
        anom,
        1 if b.map_qul else 0,
        1,
    )


def sort_records(records: list) -> list:
    """Sort by (qry_str, qry_end) with libstdc++-exact std::sort element
    movement — ties between duplicate alignments must land in the same
    order as the reference (paf_data.cpp:241-245); writes
    ctg_sorted_index back into the original records."""
    order = list(records)
    libstdcxx_sort(order, lambda a, b: a.sort_key() < b.sort_key())
    for i, rec in enumerate(order):
        records[rec.ctg_index].ctg_sorted_index = i
    return order


def partition_parts(recs: list):
    """Maximal runs of query-overlapping records (paf_data.cpp:248-262)."""
    parts = []
    part_idx = np.empty(len(recs), dtype=np.int64)
    part_end = -1
    for idx, rec in enumerate(recs):
        if part_end < rec.qry_str:
            parts.append(idx)
        part_idx[idx] = len(parts) - 1
        part_end = max(rec.qry_end, part_end)
    parts.append(len(recs))
    return parts, part_idx


def _pair_cut(pre: PafRecord, cur: PafRecord):
    """Two-pointer sweep over the match-run intervals of a partially
    overlapping pair (paf_data.cpp:294-378).

    Returns ``(pre_end, str_, overlap_idx)`` or None when the pair
    cannot be connected: cut at the first interval collision, else at
    the minimum inter-interval gap.
    """
    pq = pre.qry_overlap_range
    pr = pre.ref_overlap_range
    cq = cur.qry_overlap_range
    cr = cur.ref_overlap_range
    pre_len = pq.shape[0]
    cur_len = cq.shape[0]
    step = 1 if cur.aln_fwd else -1
    step_pre = 1 if pre.aln_fwd else -1

    min_gap = -1
    min_gap_idx = (-1, -1)
    p_i = p_j = 0
    while p_i < pre_len and p_j < cur_len:
        l_i, r_i = int(pq[p_i, 0]), int(pq[p_i, 1])
        l_j, r_j = int(cq[p_j, 0]), int(cq[p_j, 1])
        if l_i == l_j:
            if l_j == r_j:
                p_j += 1
                continue
            pre_end = (l_i, int(pr[p_i, 0]))
            str_ = (l_j + 1, int(cr[p_j, 0]) + step)
            return pre_end, str_, (p_i, p_j)
        if l_i < l_j:
            if l_j <= r_i + 1:
                pre_end = (l_j - 1, int(pr[p_i, 0]) + (l_j - 1 - l_i) * step_pre)
                str_ = (l_j, int(cr[p_j, 0]))
                return pre_end, str_, (p_i, p_j)
            gap = l_j - (r_i + 1)
            if min_gap == -1 or gap < min_gap:
                min_gap = gap
                min_gap_idx = (p_i, p_j)
            p_i += 1
        else:
            if l_i <= r_j - 1:
                pre_end = (l_i, int(pr[p_i, 0]))
                str_ = (l_i + 1, int(cr[p_j, 0]) + (l_i + 1 - l_j) * step)
                return pre_end, str_, (p_i, p_j)
            p_j += 1

    if min_gap == -1:
        return None
    p_i, p_j = min_gap_idx
    l_i, r_i = int(pq[p_i, 0]), int(pq[p_i, 1])
    l_j = int(cq[p_j, 0])
    pre_end = (r_i, int(pr[p_i, 0]) + (r_i - l_i) * step_pre)
    str_ = (l_j, int(cr[p_j, 0]))
    return pre_end, str_, (p_i, p_j)


def build_graph(records: list, cfg: AlignasmConfig) -> ContigGraph:
    """Full graph construction for one contig (records already parsed)."""
    recs = sort_records(records)
    n = len(recs)
    parts, part_idx = partition_parts(recs)

    cut_pre_end: dict = {}
    cut_str: dict = {}
    cut_overlap_idx: dict = {}
    vtx_pairs: list = []
    vtx_index: dict = {}

    # (i,i) vertices first — ids equal record index (paf_data.cpp:286-291)
    for i in range(n):
        vtx_index[(i, i)] = len(vtx_pairs)
        vtx_pairs.append((i, i))
        cut_str[(i, i)] = (recs[i].qry_str, recs[i].ref_str)
        cut_overlap_idx[(i, i)] = (0, 0)

    # overlap-pair vertices in discovery order (paf_data.cpp:294-378)
    for i in range(n):
        pre = recs[i]
        for j in range(i + 1, n):
            cur = recs[j]
            if pre.qry_end < cur.qry_str:
                break
            if qry_partial_overlap(pre, cur):
                res = _pair_cut(pre, cur)
                if res is None:
                    raise RuntimeError(
                        f"overlapping records {i},{j} cannot be connected"
                    )
                cut_pre_end[(i, j)], cut_str[(i, j)], cut_overlap_idx[(i, j)] = res
                vtx_index[(i, j)] = len(vtx_pairs)
                vtx_pairs.append((i, j))

    src = len(vtx_pairs)
    dest = src + 1
    n_vertices = dest + 1
    adj: list = [[] for _ in range(n_vertices)]

    def make_vertex(i: int, j: int) -> Vertex:
        qs, rs = cut_str[(i, j)]
        return Vertex(i, j, qs, recs[j].qry_end, rs, recs[j].ref_end)

    def linkable(lft: Vertex, rht: Vertex) -> bool:
        # default-vertex branch of the reference's linkable (paf_data.cpp:422-444)
        if (lft.pre, lft.cur) not in vtx_index or (rht.pre, rht.cur) not in vtx_index:
            return False
        if not rht.is_one:
            if lft.cur != rht.pre:
                return False
            return lft.qry_str < rht.qry_str
        if part_idx[lft.cur] + 1 == part_idx[rht.cur]:
            return True
        if part_idx[lft.cur] != part_idx[rht.cur]:
            return False
        return lft.qry_end < rht.qry_str

    def get_score(lft: Vertex, rht: Vertex):
        lft_qry_end, lft_ref_end = lft.qry_end, lft.ref_end
        if not rht.is_one:
            lft_qry_end, lft_ref_end = cut_pre_end[(rht.pre, rht.cur)]
        return edge_score(
            cfg, recs[lft.cur], recs[rht.cur],
            lft_qry_end, lft_ref_end, lft.ref_str,
            rht.qry_str, rht.ref_str, rht.ref_end,
        )

    non_skip = cfg.non_skip_linkable
    INF = float("inf")

    # --- src -> first part (paf_data.cpp:540-563) ---
    l, r = parts[0], parts[1]
    min_qry_end = INF
    for i in range(l, r):
        if non_skip:
            if min_qry_end < recs[i].qry_str:
                break
            min_qry_end = min(min_qry_end, recs[i].qry_end)
        dist = (
            recs[i].qry_str * cfg.sv_front_end_coefficient,
            0,
            0,
            1 if recs[i].map_qul else 0,
            1,
        )
        adj[src].append((vtx_index[(i, i)], dist))

    # --- last part (+ (j,i) vertices) -> dest (paf_data.cpp:564-595) ---
    l, r = parts[-2], parts[-1]
    max_qry_str = recs[r - 1].qry_str
    for i in range(r - 1, l - 1, -1):
        if non_skip and recs[i].qry_end < max_qry_str:
            continue
        dist = (
            (recs[i].qry_total_length - recs[i].qry_end - 1)
            * cfg.sv_front_end_coefficient,
            0,
            0,
            0,
            0,
        )
        adj[vtx_index[(i, i)]].append((dest, dist))
        for j in range(i - 1, -1, -1):
            if recs[j].qry_contains(recs[i]):
                continue
            if recs[j].qry_end >= recs[i].qry_str and (j, i) in vtx_index:
                adj[vtx_index[(j, i)]].append((dest, dist))

    # --- intra-part edges (paf_data.cpp:598-651) ---
    for block in range(len(parts) - 1):
        l, r = parts[block], parts[block + 1]
        for i in range(l, r):
            min_qry_end_after_ii = INF
            for j in range(i + 1, r):
                if recs[i].qry_contains(recs[j]):
                    continue
                if non_skip:
                    if min_qry_end_after_ii < recs[j].qry_str:
                        break
                    if recs[i].qry_end < recs[j].qry_str:
                        min_qry_end_after_ii = min(
                            min_qry_end_after_ii, recs[j].qry_end
                        )
                if recs[i].qry_end < recs[j].qry_str:
                    # no overlap: (i,i) -> (j,j)
                    iv_ii = make_vertex(i, i)
                    iv_jj = make_vertex(j, j)
                    if linkable(iv_ii, iv_jj):
                        adj[vtx_index[(i, i)]].append(
                            (vtx_index[(j, j)], get_score(iv_ii, iv_jj))
                        )
                else:
                    # (i,i) -> (i,j)
                    if (i, j) in vtx_index:
                        iv_ii = make_vertex(i, i)
                        iv_ij = make_vertex(i, j)
                        if linkable(iv_ii, iv_ij):
                            adj[vtx_index[(i, i)]].append(
                                (vtx_index[(i, j)], get_score(iv_ii, iv_ij))
                            )
                        min_qry_end_after_ij = INF
                        for k in range(j + 1, r):
                            if non_skip:
                                if min_qry_end_after_ij < recs[k].qry_str:
                                    break
                                if recs[j].qry_end < recs[k].qry_str:
                                    min_qry_end_after_ij = min(
                                        min_qry_end_after_ij, recs[k].qry_end
                                    )
                            iv_kk = make_vertex(k, k)
                            if linkable(iv_ij, iv_kk):
                                adj[vtx_index[(i, j)]].append(
                                    (vtx_index[(k, k)], get_score(iv_ij, iv_kk))
                                )
                            if (j, k) in vtx_index:
                                iv_jk = make_vertex(j, k)
                                if linkable(iv_ij, iv_jk):
                                    adj[vtx_index[(i, j)]].append(
                                        (vtx_index[(j, k)], get_score(iv_ij, iv_jk))
                                    )

    # --- part b -> part b+1 edges (paf_data.cpp:653-695) ---
    for block in range(len(parts) - 2):
        l, r = parts[block], parts[block + 1]
        l2, r2 = parts[block + 1], parts[block + 2]
        for i in range(l, r):
            iv_ii = make_vertex(i, i)
            min_qry_end_after_ii = INF
            for k in range(l2, r2):
                if non_skip:
                    if min_qry_end_after_ii < recs[k].qry_str:
                        break
                    if recs[i].qry_end < recs[k].qry_str:
                        min_qry_end_after_ii = min(min_qry_end_after_ii, recs[k].qry_end)
                iv_kk = make_vertex(k, k)
                if linkable(iv_ii, iv_kk):
                    adj[vtx_index[(i, i)]].append(
                        (vtx_index[(k, k)], get_score(iv_ii, iv_kk))
                    )
            for j in range(i + 1, r):
                if recs[i].qry_contains(recs[j]):
                    continue
                if recs[i].qry_end < recs[j].qry_str:
                    break
                if (i, j) not in vtx_index:
                    continue
                iv_ij = make_vertex(i, j)
                min_qry_end_after_ij = INF
                for k in range(l2, r2):
                    if non_skip:
                        if min_qry_end_after_ij < recs[k].qry_str:
                            break
                        if recs[j].qry_end < recs[k].qry_str:
                            min_qry_end_after_ij = min(
                                min_qry_end_after_ij, recs[k].qry_end
                            )
                    iv_kk = make_vertex(k, k)
                    if linkable(iv_ij, iv_kk):
                        adj[vtx_index[(i, j)]].append(
                            (vtx_index[(k, k)], get_score(iv_ij, iv_kk))
                        )

    return ContigGraph(
        n=n,
        recs=recs,
        part_idx=part_idx,
        parts=parts,
        cut_pre_end=cut_pre_end,
        cut_str=cut_str,
        cut_overlap_idx=cut_overlap_idx,
        vtx_pairs=vtx_pairs,
        vtx_index=vtx_index,
        adj=adj,
        src=src,
        dest=dest,
    )
