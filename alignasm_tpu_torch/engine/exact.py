"""Exact per-contig solver — the oracle-faithful host engine.

Parity target: ``solve_ctg_read`` (/root/reference/src/paf_data.cpp:223-1650),
live paths only (UPGRADE_MODE == ALT_PATH; the single-piece upgrade and
the unused bellman/dijkstra branches are dead code per SURVEY.md §3.2).

Pipeline per contig:
  1. sort + parts + cut points + DAG  (engine.graph)
  2. anomaly floor via Dial BFS       (engine.dial)
  3. k-shortest walks                 (engine.kshortest)
  4. best path recovery → gap-filling upgrade (QRY_SCORE re-solve) →
     vertex casework → output records
  5. coverage tie sweep → main + all outputs
  6. anomaly-tradeoff slope scan → alt output
"""

from __future__ import annotations

from alignasm_tpu_torch.config import AlignasmConfig, DEFAULT_CONFIG
from alignasm_tpu_torch.engine.dial import k_weighted_bfs
from alignasm_tpu_torch.engine.graph import ContigGraph, build_graph
from alignasm_tpu_torch.engine.kshortest import KShortestWalks, topology_sort
from alignasm_tpu_torch.model import distance as D
from alignasm_tpu_torch.model.records import PafOutput


def _internal_shortest_path_recover(
    g: ContigGraph, order, sorted_vertices, _src, _dest,
    whitelist_flag=False, whitelist=-1,
):
    """QRY_SCORE-mode DAG DP over the global topological order, with an
    optional whitelist forcing the last edge to be (*, whitelist) -> dest
    (paf_data.cpp:750-792)."""
    if _src == _dest:
        return []
    mode = D.QRY_SCORE
    dist = {_src: D.IDENTITY}
    keys = {_src: D.key(D.IDENTITY, mode)}
    pre_vertex = {_src: -1}
    for i in range(order[_src], order[_dest]):
        u = sorted_vertices[i]
        if u not in dist:
            continue
        curdist = dist[u]
        for v, w in g.adj[u]:
            if whitelist_flag and v == _dest:
                if u == g.src or u == g.dest:
                    continue
                _x, y = g.vtx_pairs[u]
                if y != whitelist:
                    continue
            nxt = D.add(curdist, w)
            nk = D.key(nxt, mode)
            if v not in dist or nk < keys[v]:
                dist[v] = nxt
                keys[v] = nk
                pre_vertex[v] = u
    if _dest not in dist:
        raise RuntimeError("internal recover: dest unreachable")
    edge_path = []
    last = _dest
    while last != _src:
        prev = pre_vertex[last]
        edge_path.append((prev, last, D.sub(dist[last], dist[prev])))
        last = prev
    edge_path.reverse()
    return edge_path


def _upgrade_edge_path(g: ContigGraph, order, sorted_vertices, path):
    """Fill best-path gaps with query-maximizing sub-paths
    (upgrade_edge_path_with_alt_path, paf_data.cpp:795-921)."""
    src, dest = g.src, g.dest
    recover = lambda s, t, wf=False, wl=-1: _internal_shortest_path_recover(
        g, order, sorted_vertices, s, t, wf, wl
    )
    edge_path = []
    i = 0
    while i < len(path):
        u, v, w = path[i]
        if u == src:
            _x, y = g.vtx_pairs[v]
            nu, nv, nw = path[i + 1]
            if nv == dest:
                alt = recover(u, nv, True, y)
                if not alt:
                    edge_path.append(path[i])
                else:
                    alt.pop()  # drop the edge into dest
                    edge_path.extend(alt)
            else:
                nx, ny = g.vtx_pairs[nv]
                if nx == ny:
                    alt = recover(u, nv, True, y)
                    if not alt:
                        edge_path.append(path[i])
                    else:
                        alt.pop()
                        edge_path.extend(alt)
                else:
                    alt = recover(u, nv, False)
                    if not alt:
                        edge_path.append(path[i])
                        edge_path.append(path[i + 1])
                    else:
                        edge_path.extend(alt)
                    i += 1  # consumed two edges
        elif v == dest:
            continuation_src = edge_path[-1][1]
            alt = recover(continuation_src, v, False)
            if alt:
                edge_path.extend(alt)
        else:
            continuation_src = edge_path[-1][1]
            x, y = g.vtx_pairs[v]
            if x != y:
                edge_path.append(path[i])
            else:
                nu, nv, nw = path[i + 1]
                if nv == dest:
                    alt = recover(continuation_src, nv, True, y)
                    if not alt:
                        edge_path.append(path[i])
                    else:
                        alt.pop()
                        edge_path.extend(alt)
                else:
                    nx, ny = g.vtx_pairs[nv]
                    if nx == ny:
                        alt = recover(continuation_src, nv, True, y)
                        if not alt:
                            edge_path.append(path[i])
                        else:
                            alt.pop()
                            edge_path.extend(alt)
                    else:
                        alt = recover(continuation_src, nv, False)
                        if not alt:
                            edge_path.append(path[i])
                            edge_path.append(path[i + 1])
                        else:
                            edge_path.extend(alt)
                        i += 1
        i += 1
    return edge_path


def _edge_path_to_outputs(g: ContigGraph, path, not_alt_map: dict,
                          cfg: AlignasmConfig = DEFAULT_CONFIG):
    """Vertex-pair casework → output records (edge_path_to_paf_path,
    paf_data.cpp:1489-1568).  ``not_alt_map`` accumulates across every
    call within a contig — paths converted later see marks from earlier
    conversions, exactly like the reference's shared hash map.
    ``cfg.upgrade_mode`` selects the reference's compile-time
    UPGRADE_MODE branch (paf_data.hpp:13-18)."""
    src, dest = g.src, g.dest
    for u, v, w in path:
        if v != dest:
            x, y = g.vtx_pairs[v]
            not_alt_map[g.recs[x].ctg_index] = True
            not_alt_map[g.recs[y].ctg_index] = True

    if cfg.upgrade_mode == "alt_path":
        order_arr, sorted_vertices = g._topo_cache
        path = _upgrade_edge_path(g, order_arr, sorted_vertices, path)

    outs: list = []
    for u, v, w in path:
        if u == src:
            x, y = g.vtx_pairs[v]
            outs.append(PafOutput.from_record(g.recs[x]))
        elif v == dest:
            pass
        else:
            x1, x2 = g.vtx_pairs[u]
            y1, y2 = g.vtx_pairs[v]
            if x1 == x2:
                if y1 == y2:
                    outs.append(PafOutput.from_record(g.recs[y1]))
                else:
                    x, y = y1, y2
                    outs.append(PafOutput.from_record(g.recs[y]))
                    px = outs[-2]
                    px.edited_qry_end, px.edited_ref_end = g.cut_pre_end[(x, y)]
                    py = outs[-1]
                    py.edited_qry_str, py.edited_ref_str = g.cut_str[(x, y)]
            else:
                if y1 == y2:
                    outs.append(PafOutput.from_record(g.recs[y2]))
                else:
                    y, z = x2, y2
                    outs.append(PafOutput.from_record(g.recs[z]))
                    py = outs[-2]
                    py.edited_qry_end, py.edited_ref_end = g.cut_pre_end[(y, z)]
                    pz = outs[-1]
                    pz.edited_qry_str, pz.edited_ref_str = g.cut_str[(y, z)]

    if cfg.upgrade_mode == "single_piece":
        from alignasm_tpu_torch.engine.singlepiece import upgrade_single_piece

        outs = upgrade_single_piece(g, cfg, outs)

    for node in outs:
        assert node.edited_qry_str <= node.edited_qry_end
        node.is_alt_path = not not_alt_map.get(node.ctg_index, False)
    return outs


def _total_coverage(outs) -> int:
    return sum(
        (o.edited_qry_end - o.edited_qry_str)
        + abs(o.edited_ref_end - o.edited_ref_str)
        for o in outs
    )


def solve_contig(records: list, cfg: AlignasmConfig = DEFAULT_CONFIG):
    """Solve one contig; returns (out, alt_out, max_out) output lists
    (solve_ctg_read, paf_data.cpp:223-1650)."""
    if len(records) == 1:
        records[0].ctg_sorted_index = 0
        return [PafOutput.from_record(records[0])], [], []

    g = build_graph(records, cfg)
    return solve_from_graph(g, cfg)


def solve_from_graph(g: ContigGraph, cfg: AlignasmConfig, anom_floor=None):
    """Steps 6-10 of solve_ctg_read on an already-built contig DAG.

    ``anom_floor`` (min possible anomaly count src->dest) may be supplied
    by a caller that already computed it — e.g. the device engine's
    batched floor DP — otherwise Dial BFS computes it here
    (paf_data.cpp:704-713)."""
    if anom_floor is None:
        anom_adj = [[(v, w[D.A]) for v, w in row] for row in g.adj]
        anom_dis, _anom_pre = k_weighted_bfs(anom_adj, g.src, cfg.max_anom + 1)
        anom_floor = anom_dis[g.dest]
    assert anom_floor != -1

    # k shortest walks (paf_data.cpp:728-730)
    solver = KShortestWalks(g.adj, D.CALC_SUM)
    k_dists = solver.solve(g.src, g.dest, cfg.max_path_count)
    assert k_dists

    # global topological order reused by the upgrade DP (paf_data.cpp:742-746)
    sorted_vertices = topology_sort(g.adj)
    order = [0] * g.n_vertices
    for i, u in enumerate(sorted_vertices):
        order[u] = i
    g._topo_cache = (order, sorted_vertices)

    not_alt_map: dict = {}
    min_distance = k_dists[0]

    # best path (paf_data.cpp:1587-1593)
    path1 = solver.recover(g.src, g.dest, 0)
    out = _edge_path_to_outputs(g, path1, not_alt_map, cfg)
    max_tot_coverage = _total_coverage(out)
    max_out: list = []

    # coverage tie sweep over the leading equal-(sum,anom) group
    # (paf_data.cpp:1595-1611)
    idx = 1
    while idx < len(k_dists) and D.eq_sum_anom(min_distance, k_dists[idx]):
        path_max = solver.recover(g.src, g.dest, idx)
        outs_max = _edge_path_to_outputs(g, path_max, not_alt_map, cfg)
        tot = _total_coverage(outs_max)
        if tot > max_tot_coverage:
            max_tot_coverage = tot
            out = outs_max
            max_out.clear()
        elif tot == max_tot_coverage:
            max_out.append(outs_max)
        idx += 1

    # anomaly-tradeoff alt path (paf_data.cpp:1613-1649)
    alt_out: list = []
    max_tot_coverage = -1
    if len(k_dists) >= 2 and min_distance[D.A] != anom_floor:
        ans_up = ans_down = 0
        ans_idx = -1
        for i in range(1, len(k_dists)):
            di = k_dists[i]
            if di[D.A] >= min_distance[D.A]:
                continue
            up = D.score_sum(di) - D.score_sum(min_distance)
            down = min_distance[D.A] - di[D.A]
            if ans_idx == -1 or up * ans_down < down * ans_up:
                ans_up, ans_down, ans_idx = up, down, i
                path2 = solver.recover(g.src, g.dest, ans_idx)
                alt_out = _edge_path_to_outputs(g, path2, not_alt_map, cfg)
                max_tot_coverage = _total_coverage(alt_out)
            elif ans_idx != -1 and D.eq_sum_anom(di, k_dists[ans_idx]):
                path2 = solver.recover(g.src, g.dest, i)
                outs2 = _edge_path_to_outputs(g, path2, not_alt_map, cfg)
                tot = _total_coverage(outs2)
                if tot > max_tot_coverage:
                    max_tot_coverage = tot
                    alt_out = outs2

    return out, alt_out, max_out


def solve_dataset(dataset, cfg: AlignasmConfig = DEFAULT_CONFIG,
                  progress=None):
    """Solve all contigs serially; returns (outs, alt_outs, max_outs).
    ``progress(done, total)`` is called after each contig (the serial
    path's progress bar, alignasm.cpp:362-397)."""
    outs, alt_outs, max_outs = [], [], []
    total = len(dataset.contigs)
    for i, contig in enumerate(dataset.contigs):
        o, a, m = solve_contig(contig, cfg)
        outs.append(o)
        alt_outs.append(a)
        max_outs.append(m)
        if progress is not None:
            progress(i + 1, total)
    return outs, alt_outs, max_outs
