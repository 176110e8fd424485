"""Device (TPU) contig engine: batched graph solve + host finish.

Division of labor (SURVEY.md §7 phases 2-4):
  * host: graph construction (engine.graph — C++-bound later), packing
    to struct-of-arrays, path backtracking, upgrade pass, output
    casework (reusing the exact engine's oracle-faithful functions);
  * device: every relaxation — distance-to-sink with exact tie-breaks,
    anomaly floor, per-anomaly-level constrained SP, walk-count DPs —
    batched over a bucket of contigs in one jitted XLA program.

Byte-identity policy: the device path handles a contig alone only when
its solution is provably order-insensitive (no full-distance ties in
any consumed walk group, k-budget not binding, anomaly levels within
range).  Anything else routes to the exact host engine, so results are
bit-identical to the reference in ALL cases — the device is a fast
path, never an approximation.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from alignasm_tpu_torch.config import AlignasmConfig
from alignasm_tpu_torch.engine.graph import ContigGraph
from alignasm_tpu_torch.engine.kshortest import topology_sort
from alignasm_tpu_torch.engine import exact as exact_engine

_RANK_SHIFT = 26
_INF = np.int64(2**62)


@dataclasses.dataclass
class PackedGraph:
    g: ContigGraph
    eu: np.ndarray
    ev: np.ndarray
    es: np.ndarray
    ea: np.ndarray
    enz: np.ndarray
    etot: np.ndarray
    erank: np.ndarray
    edge_w: list           # full 5-tuple weight per edge (host side)


def pack_graph(g: ContigGraph) -> PackedGraph:
    """Flatten adjacency u-major (the g_rev construction order of
    k_shortest_walks.hpp:180-183) and attach the reversed-relaxation
    arrival rank used for first-improvement tie-breaks."""
    V = g.n_vertices
    eu, ev, es, ea, enz, etot, ws = [], [], [], [], [], [], []
    rev_pos: dict = {}
    rev_idx = []
    for u in range(V):
        for v, w in g.adj[u]:
            eu.append(u)
            ev.append(v)
            es.append(w[0] + w[1])
            ea.append(w[2])
            enz.append(w[3])
            etot.append(w[4])
            ws.append(w)
            k = rev_pos.get(v, 0)
            rev_pos[v] = k + 1
            rev_idx.append(k)

    # Kahn FIFO topo order of g_rev: in-degree of u in g_rev equals the
    # forward out-degree of u
    in_deg = [len(g.adj[u]) for u in range(V)]
    g_rev: list = [[] for _ in range(V)]
    for i, (u, v) in enumerate(zip(eu, ev)):
        g_rev[v].append(u)
    q = deque(u for u in range(V) if in_deg[u] == 0)
    kahn_pos = [0] * V
    pos = 0
    while q:
        x = q.popleft()
        kahn_pos[x] = pos
        pos += 1
        for to in g_rev[x]:
            in_deg[to] -= 1
            if in_deg[to] == 0:
                q.append(to)
    assert pos == V, "cycle in contig DAG"

    erank = np.fromiter(
        ((kahn_pos[v] << _RANK_SHIFT) | ri for v, ri in zip(ev, rev_idx)),
        dtype=np.int64, count=len(ev),
    )
    return PackedGraph(
        g=g,
        eu=np.asarray(eu, np.int32), ev=np.asarray(ev, np.int32),
        es=np.asarray(es, np.int64), ea=np.asarray(ea, np.int32),
        enz=np.asarray(enz, np.int32), etot=np.asarray(etot, np.int32),
        erank=erank, edge_w=ws,
    )


class Fallback(Exception):
    """Raised when a contig's solution is walk-order-sensitive and must
    be solved by the exact host engine."""


def _backtrack_achieving(pg: PackedGraph, d_s, d_a, inf):
    """Follow achieving edges src->dest: e=(u,v) with
    d[v] + w(e) == d[u] in the (sum, anom) key.  The fast path only runs
    with cnt_min == 1, which makes the achieving path UNIQUE — so no
    fraction/rank tie-breaks (and no device edge ids) are needed."""
    g = pg.g
    path = []
    u = g.src
    while u != g.dest:
        du_s = int(d_s[u]); du_a = int(d_a[u])
        for v, w in g.adj[u]:
            if (int(d_s[v]) < inf
                    and int(d_s[v]) + w[0] + w[1] == du_s
                    and int(d_a[v]) + w[2] == du_a):
                path.append((u, v, w))
                u = v
                break
        else:
            raise Fallback("no achieving edge during backtrack")
    return path


def finish_contig(pg: PackedGraph, dev, cfg: AlignasmConfig, inf=int(_INF)):
    """Reconstruct the reference's outputs from device DP results.

    ``inf`` is the kernel's unreachable sentinel (2^62 for the int64
    kernel, 2^30 for the int32 kernel).

    The device finish handles a contig alone only when its outputs are
    provably independent of the reference's walk-enumeration order:

      * a UNIQUE best (sum, anom) walk (cnt_min == 1) — the coverage
        tie sweep (paf_data.cpp:1595-1611) then sees exactly one path,
        which the achieving-edge backtrack reproduces (the lex-min tree
        path is Eppstein's first emission); and
      * NO alt scan (cnt_tot < 2 or the best path meets the anomaly
        floor), so the slope scan (paf_data.cpp:1613-1649) never runs.

    Everything else raises Fallback and is finished by an engine that
    replicates the real lazy-queue emission order.  In particular the
    fraction-descending ordering previously used for tie groups is NOT
    sound for multi-sidetrack walks: Eppstein's queue only emits in
    globally sorted order for the additive (sum, anom) components; a
    later-discovered walk whose cumulative mapq fraction beats an
    earlier-emitted one is emitted late, so within an equal-(sum, anom)
    block the emission order is heap-shape-dependent.
    """
    g = pg.g
    src = g.src
    d_s = np.asarray(dev["d_s"]); d_a = np.asarray(dev["d_a"])
    cnt_tot = int(dev["cnt_tot"][src]); cnt_min = int(dev["cnt_min"][src])
    floor_a = int(dev["floor_a"][src])

    assert d_s[src] < inf, "dest unreachable"
    min_anom = int(d_a[src])

    if cnt_min != 1:
        raise Fallback("tie group (walk-enumeration order sensitive)")
    if cnt_tot >= 2 and min_anom != floor_a:
        raise Fallback("alt scan needs walk enumeration")

    # topo cache for the upgrade pass (identical to exact engine)
    sorted_vertices = topology_sort(g.adj)
    order = [0] * g.n_vertices
    for i, u in enumerate(sorted_vertices):
        order[u] = i
    g._topo_cache = (order, sorted_vertices)

    not_alt_map: dict = {}
    path1 = _backtrack_achieving(pg, d_s, d_a, inf)
    out = exact_engine._edge_path_to_outputs(g, path1, not_alt_map, cfg)
    return out, [], []


def finish_contig_exact(pg: PackedGraph, dev, cfg: AlignasmConfig):
    """Order-sensitive finish: run the exact engine's walk enumeration
    (the real lazy-queue order, incl. deterministic-arena tie-breaks) on
    the ALREADY-BUILT graph, reusing the device's anomaly floor.  Used
    as the Fallback target when no native exporter is available."""
    floor_a = int(np.asarray(dev["floor_a"])[pg.g.src])
    return exact_engine.solve_from_graph(pg.g, cfg, anom_floor=floor_a)
