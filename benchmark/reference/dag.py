"""The device layer of the plain reference: each contig's DAG as the
device route sees it, whether the route takes it, and the gate rows its
dynamic program gives.

Written from the contracts the port documents, not from its code:
``native/src/export.cc`` (a contig is built when it has 2 to
``max_records`` records; vertex v sits at position n - 1 - kahn[v], kahn
the FIFO Kahn order over the reversed graph seeded in index order; a cell
holds ``q + r | a << 28``; a duplicate cell, a sum outside [0, 2^28) or an
anomaly outside [0, 3] is refused), ``runtime/scheduler.py:_eligible_mask``
(at most ``min(device_max_v, 32767)`` vertices and a path-sum bound, the
sum over vertices of the largest outgoing sum, under 2^27) and
``ops/dense.py:topo_scan`` / ``_scan_rows`` (one reverse-topological pass;
the row is ``[nxt (-1 written as dest), fast, src]`` with ``fast = cm[src]
== 1 and not (ct[src] >= 2 and a[src] != fa[src])``).

Rows here are unpadded: position p of a contig of n vertices.  In a bucket
of V >= n the program's row holds it at p + V - n, and the V - n padding
rows in front read dest (``rows_match``).
"""

from __future__ import annotations

from collections import deque

import numpy as np

INF32 = 2**30
COUNT_SAT = 10_001
ANOM_SHIFT = 28


def kahn_order(g) -> list:
    """kahn[v]: v's place in the FIFO Kahn order of the reversed graph
    (sinks first), the queue seeded in index order."""
    n = g.n_vertices
    in_deg = [len(g.adj[u]) for u in range(n)]
    rev = [[] for _ in range(n)]
    for u in range(n):
        for v, _w in g.adj[u]:
            rev[v].append(u)
    q = deque(u for u in range(n) if in_deg[u] == 0)
    kahn = [0] * n
    pos = 0
    while q:
        x = q.popleft()
        kahn[x] = pos
        pos += 1
        for to in rev[x]:
            in_deg[to] -= 1
            if in_deg[to] == 0:
                q.append(to)
    if pos != n:
        raise ValueError("cycle in contig DAG")
    return kahn


def device_edges(g):
    """(edges, ok): the contig's edges as ``(pos u, pos v, sum, anomaly)``
    in the device's numbering, and whether the export accepts them."""
    n = g.n_vertices
    kahn = kahn_order(g)
    edges, seen, ok = [], set(), True
    for u in range(n):
        pu = n - 1 - kahn[u]
        for v, w in g.adj[u]:
            s, a = w[0] + w[1], w[2]
            cell = (pu, n - 1 - kahn[v])
            if s < 0 or s >= 1 << ANOM_SHIFT or a < 0 or a > 3 or cell in seen:
                ok = False
            seen.add(cell)
            edges.append((cell[0], cell[1], s, a))
    return edges, ok, n - 1 - kahn[g.dest], n - 1 - kahn[g.src]


def path_bound(g) -> int:
    """Sum over vertices of the largest outgoing edge sum (at least 0)."""
    return sum(max([0] + [w[0] + w[1] for _v, w in row]) for row in g.adj)


def _rounder(sig_bits):
    """x -> x rounded to ``sig_bits`` significant bits, half to even (a
    float of that significand, for non-negative integers), or identity."""
    if sig_bits is None:
        return lambda x: x

    def rnd(x: int) -> int:
        drop = x.bit_length() - sig_bits
        if drop <= 0:
            return x
        q, r = divmod(x, 1 << drop)
        half = 1 << (drop - 1)
        if r > half or (r == half and q & 1):
            q += 1
        return q << drop
    return rnd


def gate_row(n: int, edges, dest: int, src: int, sig_bits=None) -> np.ndarray:
    """The gate row of one contig, length n + 2: the lowest achieving
    successor of each position (-1 written as dest), the fast flag, src.

    ``sig_bits`` rounds every path sum to that many significant bits, as a
    float of that significand would (24: float32); None is exact."""
    rnd = _rounder(sig_bits)
    out = [[] for _ in range(n)]
    for u, v, s, a in edges:
        out[u].append((v, rnd(s), a))
    s_ = [INF32] * n
    a_ = [0] * n
    fa = [INF32] * n
    ct = [0] * n
    cm = [0] * n
    nxt = [-1] * n
    s_[dest], fa[dest], ct[dest], cm[dest] = 0, 0, 1, 1
    for u in range(n - 1, -1, -1):
        if u == dest or not out[u]:
            continue
        row = out[u]
        cs = [rnd(ws + s_[v]) for v, ws, _wa in row]
        m1 = min([INF32] + cs)
        m2 = min([INF32] + [wa + a_[v] for (v, _ws, wa), c in zip(row, cs)
                            if c == m1])
        reach = m1 < INF32
        su, au = (m1, m2) if reach else (INF32, 0)
        fa[u] = min([INF32] + [wa + fa[v] for v, _ws, wa in row])
        ct[u] = min(COUNT_SAT, sum(ct[v] for v, _ws, _wa in row))
        ach = [v for (v, _ws, wa), c in zip(row, cs)
               if s_[v] < INF32 and c == su and wa + a_[v] == au]
        cm[u] = min(COUNT_SAT, sum(cm[v] for v in ach))
        nxt[u] = min(ach) if ach else -1
        s_[u], a_[u] = su, au
    fast = cm[src] == 1 and not (ct[src] >= 2 and a_[src] != fa[src])
    return np.array([dest if x < 0 else x for x in nxt] + [int(fast), src],
                    np.int32)


def rows_match(got, want, dest: int) -> bool:
    """Whether a program row of a bucket of V = len(got) - 2 vertices holds
    the unpadded reference row ``want`` of a contig whose dest sits at
    ``dest``: position p at p + V - n, the padding rows in front reading
    dest."""
    got = np.asarray(got, np.int64)
    want = np.asarray(want, np.int64)
    n, off = len(want) - 2, len(got) - len(want)
    return (off >= 0 and bool(np.all(got[:off] == dest + off))
            and np.array_equal(got[off:off + n] - off, want[:n])
            and got[off + n] == want[n] and got[off + n + 1] - off == want[n + 1])
