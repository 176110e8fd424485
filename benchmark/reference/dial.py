"""Frozen copy of ``alignasm_tpu_torch/engine/dial.py`` for the benchmark's plain
reference; only its imports point into ``benchmark.reference``.

Bounded-weight BFS (Dial's bucket queue).

Parity target: src/k_weighted_bfs.hpp:16-37 — shortest
paths for integer edge weights in ``[0, lim]``, O(E + V·lim).  Used on
the anomaly-weighted copy of the contig DAG to get the minimum possible
anomaly count to dest (paf_data.cpp:704-713).  Bucket order (LIFO within
a bucket) is replicated so predecessor ties resolve identically.
"""

from __future__ import annotations


def k_weighted_bfs(adj_weights, src: int, lim: int):
    """``adj_weights[u]`` is a list of ``(v, int_weight)``.

    Returns ``(dist, pre)`` lists with -1 for unreachable.
    """
    lim += 1  # weights in [0, lim)
    n = len(adj_weights)
    qs = [[] for _ in range(lim)]
    dist = [-1] * n
    pre = [-1] * n

    dist[src] = 0
    qs[0].append(src)
    d = 0
    maxd = 0
    while d <= maxd:
        q = qs[d % lim]
        while q:
            cur = q.pop()
            if dist[cur] != d:
                continue
            for nxt, cost in adj_weights[cur]:
                nd = d + cost
                if dist[nxt] != -1 and dist[nxt] <= nd:
                    continue
                dist[nxt] = nd
                pre[nxt] = cur
                qs[nd % lim].append(nxt)
                if nd > maxd:
                    maxd = nd
        d += 1
    return dist, pre
