"""K-shortest walks on a DAG (Eppstein '98) over the PafDistance semiring.

Parity target: /root/reference/src/k_shortest_walks.hpp (solver) and
/root/reference/src/leftist_heap.hpp (persistent sidetrack heaps).

Own implementation notes:
  * Heap nodes live in flat arrays (index-linked, arena style); the
    persistent path-copying insert follows the classic leftist-heap
    recurrence.  Equal keys stop at the root path — required so an
    equal-key insert is not duplicated down the heap
    (leftist_heap.hpp:30).
  * The reference's best-first queue breaks Distance ties by heap-node
    *pointer* then emplace index; pointers come from a deque arena, so
    allocation order is the deterministic analogue — we use the arena
    index, which matches the reference whenever its deque blocks are
    allocated at increasing addresses (the common case; beyond that the
    reference itself is ASLR-dependent).
  * ``d[]``/``best[]`` come from a DAG shortest-path pass over the
    reversed graph with Kahn-FIFO topological order and strict
    first-improvement updates — tie-breaks identical to the reference.
"""

from __future__ import annotations

import heapq

from alignasm_tpu_torch.model import distance as D

# The reference's best-first queue breaks Distance ties by heap-node
# *pointer* before the emplace counter (k_shortest_walks.hpp:231).  With
# a monotone allocator (the oracle links one in — tests/oracle/
# bump_alloc.c), pointer order equals allocation order, which the arena
# index reproduces exactly.
def _ptr_key(idx: int) -> int:
    return idx


def topology_sort(adj):
    """Kahn's algorithm, FIFO queue seeded in vertex order
    (k_shortest_walks.hpp:132-156)."""
    n = len(adj)
    in_deg = [0] * n
    for u in range(n):
        for v, _w in adj[u]:
            in_deg[v] += 1
    from collections import deque

    q = deque(u for u in range(n) if in_deg[u] == 0)
    out = []
    while q:
        u = q.popleft()
        out.append(u)
        for v, _w in adj[u]:
            in_deg[v] -= 1
            if in_deg[v] == 0:
                q.append(v)
    if len(out) != n:
        raise RuntimeError("cycle in DAG")
    return out


def shortest_path_dag(adj, s: int, mode: int):
    """DAG single-source shortest paths (k_shortest_walks.hpp:160-175).

    Returns (d, prv) with MAX_DIST for unreachable; strict ``>``
    improvement so the first-found minimum wins ties.
    """
    n = len(adj)
    d = [D.MAX_DIST] * n
    keys = [None] * n
    prv = [-1] * n
    d[s] = D.IDENTITY
    keys[s] = D.key(D.IDENTITY, mode)
    for v in topology_sort(adj):
        if d[v] is D.MAX_DIST:
            continue
        dv, kv = d[v], keys[v]
        for to, w in adj[v]:
            nd = D.add(dv, w)
            nk = D.key(nd, mode)
            if keys[to] is None or nk < keys[to]:
                d[to] = nd
                keys[to] = nk
                prv[to] = v
    return d, prv


class NegativeCycleError(RuntimeError):
    """Raised by bellman_ford on a negative cycle; ``.cycle`` holds the
    vertex cycle (the reference returns it as the second element,
    k_shortest_walks.hpp:90-91)."""

    def __init__(self, cycle):
        super().__init__(f"negative cycle: {cycle}")
        self.cycle = cycle


def dijkstra(adj, src: int, mode: int = D.CALC_SUM):
    """Generic non-negative-weight shortest path over the distance
    semiring (k_shortest_walks.hpp:69-87).  Dead in alignasm itself —
    the solver always runs in DAG mode (paf_data.cpp:728) — but part of
    the reference's reusable L0 library, replicated for completeness.

    Returns (d, prv) with MAX_DIST for unreachable vertices; lazy-
    deletion binary heap with strict ``>`` improvement like the
    reference's min_heap loop."""
    n = len(adj)
    d = [D.MAX_DIST] * n
    keys = [None] * n
    prv = [-1] * n
    d[src] = D.IDENTITY
    keys[src] = D.key(D.IDENTITY, mode)
    heap = [(keys[src], src)]
    while heap:
        kv, v = heapq.heappop(heap)
        if kv != keys[v]:
            continue  # stale entry (lazy deletion)
        for to, w in adj[v]:
            nd = D.add(d[v], w)
            nk = D.key(nd, mode)
            if keys[to] is None or nk < keys[to]:
                d[to] = nd
                keys[to] = nk
                prv[to] = v
                heapq.heappush(heap, (nk, to))
    return d, prv


def _cycle_from_prv(prv, start: int, n: int):
    """Recover a negative cycle from predecessor links.

    ``start`` is a vertex improved in the n-th relaxation generation:
    its predecessor chain then has length >= n, so after n backward
    hops the walk sits inside the cycle; walking until the first
    repeat and closing the loop yields the cycle in forward edge order
    with first vertex == last.  Guards (a chain that reaches src would
    contradict the certificate) raise instead of wrapping Python's
    negative indexing into garbage."""
    x = start
    for _ in range(n):
        if prv[x] < 0:
            raise RuntimeError("negative-cycle certificate without a "
                               "cycle on the predecessor chain")
        x = prv[x]
    pos = {}
    back = []  # prv-chain order, i.e. reverse edge order
    while x not in pos:
        if x < 0:
            raise RuntimeError("negative-cycle certificate without a "
                               "cycle on the predecessor chain")
        pos[x] = len(back)
        back.append(x)
        x = prv[x]
    cyc = back[pos[x]:]
    cyc.reverse()
    cyc.append(cyc[0])
    return cyc


def bellman_ford(adj, src: int, mode: int = D.CALC_SUM):
    """SPFA (queue-based Bellman-Ford) with negative-cycle detection.

    Parity target: the generic shortest-path mode of the reference walk
    library (k_shortest_walks.hpp:91-129) — dead code in alignasm
    itself, which always runs the DAG pass (paf_data.cpp:728), but part
    of the reusable L0 surface.

    Generation-synchronous SPFA: ``frontier`` holds the vertices whose
    distance improved in the previous generation (membership-flag
    dedup), and the classic Bellman-Ford phase argument makes the
    cycle certificate sound — with no negative cycle every shortest
    path uses < n edges, so no distance can improve in the n-th
    generation; an n-th-generation improvement therefore certifies a
    cycle, which ``_cycle_from_prv`` extracts.  (A per-vertex
    improvement COUNT is not a sound certificate: on a DAG one vertex
    can improve up to its in-degree times per generation.)

    Returns (d, prv) with MAX_DIST for unreachable vertices; raises
    NegativeCycleError (cycle as a vertex list, first == last) where
    the reference returns {empty, cycle}."""
    n = len(adj)
    d = [D.MAX_DIST] * n
    keys = [None] * n
    prv = [-1] * n
    queued = [False] * n
    d[src] = D.IDENTITY
    keys[src] = D.key(D.IDENTITY, mode)
    frontier = [src]
    queued[src] = True
    for gen in range(1, n + 1):
        nxt = []
        for x in frontier:
            queued[x] = False
            dx = d[x]
            for to, w in adj[x]:
                nd = D.add(dx, w)
                nk = D.key(nd, mode)
                if keys[to] is None or nk < keys[to]:
                    d[to], keys[to], prv[to] = nd, nk, x
                    if gen == n:
                        raise NegativeCycleError(_cycle_from_prv(prv, to, n))
                    if not queued[to]:
                        queued[to] = True
                        nxt.append(to)
        if not nxt:
            break
        frontier = nxt
    return d, prv


class KShortestWalks:
    """Eppstein k-shortest-walks solver for one DAG."""

    def __init__(self, adj, mode: int = D.CALC_SUM):
        self.adj = adj
        self.n = len(adj)
        self.mode = mode
        # filled by solve():
        self.d = None          # distance-to-sink per vertex
        self.best = None       # next vertex on the shortest path to sink
        self.distances = []    # k emitted walk distances
        self._path_last = []   # last sidetrack arena candidate per walk
        # persistent leftist heap arena (index-linked)
        self._hk = []          # node key (reduced cost, a dist tuple)
        self._hkey = []        # sort key of _hk
        self._hu = []          # sidetrack edge (u, v)
        self._hv = []
        self._hl = []          # left child index or -1
        self._hr = []          # right child index or -1
        self._hrank = []
        # best-first search bookkeeping
        self._cand_heap = []   # arena heap-node index per emitted candidate
        self._cand_prev = []   # previous candidate index
        self._cand_dist = []   # cumulative distance of the candidate

    # --- persistent leftist heap ---------------------------------------
    def _heap_new(self, rank, k, kk, u, v, l, r) -> int:
        idx = len(self._hk)
        self._hk.append(k)
        self._hkey.append(kk)
        self._hu.append(u)
        self._hv.append(v)
        self._hl.append(l)
        self._hr.append(r)
        self._hrank.append(rank)
        return idx

    def _heap_insert(self, a: int, k, kk, u, v) -> int:
        """Path-copying insert; equal keys stay at the root path
        (leftist_heap.hpp:29-40)."""
        if a == -1 or not (self._hkey[a] < kk):
            return self._heap_new(1, k, kk, u, v, a, -1)
        l = self._hl[a]
        r = self._heap_insert(self._hr[a], k, kk, u, v)
        if l == -1 or self._hrank[l] < self._hrank[r]:
            l, r = r, l
        rank = self._hrank[r] + 1 if r != -1 else 0
        return self._heap_new(rank, self._hk[a], self._hkey[a], self._hu[a], self._hv[a], l, r)

    # --- main solve (k_shortest_walks.hpp:179-251) ---------------------
    def solve(self, source: int, sink: int, k: int):
        mode = self.mode
        n = self.n
        g_rev = [[] for _ in range(n)]
        for u in range(n):
            for v, w in self.adj[u]:
                g_rev[v].append((u, w))
        self.d, self.best = shortest_path_dag(g_rev, sink, mode)
        d, best = self.d, self.best

        if d[source] is D.MAX_DIST:
            self.distances = []
            self._path_last = []
            return []

        # children in the shortest-path tree share the parent's heap
        tree = [[] for _ in range(n)]
        for u in range(n):
            if best[u] != -1:
                tree[best[u]].append(u)

        h = [-1] * n
        identity_eq = lambda c: D.eq(c, D.IDENTITY)
        from collections import deque

        q = deque([sink])
        while q:
            u = q.popleft()
            seen_best = False
            hu = h[u]
            for v, w in self.adj[u]:
                if d[v] is D.MAX_DIST:
                    continue
                c = D.sub(D.add(w, d[v]), d[u])
                if not seen_best and v == best[u] and identity_eq(c):
                    seen_best = True  # the tree edge is skipped exactly once
                    continue
                hu = self._heap_insert(hu, c, D.key(c, mode), u, v)
            h[u] = hu
            for p in tree[u]:
                h[p] = hu
                q.append(p)

        self.distances = [d[source]]
        self._path_last = [-1]
        self._cand_heap = []
        self._cand_prev = []
        self._cand_dist = []

        if h[source] == -1:
            return self.distances

        heap: list = []
        counter = 0

        def emplace(dist, hn: int, pre: int):
            nonlocal counter
            cur = len(self._cand_heap)
            heapq.heappush(heap, (D.key(dist, mode), _ptr_key(hn), cur))
            self._cand_heap.append(hn)
            self._cand_prev.append(pre)
            self._cand_dist.append(dist)
            counter += 1

        emplace(D.add(d[source], self._hk[h[source]]), h[source], -1)
        while heap and len(self.distances) < k:
            _key, _pk, cur = heapq.heappop(heap)
            ch = self._cand_heap[cur]
            cd = self._cand_dist[cur]
            self.distances.append(cd)
            self._path_last.append(cur)
            hv = h[self._hv[ch]]
            if hv != -1:
                emplace(D.add(cd, self._hk[hv]), hv, cur)
            if self._hl[ch] != -1:
                l = self._hl[ch]
                emplace(D.add(cd, D.sub(self._hk[l], self._hk[ch])), l, self._cand_prev[cur])
            if self._hr[ch] != -1:
                r = self._hr[ch]
                emplace(D.add(cd, D.sub(self._hk[r], self._hk[ch])), r, self._cand_prev[cur])
        return self.distances

    # --- recovery (k_shortest_walks.hpp:254-290) -----------------------
    def recover(self, source: int, sink: int, k: int):
        """Rebuild the k-th walk as explicit ``(u, v, w)`` edges."""
        if k < 0 or k >= len(self._path_last):
            return []
        sidetracks = []
        cur = self._path_last[k]
        while cur != -1:
            hn = self._cand_heap[cur]
            u, v = self._hu[hn], self._hv[hn]
            w = D.sub(D.add(self._hk[hn], self.d[u]), self.d[v])
            sidetracks.append((u, v, w))
            cur = self._cand_prev[cur]
        sidetracks.reverse()

        path = []
        idx = 0
        cur = source
        while cur != sink or idx < len(sidetracks):
            if idx < len(sidetracks) and cur == sidetracks[idx][0]:
                path.append(sidetracks[idx])
                cur = sidetracks[idx][1]
                idx += 1
            else:
                nxt = self.best[cur]
                path.append((cur, nxt, D.sub(self.d[cur], self.d[nxt])))
                cur = nxt
        return path
