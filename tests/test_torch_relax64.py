"""The int64 relaxation of the port's Python plane on the CPU against the
JAX package.

``solve_graph_batch_plain`` (ops/relax.py) is held bit for bit to the
JAX ``solve_graph_batch`` on the real int64 buckets of a query-sparse
corpus (every contig's path sums may pass int32, so ``python_buckets``
makes int64 buckets only, each with its ``topo_hint`` rows); the Python
plane end to end on that corpus to ``solve_dataset_tpu(dataset, cfg)``;
an emulation of csrc/relax64.cu to both: its Jacobi branch (a CSR of the
valid edges in any order within a vertex, invalid edges folded into a
per-vertex flag, the winner as the lowest edge index) and its checked
pass (the hint's checks, each vertex's change history replayed in
reverse hint order, the one-pass fold of the three minima, the floor and
counts from the successors' final values, the history pool's capacity,
and the flag that sends a contig to the branch); and the wrapper's
argument checks.  Every value is an integer: the tolerance is 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alignasm_tpu.config import DEFAULT_CONFIG as JCFG
from alignasm_tpu.io.paf import read_paf as jread_paf
from alignasm_tpu.ops.relax import solve_graph_batch as jsolve_graph_batch
from alignasm_tpu.runtime.scheduler import solve_dataset_tpu
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.io.paf import read_paf
from alignasm_tpu_torch.ops import cuda_relax64, relax
from alignasm_tpu_torch.runtime import scheduler
from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch
from alignasm_tpu_torch.testing.synth import generate_paf
from tests.test_torch_kernels import _ladder_edges

KEYS = ("eu", "ev", "es", "ea", "enz", "etot", "erank", "evalid", "src",
        "dest")
INF = 2**62


def query_sparse(text, shift=4_000_000, grow=800_000_000):
    """A PAF whose contigs' alignments lie sparse along a long query: the
    k-th record of each contig moves k * ``shift`` along the query, and
    every query grows by ``grow``.  The query gaps between records (which
    ``edge_score`` charges uncapped) and the dest edge's distance to the
    query's end then push every contig's path-sum bound past 2^29, as on
    a chromosome-scale scaffold of a large genome with sparse
    alignments (the same transform as chip_smoke.py's querysparse2000)."""
    out, seen = [], {}
    for line in text.splitlines():
        f = line.split("\t")
        k = seen.get(f[0], 0)
        seen[f[0]] = k + 1
        f[1] = str(int(f[1]) + grow)
        f[2] = str(int(f[2]) + k * shift)
        f[3] = str(int(f[3]) + k * shift)
        out.append("\t".join(f))
    return "\n".join(out) + "\n"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    paf = tmp_path_factory.mktemp("qs") / "querysparse12.paf"
    paf.write_text(query_sparse(generate_paf(
        n_contigs=12, seed=9, max_records_per_contig=60)))
    return paf


@pytest.fixture(scope="module")
def buckets(corpus):
    stats = dict(singleton=0, oversize=0)
    _res, packed = scheduler.pack_dataset(read_paf(corpus), DEFAULT_CONFIG,
                                          stats)
    out = scheduler.python_buckets(packed, DEFAULT_CONFIG)
    assert out and {b["kind"] for b in out} == {"sparse64"}
    return out


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)  # a JAX dict comes back key-sorted
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, k)


@pytest.mark.parametrize("full", [True, False])
def test_plain_matches_jax_on_querysparse_buckets(buckets, full):
    """The plain version bit-equals the JAX function on the corpus's real
    int64 buckets, converged (the bucket's n_sweeps) and cut at 2
    sweeps: every key, dtype and value."""
    for bk in buckets:
        ns = bk["n_sweeps"] if full else 2
        want = jsolve_graph_batch(*bk["args"][:-1], V=bk["V"], n_sweeps=ns)
        got = relax.solve_graph_batch_plain(*_t(bk["args"][:-1]), V=bk["V"],
                                            n_sweeps=ns)
        _assert_equal({k: v.numpy() for k, v in got.items()},
                      {k: np.asarray(v) for k, v in want.items()})
        if full:
            assert int(got["d_s"][:, 0].min()) >= 2**29  # past _fits32


def test_python_plane_int64_route_matches_jax(corpus):
    """solve_dataset_torch(dataset, cfg) on the CPU takes the int64 route
    for every bucket, with no monkeypatch, and equals
    solve_dataset_tpu(dataset, cfg): results and counts."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    jcfg = dataclasses.replace(JCFG, device_routing="always")
    got = solve_dataset_torch(read_paf(corpus), cfg, device="cpu")
    stats = solve_dataset_torch.last_stats
    want = solve_dataset_tpu(jread_paf(corpus), jcfg)
    jstats = solve_dataset_tpu.last_stats
    assert repr(got) == repr(want)  # dataclass reprs name no module
    assert stats["dense_buckets"] == stats["int32_buckets"] == 0
    assert stats["device"] == 12
    for key in ("device", "fallback", "singleton", "oversize", "dense_buckets",
                "int32_buckets", "fallback_reasons"):
        assert stats[key] == jstats[key], (key, stats, jstats)


def _u(x):
    return np.asarray(x, np.int64).astype(np.uint64)


def _add(x, y):
    return (_u(x) + _u(y)).astype(np.int64)  # two's complement, as int64


def _pack(s, a):
    return ((_u(s) << np.uint64(16)) | _u(a)).astype(np.int64)


def _qul(nz, tot):
    num = (_u(nz) << np.uint64(30)).astype(np.int64)
    return _add(1 << 30, -(num // np.where(tot == 0, 1, tot)))


def _seg_fold(vals, seg, init):
    out = init.copy()
    np.minimum.at(out, seg, vals)
    return out


def _emulate_contig(eu, ev, es, ea, enz, etot, erank, evalid, dest, V, ns,
                    rng, dist=None):
    """One contig as csrc/relax64.cu's Jacobi branch computes it: the
    valid edges in a CSR by eu, shuffled within each vertex (the kernel's
    atomics fix no order), a vertex that an invalid edge leaves starts its
    minima at INF instead of segment_min's identity, the winner is the
    lowest edge index among the reached edges whose erank equals m3.  With
    ``dist`` (the pass's distance outputs) it runs only the floor and the
    counts, from that distance."""
    slots = np.flatnonzero(evalid)
    slots = slots[np.lexsort((rng.random(len(slots)), eu[slots]))]
    seg, v = eu[slots], ev[slots]
    e_s, e_a, e_nz, e_tot, e_rk = (x[slots] for x in (es, ea, enz, etot,
                                                        erank))
    ident = np.full(V, np.iinfo(np.int64).max)
    ident[eu[~evalid]] = INF
    on_dest = np.arange(V) == dest
    st = [np.where(on_dest, 0, INF), np.zeros(V, np.int64),
          np.zeros(V, np.int64), np.zeros(V, np.int64),
          np.where(on_dest, -1, INF), np.full(V, -1, np.int64)]
    for _ in range(0 if dist else ns):
        s, a, nz, tot, rank, eid = st
        ok = s[v] < INF
        cs, ca = _add(s[v], e_s), _add(a[v], e_a)
        cnz, ctot = _add(nz[v], e_nz), _add(tot[v], e_tot)
        k1 = np.where(ok, _pack(cs, ca), INF)
        m1 = _seg_fold(k1, seg, ident)
        on1 = ok & (k1 == m1[seg])
        k2 = _qul(cnz, ctot)
        m2 = _seg_fold(np.where(on1, k2, INF), seg, ident)
        on2 = on1 & (k2 == m2[seg])
        m3 = _seg_fold(np.where(on2, e_rk, INF), seg, ident)
        cur1 = np.where(s < INF, _pack(s, a), INF)
        cur2 = _qul(nz, tot)
        better = (m1 < cur1) | ((m1 == cur1) & ((m2 < cur2) | (
            (m2 == cur2) & (m3 < rank))))
        win = np.full(V, len(eu))  # lowest edge index among the winners
        cand = ok & (e_rk == m3[seg]) & better[seg]
        np.minimum.at(win, seg[cand], slots[cand])
        got = win < len(eu)
        order = np.argsort(slots)  # the winners' CSR positions
        w = order[np.searchsorted(slots[order], win[got])]
        new = [x.copy() for x in st]
        for x, c in zip(new, (cs, ca, cnz, ctot, e_rk, slots)):
            x[got] = c[w]
        if all(np.array_equal(x, y) for x, y in zip(new, st)):
            break
        st = new
    if dist:
        st = [dist[k] for k in ("d_s", "d_a", "d_nz", "d_tot")] + [
            None, dist["d_eid"]]
    s, a = st[0], st[1]

    def loop(init, step):
        x = init
        for _ in range(ns):
            y = step(x)
            if np.array_equal(x, y):
                break
            x = y
        return x

    fa = loop(np.where(on_dest, 0, INF), lambda f: np.minimum(f, _seg_fold(
        np.where(f[v] < INF, _add(f[v], e_a), INF), seg, ident)))
    du = np.where(s < INF, _pack(s, a), INF)
    ach = (s[v] < INF) & (_pack(_add(s[v], e_s), _add(a[v], e_a)) == du[seg])

    def counts(mask):
        def step(c):
            tot_ = np.zeros(V, np.int64)
            np.add.at(tot_, seg[mask], c[v[mask]])
            return np.minimum(on_dest.astype(np.int64) + tot_, 10_001)
        return loop(on_dest.astype(np.int64), step)

    return dict(d_s=s, d_a=a, d_nz=st[2], d_tot=st[3],
                d_eid=st[5].astype(np.int32), floor_a=fa,
                cnt_tot=counts(np.ones(len(slots), bool)), cnt_min=counts(ach))


def _emulate(args, V, ns, seed=0):
    rng = np.random.default_rng(seed)
    eu, ev, es, ea, enz, etot, erank, evalid, _src, dest = args
    per = [_emulate_contig(eu[b], ev[b], es[b], ea[b], enz[b], etot[b],
                           erank[b], evalid[b], dest[b], V, ns, rng)
           for b in range(len(eu))]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


I64_MAX = int(np.iinfo(np.int64).max)
COUNT_SAT = 10_001


def _w(x):
    """A Python int wrapped to int64, as the kernel's uint64_t sums."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def _pk(s, a):
    return _w((s << 16) | (a & ((1 << 64) - 1)))


def _qk(nz, tot):
    num = _w(nz << 30)
    d = tot if tot else 1
    q = _w(-num) if d == -1 else num // d  # floor division
    return _w((1 << 30) - q)


class _Fold:
    """csrc/relax64.cu's one-pass fold of a row's edges into the three
    literal minima: m1 over every edge (INF for an unreached one), m2 over
    the m1-achievers, m3 over the m2-achievers, each seeded with the
    vertex's identity (INF when an invalid edge leaves it, else
    segment_min's INT64_MAX), in any edge order.  The least k2 among the
    m1-achievers is kept as its (nz, tot) and divided out only when a
    comparison needs it; a key whose nz is in [0, 2^33) and whose tot is
    positive is known to lie below INF without dividing."""

    def __init__(self, ident):
        self.ident = self.m1 = ident
        self.seen = self.x1 = self.any1 = self.y1 = False
        self.a1 = self.b1 = I64_MAX
        self.anz = self.atot = 0
        self.aval = True

    def a1_value(self):
        if not self.aval:
            self.a1, self.aval = _qk(self.anz, self.atot), True
        return self.a1

    def take(self, nz, tot, r):
        self.anz, self.atot, self.aval, self.b1 = nz, tot, False, r

    def push(self, ok, k1, nz, tot, r):
        c1 = k1 if ok else INF
        if c1 < self.m1:  # the edges before are off m1 now
            self.x1 = self.seen or not ok
            self.m1, self.any1, self.y1 = c1, ok, False
            if ok:
                self.take(nz, tot, r)
            else:
                self.a1 = self.b1 = I64_MAX
                self.aval = True
        elif c1 == self.m1 and ok:
            if not self.any1:
                self.any1 = True
                self.take(nz, tot, r)
            else:
                k2, a = _qk(nz, tot), self.a1_value()
                if k2 < a:
                    self.y1 = True
                    self.take(nz, tot, r)
                    self.a1, self.aval = k2, True
                elif k2 == a:
                    self.b1 = min(self.b1, r)
                else:
                    self.y1 = True
        else:
            self.x1 = True
        self.seen = True

    def floor2(self):
        return min(self.ident, INF if self.x1 else I64_MAX)

    def mins(self):
        """(m1, m3); m2 from ``m2_value``, only where the row needs it."""
        if not self.seen:
            return self.ident, self.ident
        below = not self.aval and 0 <= self.anz < 2**33 and self.atot > 0
        if self.any1 and (below or self.a1_value() <= self.floor2()):
            m3 = min(self.ident, INF if self.x1 or self.y1 else I64_MAX,
                     self.b1)
        else:
            m3 = min(self.ident, INF)
        return self.m1, m3

    def m2_value(self):
        if not self.seen:
            return self.ident
        return min(self.floor2(), self.a1_value() if self.any1 else I64_MAX)


def _payload_min(rows_u, got, erank, ident, m1, m2, m3):
    """The edge-sharded program's winner at a row (csrc/shard_relax.cu's
    rule): each payload field the minimum over the row's edges of the
    field for a winner (reached, k1 == m1, k2 == m2, erank == m3) and INF
    for any other edge, an invalid edge of the row included (its identity
    is then INF); taken, with rank m3, only below INF.  None: no update."""
    wins = [e for e in rows_u if got[e][0] and erank[e] == m3
            and _pk(got[e][1]["s"], got[e][1]["a"]) == m1
            and _qk(got[e][1]["nz"], got[e][1]["tot"]) == m2]
    new = {k: min(got[e][1][k] for e in wins) if wins else I64_MAX
           for k in ("s", "a", "nz", "tot")}
    if ident == INF or len(wins) < len(rows_u):
        new = {k: min(v, INF) for k, v in new.items()}
    if not wins or new["s"] >= INF:
        return None
    return dict(new, rank=m3, eid=-1)


def _pass_contig(eu, ev, es, ea, enz, etot, erank, evalid, dest, V, ns,
                 order, cap, rng, shard=False):
    """One contig as csrc/relax64.cu's checked pass computes it.  Returns
    (flag, outputs): flag 0 when every check holds (the outputs are the
    pass's), 1 when (a) the hint, (c) the depth (a longest path under 3/4
    of the rows) or (d) the history pool fails (the Jacobi branch solves
    the whole contig), 2 when only (b) the longest path exceeds ``ns``
    (the distance outputs are the pass's, the branch runs the floor and
    the counts).  ``shard``: csrc/shard_relax.cu's pass, which runs the
    same replay with the edge-sharded program's winner (``_payload_min``),
    makes no check (c) and computes the distance alone: flag 0 with the
    outputs d_s, d_a, d_nz, d_tot, or 1 when (a) or (d) fails."""
    eu, ev, es, ea, enz, etot, erank = (
        [int(x) for x in arr] for arr in (eu, ev, es, ea, enz, etot, erank))
    order = list(range(V)) if order is None else [int(x) for x in order]
    if sorted(order) != list(range(V)):
        return 1, None                                   # (a) permutation
    pos = {v: t for t, v in enumerate(order)}
    ident = [I64_MAX] * V
    rows = [[] for _ in range(V)]
    for e, ok in enumerate(evalid):
        u, v = eu[e], ev[e]
        if not ok:
            if 0 <= u < V:
                ident[u] = INF
        elif not (0 <= u < V and 0 <= v < V):
            return 1, None                                # (a) in range
        else:
            rows[u].append(e)
    for r in rows:
        rng.shuffle(r)  # the CSR's order within a row is the atomics'
    ready = dict(pos)
    if not rows[dest]:
        ready[dest] = V  # dest's row holds no edge: its state never moves
    if any(ready[ev[e]] <= pos[u] for u in range(V) for e in rows[u]):
        return 1, None                                    # (a) topological
    L = [0] * V
    for u in reversed(order):
        L[u] = max((L[ev[e]] + 1 for e in rows[u]), default=0)
    if not shard and 4 * max(L) < 3 * sum(map(bool, rows)):
        return 1, None                                    # (c) the depth

    def init(v):
        d = v == dest
        return dict(s=0 if d else INF, a=0, nz=0, tot=0,
                    rank=-1 if d else INF, eid=-1)

    hist = [[] for _ in range(V)]  # (time, state) of each visible change
    used = 0
    fa, ct, cm = [INF] * V, [0] * V, [0] * V
    fa[dest], ct[dest], cm[dest] = 0, 1, 1
    final = [init(v) for v in range(V)]

    def at(v, t):
        """v's state after t sweeps and the next sweep it changes at."""
        cur = init(v)
        for tm, st in hist[v]:
            if tm > t:
                return cur, tm
            cur = st
        return cur, None

    def cand(e, sv):
        return dict(s=_w(sv["s"] + es[e]), a=_w(sv["a"] + ea[e]),
                    nz=_w(sv["nz"] + enz[e]), tot=_w(sv["tot"] + etot[e]))

    for u in reversed(order):
        if not rows[u]:
            continue
        # before the first sweep after a successor is reached no candidate
        # is, and the row keeps its initial state: the kernel starts there
        reached = [0 if init(ev[e])["s"] < INF else
                   next((tm for tm, st in hist[ev[e]] if st["s"] < INF), None)
                   for e in rows[u]]
        x = init(u)
        t = min((r + 1 for r in reached if r is not None), default=ns + 1)
        while t <= ns:
            fold, nxt, got = _Fold(ident[u]), None, {}
            for e in rows[u]:
                sv, tm = at(ev[e], t - 1)
                if tm is not None:
                    nxt = tm + 1 if nxt is None else min(nxt, tm + 1)
                ok = sv["s"] < INF
                c = cand(e, sv)
                got[e] = ok, c
                fold.push(ok, _pk(c["s"], c["a"]), c["nz"], c["tot"],
                          erank[e])
            m1, m3 = fold.mins()
            cur1 = _pk(x["s"], x["a"]) if x["s"] < INF else INF
            better = m1 < cur1
            if m1 == cur1:  # ties on k1: the mapq keys decide
                m2, k2x = fold.m2_value(), _qk(x["nz"], x["tot"])
                better = m2 < k2x or (m2 == k2x and m3 < x["rank"])
            if shard:
                new = better and _payload_min(rows[u], got, erank, ident[u],
                                              m1, fold.m2_value(), m3)
            else:
                wins = [e for e in rows[u] if got[e][0] and erank[e] == m3]
                new = better and wins and dict(
                    got[min(wins)][1], rank=erank[min(wins)], eid=min(wins))
            if new:
                if any(new[k] != x[k] for k in ("s", "a", "nz", "tot")):
                    hist[u].append((t, new))
                    used += 1
                x = new
            if nxt is None:
                break
            t = nxt
        final[u] = x
        du = _pk(x["s"], x["a"]) if x["s"] < INF else INF
        for e in rows[u]:
            v, sv = ev[e], final[ev[e]]
            if fa[v] < INF:
                fa[u] = min(fa[u], _w(fa[v] + ea[e]))
            ct[u] = _w(ct[u] + ct[v])
            if sv["s"] < INF and _pk(_w(sv["s"] + es[e]),
                                     _w(sv["a"] + ea[e])) == du:
                cm[u] = _w(cm[u] + cm[v])
        ct[u], cm[u] = min(ct[u], COUNT_SAT), min(cm[u], COUNT_SAT)
    if used > cap:
        return 1, None                                    # (d) the pool
    out = {k: np.array([final[v][k[2:]] for v in range(V)], np.int64)
           for k in ("d_s", "d_a", "d_nz", "d_tot")}
    if shard:
        return 0, out
    out["d_eid"] = np.array([final[v]["eid"] for v in range(V)], np.int32)
    if max(L) > ns:
        return 2, out                                     # (b) the floor
    out.update(floor_a=np.array(fa, np.int64), cnt_tot=np.array(ct, np.int64),
               cnt_min=np.array(cm, np.int64))
    return 0, out


def _emulate_pass(args, V, ns, order=None, cap=None, seed=0):
    """A bucket through the checked pass and, for each flagged contig, the
    Jacobi branch (``_emulate_contig``): the outputs and the flags."""
    rng = np.random.default_rng(seed)
    eu, ev, es, ea, enz, etot, erank, evalid, _src, dest = args
    per, flags = [], []
    for b in range(len(eu)):
        edges = (eu[b], ev[b], es[b], ea[b], enz[b], etot[b], erank[b],
                 evalid[b])
        flag, out = _pass_contig(*edges, int(dest[b]), V, ns,
                                 None if order is None else order[b],
                                 4 * V if cap is None else cap, rng)
        if flag:
            out = _emulate_contig(*edges, dest[b], V, ns, rng,
                                  dist=out if flag == 2 else None)
        per.append(out)
        flags.append(flag)
    return {k: np.stack([p[k] for p in per]) for k in per[0]}, flags


def _wild_bucket(B, V, E, seed):
    """Random graphs (cycles included) whose sums wrap int64 in the
    packed key, with negative and zero mapq totals, tied ranks, and
    invalid edges scattered through the list (their eu anywhere)."""
    rng = np.random.default_rng(seed)
    evalid = rng.random((B, E)) < 0.8
    return [rng.integers(0, V, (B, E)).astype(np.int32),
            rng.integers(0, V, (B, E)).astype(np.int32),
            rng.integers(-2**40, 2**48, (B, E)),
            rng.integers(-3, 70_000, (B, E)).astype(np.int32),
            rng.integers(-50, 60, (B, E)).astype(np.int32),
            rng.integers(-3, 60, (B, E)).astype(np.int32),
            rng.integers(0, E // 4, (B, E)),
            evalid, np.zeros(B, np.int32),
            rng.integers(0, V, B).astype(np.int32)]


def _dag_bucket(B, V, seed, deep=False):
    """chip_smoke.py:sparse64_bucket's shape at B contigs: chain-like DAGs
    (i -> j for j in i+1 .. i+8, dest V-1, src 0) whose path sums pass
    2^31, numbered topologically (the identity is a valid hint).  Their
    longest path is ~0.45 of their rows; ``deep`` adds every i -> i+1, so
    that it spans them."""
    rng = np.random.default_rng(seed)
    lists = []
    for _b in range(B):
        u = np.repeat(np.arange(V - 1), 3)
        v = np.minimum(u + rng.integers(1, 9, len(u)), V - 1)
        if deep:
            u = np.concatenate([u, np.arange(V - 1)])
            v = np.concatenate([v, np.arange(1, V)])
        lists.append(np.unique(np.stack([u, v]), axis=1))
    E = 1 << max(uv.shape[1] for uv in lists).bit_length()
    arrs = [np.zeros((B, E), t) for t in (np.int32, np.int32, np.int64,
                                         np.int32, np.int32, np.int32,
                                         np.int64)]
    evalid = np.zeros((B, E), bool)
    for b, (u, v) in enumerate(lists):
        k = len(u)
        nz = rng.integers(0, 60, k)
        for arr, val in zip(arrs, (u, v, rng.integers(2**25, 2**26, k),
                                   rng.integers(0, 3, k), nz,
                                   nz + rng.integers(1, 60, k),
                                   rng.permutation(k))):
            arr[b, :k] = val
        evalid[b, :k] = True
    return [*arrs, evalid, np.zeros(B, np.int32), np.full(B, V - 1, np.int32)]


def _longest(args, b, V):
    """Longest path in valid edges of contig b of a DAG bucket."""
    eu, ev, evalid = args[0][b], args[1][b], args[7][b]
    L = np.zeros(V, np.int64)
    for _ in range(V):
        new = L.copy()
        np.maximum.at(new, eu[evalid], L[ev[evalid]] + 1)
        if np.array_equal(new, L):
            return int(L.max())
        L = new
    raise AssertionError("not a DAG")


def _pass_cases(buckets, case):
    """(args, V, n_sweeps, order, pool capacity, expected flags) of one
    case of the checked pass."""
    if case in ("pass-querysparse", "pass-querysparse-2", "pass-reversed"):
        for bk in buckets:
            args, order, V = bk["args"][:-1], bk["args"][-1], bk["V"]
            if case == "pass-querysparse":
                yield args, V, bk["n_sweeps"], order, None, [0] * bk["B"]
            elif case == "pass-reversed":
                yield args, V, bk["n_sweeps"], order[:, ::-1], None, \
                    [1] * bk["B"]
            else:  # distance replayed, floor and counts to the branch
                yield args, V, 2, order, None, [
                    2 if _longest(args, b, V) > 2 else 0
                    for b in range(bk["B"])]
    elif case == "pass-sparse64":  # too wide for the pass: check (c)
        yield _dag_bucket(3, 512, 64), 512, 512, None, None, [1] * 3
        yield _dag_bucket(3, 512, 64, deep=True), 512, 512, None, None, \
            [0] * 3
    elif case == "pass-wild":  # cycles: check (a) fails
        yield _wild_bucket(3, 32, 128, 5), 32, 32, None, None, [1] * 3
    elif case == "pass-overflow":  # more history than the pool holds
        yield _dag_bucket(3, 64, 7, deep=True), 64, 64, None, 16, [1] * 3
        yield _ladder_edges(2, 24), 32, 32, None, None, [1] * 2


@pytest.mark.parametrize("case", [
    "querysparse", "querysparse-2", "wild", "pass-querysparse",
    "pass-querysparse-2", "pass-sparse64", "pass-wild", "pass-overflow",
    "pass-reversed"])
def test_kernel_emulation_matches_plain_and_jax(buckets, case):
    """The kernel's CSR order, invalid-edge flag and min-index winner give
    the plain version's (and the JAX function's) every output, on the
    corpus's buckets and on random graphs where int64 sums wrap and ranks
    tie: through the Jacobi branch alone, and ("pass-*") through the
    checked pass with the branch taken exactly where a check fails."""
    if case.startswith("pass"):
        cases = list(_pass_cases(buckets, case))
    elif case == "wild":
        cases = [(_wild_bucket(3, 32, 128, 5), 32, 32)]
    else:
        cases = [(bk["args"][:-1], bk["V"],
                  bk["n_sweeps"] if case == "querysparse" else 2)
                 for bk in buckets]
    for args, V, ns, *passing in cases:
        if passing:
            order, cap, want_flags = passing
            got, flags = _emulate_pass(args, V, ns, order, cap)
            assert flags == want_flags
        else:
            got = _emulate(args, V, ns)
        want = relax.solve_graph_batch_plain(*_t(args), V=V, n_sweeps=ns)
        _assert_equal(got, {k: v.numpy() for k, v in want.items()})
        jwant = jsolve_graph_batch(*args, V=V, n_sweeps=ns)
        _assert_equal(got, {k: np.asarray(v) for k, v in jwant.items()})


def test_python_buckets_give_int64_buckets_a_hint(buckets):
    """Every int64 bucket's args end with its (B, V) ``topo_hint`` rows: a
    permutation per contig under which every valid edge climbs and the
    longest path fits the bucket's n_sweeps (the pass's checks (a) and
    (b) hold on every contig of the corpus)."""
    for bk in buckets:
        order, V = bk["args"][-1], bk["V"]
        assert order.dtype == np.int32 and order.shape == (bk["B"], V)
        eu, ev, evalid = bk["args"][0], bk["args"][1], bk["args"][7]
        for b, (_i, pg) in enumerate(bk["chunk"]):
            np.testing.assert_array_equal(order[b],
                                          scheduler.topo_hint(pg, V))
            pos = np.empty(V, np.int64)
            pos[order[b]] = np.arange(V)
            ok = evalid[b]
            assert (pos[ev[b][ok]] > pos[eu[b][ok]]).all()
            assert _longest(bk["args"], b, V) <= bk["n_sweeps"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_fold_matches_the_three_literal_folds(seed):
    """``_Fold``, the kernel's one pass over a row's edges, gives the
    literal m1 / m2 / m3 of ``solve_graph_batch`` (each a segment min over
    every edge of the row, INF for an edge off the previous minimum) in
    any edge order, with k1 and erank at and around INF and INT64_MAX,
    mapq keys below INF, above it and wrapped, ties, and both
    identities."""
    rng = np.random.default_rng(seed)
    pool = [0, 1, 5, INF - 1, INF, INF + 1, I64_MAX]
    nzs = [0, 1, 3, -3, 2**32, 2**33 - 1, 2**33]
    tots = [0, 1, 2, 3, -1, -7]

    def pick(vals):
        return vals[rng.integers(0, len(vals))]

    for _ in range(3000):
        n = int(rng.integers(0, 6))
        ident = [INF, I64_MAX][int(rng.integers(0, 2))]
        edges = [(bool(rng.random() < 0.8), pick(pool),
                  _qk(*nt), pick(pool), nt)
                 for nt in ((pick(nzs), pick(tots)) for _ in range(n))]
        ok, k1, k2, r = ([e[i] for e in edges] for i in range(4))
        m1 = min([ident, *(k if o else INF for o, k in zip(ok, k1))])
        on1 = [o and k == m1 for o, k in zip(ok, k1)]
        m2 = min([ident, *(k if o else INF for o, k in zip(on1, k2))])
        on2 = [o and k == m2 for o, k in zip(on1, k2)]
        m3 = min([ident, *(x if o else INF for o, x in zip(on2, r))])
        fold = _Fold(ident)
        for i in rng.permutation(n):
            e_ok, e_k1, _k2, e_r, (nz, tot) = edges[i]
            fold.push(e_ok, e_k1, nz, tot, e_r)
        assert fold.mins() == (m1, m3), (ident, edges)
        assert fold.m2_value() == m2, (ident, edges)


def test_wrapper_refuses_what_the_kernel_does_not_take(buckets):
    """relax64 takes contiguous CUDA tensors of the Python plane's dtypes
    and shapes only, and counts no launch for a refused call;
    solve_graph_batch sends CPU tensors to the plain version."""
    bk = buckets[0]
    args, V = _t(bk["args"][:-1]), bk["V"]
    n = cuda_relax64.relax64.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_relax64.relax64(*args, V, 4)
    for i, bad in ((2, torch.int32), (0, torch.int64), (7, torch.uint8),
                   (9, torch.int64)):
        wrong = list(args)
        wrong[i] = wrong[i].to(bad)
        with pytest.raises(TypeError, match=KEYS[i]):
            cuda_relax64.relax64(*wrong, V, 4)
    short = list(args)
    short[4] = short[4][:, :-1]
    with pytest.raises(ValueError, match="one \\(B, E\\) shape"):
        cuda_relax64.relax64(*short, V, 4)
    with pytest.raises(ValueError, match="V must be in"):
        cuda_relax64.relax64(*args, cuda_relax64.MAX_V * 2, 4)
    assert cuda_relax64.relax64.launches == n
    got = relax.solve_graph_batch(*args, V=V, n_sweeps=4)
    _assert_equal(got, relax.solve_graph_batch_plain(*args, V=V, n_sweeps=4))
