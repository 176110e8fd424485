"""The topological hint of the Python plane's sweep kernels, and the
checked one-pass algorithm of csrc/topo_pass.cuh, on the CPU.

``scheduler.topo_hint`` must give every packed contig a topological order
whose longest path fits its bucket's ``n_sweeps``.  A numpy emulation of
the kernels' pass (state by original vertex id, columns masked by
position, floor_a clamped at INF32 per row, dest's anchors, checks (a)-(c))
must equal the JAX ``dense_solve_batch`` and ``sp_batch32`` bit for bit
wherever its checks pass, and must send a reversed hint and a short
``n_sweeps`` to the Jacobi branch.  Inputs are the committed PAF files, a
seeded synthetic corpus and seeded random DAGs; every value is an integer,
so the tolerance is 0.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from alignasm_tpu.ops import dense as jdense
from alignasm_tpu.ops.relax32 import sp_batch32 as jsp_batch32
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.io.paf import read_paf
from alignasm_tpu_torch.runtime import scheduler
from alignasm_tpu_torch.testing import synth

DATA = Path(__file__).resolve().parent.parent / "tests" / "data"
INF32 = 2**30
COUNT_SAT = 10001
SCORE_MAX = (1 << 28) - 1


def _corpus(name, tmp_path_factory):
    if name == "long30":
        path = tmp_path_factory.mktemp("long") / "long30.paf"
        path.write_text(synth.generate_paf(n_contigs=30, seed=9,
                                           max_records_per_contig=180))
        return path, 8
    return DATA / f"{name}.paf", 256


_BUCKETS = {}


def _buckets(name, tmp_path_factory):
    """The Python plane's buckets of a corpus, packed and bucketed as
    ``solve_dataset_torch(dataset, cfg)`` does (buckets of 8 on the long
    corpus, so that it has dense and int32 sparse buckets)."""
    if name not in _BUCKETS:
        path, batch = _corpus(name, tmp_path_factory)
        cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
        stats = dict(singleton=0, oversize=0)
        _res, packed = scheduler.pack_dataset(read_paf(path), cfg, stats)
        _BUCKETS[name] = scheduler.python_buckets(packed, cfg, batch)
    return _BUCKETS[name]


def _longest_path(n, eu, ev, pos):
    """Longest path in edges, by the positions of a valid order."""
    L = np.zeros(n, np.int64)
    for t in sorted(set(eu.tolist()), key=lambda u: -pos[u]):
        L[t] = (L[ev[eu == t]] + 1).max()
    return int(L.max()) if n else 0


@pytest.mark.parametrize("name", ["synth50", "synth_hard", "long30"])
def test_topo_hint_orders_every_contig_within_n_sweeps(name,
                                                       tmp_path_factory):
    """Every contig of every bucket: the hint is a permutation of 0..V-1
    with the padding vertices last, every edge climbs in position, and the
    longest path is at most the bucket's n_sweeps; every bucket carries
    the hints as the last of its args."""
    buckets = _buckets(name, tmp_path_factory)
    kinds = set()
    for bk in buckets:
        kinds.add(bk["kind"])
        V, ns = bk["V"], bk["n_sweeps"]
        assert bk["args"][-1].shape == (bk["B"], V)
        for b, (_i, pg) in enumerate(bk["chunk"]):
            order = scheduler.topo_hint(pg, V)
            assert order.dtype == np.int32
            assert sorted(order.tolist()) == list(range(V))
            n = pg.g.n_vertices
            assert (order[n:] == np.arange(n, V)).all()
            pos = np.empty(V, np.int64)
            pos[order] = np.arange(V)
            assert (pos[pg.ev] > pos[pg.eu]).all()
            assert _longest_path(n, pg.eu, pg.ev, pos) <= ns
            np.testing.assert_array_equal(bk["args"][-1][b], order)
    if name == "long30":
        assert {"dense", "sparse32"} <= kinds


def emulate_pass(V, eu, ev, ws, wa, dest, order, n_sweeps):
    """The kernels' checked pass on one contig's edge list: (5, V) int32
    [d_s, d_a, floor_a, cnt_tot, cnt_min], or None where a check fails and
    the kernel takes its Jacobi branch (csrc/topo_pass.cuh)."""
    order = np.asarray(order, np.int64)
    if sorted(order.tolist()) != list(range(V)):
        return None                                   # (a): a permutation
    ws, wa = np.asarray(ws, np.int64), np.asarray(wa, np.int64)
    if ((ws < 0) | (ws > SCORE_MAX) | (wa < 0) | (wa > 3)).any():
        return None                                   # (c): packed cells
    pos = np.empty(V, np.int64)
    pos[order] = np.arange(V)
    dest_final = not (eu == dest).any()
    on_dest = np.arange(V) == dest
    s = np.where(on_dest, 0, INF32).astype(np.int64)
    a = np.zeros(V, np.int64)
    fa = s.copy()
    ct = on_dest.astype(np.int64)
    cm = ct.copy()
    L = np.zeros(V, np.int64)
    for t in range(V - 1, -1, -1):
        u = order[t]
        out = eu == u
        v, w, an = ev[out], ws[out], wa[out]
        final = (pos[v] > t) | ((v == dest) & dest_final)
        if not final.all():
            return None                               # (a): successors first
        L[u] = (L[v] + 1).max() if len(v) else 0
        if L[u] > min(n_sweeps, V):
            return None                               # (b)
        if u == dest:
            continue                                  # dest keeps its anchors
        cs = w + s[v]
        m1 = min(INF32, cs.min()) if len(v) else INF32
        if m1 < INF32:
            s[u], a[u] = m1, (an + a[v])[cs == m1].min()
        fa[u] = min(INF32, (an + fa[v]).min()) if len(v) else INF32
        ct[u] = min(ct[v].sum(), COUNT_SAT)
        ach = (s[v] < INF32) & (cs == s[u]) & (an + a[v] == a[u])
        cm[u] = min(cm[v][ach].sum(), COUNT_SAT)
    return np.stack([s, a, fa, ct, cm]).astype(np.int32)


def _dense_edges(ws, wa):
    eu, ev = np.nonzero(ws < INF32)
    return eu, ev, ws[eu, ev], wa[eu, ev]


def _check_dense(ws, wa, dests, orders, n_sweeps, want_pass=True):
    """emulate_pass against the JAX dense_solve_batch, contig by contig."""
    want = np.asarray(jdense.dense_solve_batch(ws, wa, dests,
                                               n_sweeps=n_sweeps))
    V = ws.shape[1]
    for b in range(len(dests)):
        got = emulate_pass(V, *_dense_edges(ws[b], wa[b]), dests[b],
                           orders[b], n_sweeps)
        if not want_pass:
            assert got is None, b
            continue
        assert got is not None, b
        np.testing.assert_array_equal(got, want[b])


def _check_sparse(eu, ev, es, ea, evalid, srcs, dests, orders, V, n_sweeps,
                  want_pass=True):
    """emulate_pass against the JAX sp_batch32, contig by contig."""
    want = np.asarray(jsp_batch32(eu, ev, es, ea, evalid, srcs, dests, V=V,
                                  n_sweeps=n_sweeps))
    for b in range(len(dests)):
        k = evalid[b]
        got = emulate_pass(V, eu[b][k], ev[b][k], es[b][k], ea[b][k],
                           dests[b], orders[b], n_sweeps)
        if not want_pass:
            assert got is None, b
            continue
        assert got is not None, b
        np.testing.assert_array_equal(got, want[b])


def _first_of_each_kind(buckets, kinds=("dense", "sparse32")):
    """The widest bucket of each kind (the long corpus: V 256 dense, V 512
    int32)."""
    out = {}
    for bk in buckets:
        if bk["kind"] in kinds:
            out[bk["kind"]] = bk
    return list(out.values())


@pytest.mark.parametrize("hint", ["topo", "reversed", "short"])
@pytest.mark.parametrize("name", ["synth_hard", "long30"])
def test_pass_emulation_matches_jax_on_real_buckets(name, hint,
                                                    tmp_path_factory):
    """On the Python plane's own buckets the pass, with the buckets' hints,
    bit-equals the JAX functions on every contig; a reversed hint, or an
    n_sweeps one short of a contig's longest path, takes every contig with
    an edge to the Jacobi branch."""
    for bk in _first_of_each_kind(_buckets(name, tmp_path_factory)):
        *args, orders = bk["args"]
        ns = bk["n_sweeps"]
        if hint == "reversed":
            orders = orders[:, ::-1]
        if hint == "short":
            V = bk["V"]
            lens = []
            for b, (_i, pg) in enumerate(bk["chunk"]):
                pos = np.empty(V, np.int64)
                pos[orders[b]] = np.arange(V)
                lens.append(_longest_path(pg.g.n_vertices, pg.eu, pg.ev, pos))
            ns = min(lens) - 1
            assert ns >= 1
        ok = hint == "topo"
        if bk["kind"] == "dense":
            _check_dense(*args, orders, ns, want_pass=ok)
        else:
            _check_sparse(*args, orders, bk["V"], ns, want_pass=ok)


def _shuffled_dags(B, V, density, seed, into_dest):
    """Random DAGs whose vertices are numbered in a random order: (ws, wa,
    dests, orders) with orders[b] the topological order (the generating
    order) in the shuffled numbering.  dest is a sink at a random position
    in the second half; with ``into_dest`` vertices after it also have
    edges into it (the dest rule of check (a))."""
    rng = np.random.default_rng(seed)
    ws = np.full((B, V, V), INF32, np.int32)
    wa = np.zeros((B, V, V), np.int32)
    dests = np.empty(B, np.int32)
    orders = np.empty((B, V), np.int32)
    for b in range(B):
        mask = np.triu(rng.random((V, V)) < density, k=1)
        d = int(rng.integers(V // 2, V))
        mask[d, :] = False
        if into_dest:
            mask[d + 1:, d] = rng.random(V - d - 1) < 0.5
        perm = rng.permutation(V)  # topological position t -> vertex id
        u, v = np.nonzero(mask)
        ws[b, perm[u], perm[v]] = rng.integers(0, 5000, len(u))
        wa[b, perm[u], perm[v]] = rng.integers(0, 3, len(u))
        dests[b], orders[b] = perm[d], perm
    return ws, wa, dests, orders


@pytest.mark.parametrize("V,density,seed,into_dest", [
    (8, 0.5, 0, False), (16, 0.3, 1, True), (32, 0.2, 2, False),
    (64, 0.08, 3, True),
])
def test_pass_emulation_matches_jax_on_shuffled_dags(V, density, seed,
                                                     into_dest):
    """Shuffled numbering with its hint: the pass bit-equals the JAX dense
    and sparse functions at n_sweeps = V; the identity and reversed
    hints and a short n_sweeps go to the Jacobi branch."""
    B = 6
    ws, wa, dests, orders = _shuffled_dags(B, V, density, seed, into_dest)
    _check_dense(ws, wa, dests, orders, V)
    E = 1 << int(max((ws[b] < INF32).sum() for b in range(B))).bit_length()
    eu, ev, es, ea = (np.zeros((B, E), np.int32) for _ in range(4))
    evalid = np.zeros((B, E), bool)
    for b in range(B):
        u, v, w, an = _dense_edges(ws[b], wa[b])
        k = len(u)
        eu[b, :k], ev[b, :k], es[b, :k], ea[b, :k] = u, v, w, an
        evalid[b, :k] = True
    srcs = np.zeros(B, np.int32)
    _check_sparse(eu, ev, es, ea, evalid, srcs, dests, orders, V, V)
    # the reversed hint puts every edge backwards (the dest rule spares only
    # edges into dest), and no sweep at all is too few
    for b in range(B):
        edges = _dense_edges(ws[b], wa[b])
        if (edges[1] != dests[b]).any():
            assert emulate_pass(V, *edges, dests[b], orders[b, ::-1],
                                V) is None
        if len(edges[0]):
            assert emulate_pass(V, *edges, dests[b], orders[b], 0) is None


@pytest.mark.parametrize("cell", [(-1, 0), (SCORE_MAX + 1, 0), (5, 4),
                                  (5, -1)])
def test_pass_emulation_rejects_cells_that_could_wrap(cell):
    """Check (c): an edge whose score or anomaly lies outside the packed
    cell's fields takes the Jacobi branch."""
    ws, wa, dests, orders = _shuffled_dags(1, 8, 0.5, 4, False)
    u, v = map(int, np.argwhere(ws[0] < INF32)[0])
    ws[0, u, v], wa[0, u, v] = cell
    assert emulate_pass(8, *_dense_edges(ws[0], wa[0]), dests[0], orders[0],
                        8) is None
