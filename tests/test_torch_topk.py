"""The port's top-K walk keys (alignasm_tpu_torch/ops/topk.py) against the
JAX package's (alignasm_tpu/ops/topk.py) and the Eppstein engine, and the
kernel's selection (csrc/topk.cu) emulated in Python against the plain
version.

Inputs: ``tests/data/synth_hard.paf``'s contigs as ``tests/test_topk.py``
picks them (2-24 records, V <= 128; V is 8-32 there), contigs of the
generator of chip_smoke.py's long2000 (at 40 contigs, V <= 128), and
seeded random batches (``_topk_case``: rows of out-degree V - 1 and V,
cells above INF, a self-loop and a cycle where INF + x is selected, odd
dests, cells of extreme int64 values whose sums wrap;
``_topk_extremes``: tiny contigs where -2^63 is selected).  Every value
is an integer: the tolerance is 0.  No JAX call is made at V > 64.
"""

import functools

import numpy as np
import pytest
import torch

from alignasm_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from alignasm_tpu.engine.device import pack_graph as jax_pack_graph
from alignasm_tpu.engine.graph import build_graph as jax_build_graph
from alignasm_tpu.io.paf import read_paf as jax_read_paf
from alignasm_tpu.ops import topk as jtopk
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.engine.device import pack_graph
from alignasm_tpu_torch.engine.graph import build_graph
from alignasm_tpu_torch.engine.kshortest import KShortestWalks
from alignasm_tpu_torch.io.paf import read_paf
from alignasm_tpu_torch.model import distance as D
from alignasm_tpu_torch.ops import cuda_topk, topk
from alignasm_tpu_torch.runtime.scheduler import _next_pow2
from alignasm_tpu_torch.testing.synth import generate_paf
from tests.conftest import DATA_DIR
from tests.test_torch_kernels import (
    TOPK_EXTREME_SEEDS, _inf_plus_x, _topk_budget_case, _topk_case,
    _topk_extremes, _topk_fixpoint,
)

INF = topk.INF
K = 16


def _eligible(contigs, build, pack, cfg, max_v=128):
    """(graph, PackedGraph, V) of the contigs tests/test_topk.py takes."""
    out = []
    for contig in contigs:
        if not 2 <= len(contig) <= 24:
            continue
        g = build(contig, cfg)
        V = _next_pow2(g.n_vertices)
        if V <= max_v:
            out.append((g, pack(g), V))
    return out


@functools.lru_cache(maxsize=None)
def _synth_hard():
    return _eligible(read_paf(DATA_DIR / "synth_hard.paf").contigs,
                     build_graph, pack_graph, DEFAULT_CONFIG)


@pytest.fixture(scope="module")
def long_corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("topk") / "long40.paf"
    path.write_text(generate_paf(n_contigs=40, seed=9,
                                 max_records_per_contig=180))
    out = []
    for contig in read_paf(path).contigs:
        if len(contig) < 2:
            continue
        g = build_graph(contig, DEFAULT_CONFIG)
        V = _next_pow2(g.n_vertices)
        if V <= 128:
            out.append((g, pack_graph(g), V))
    return out


def _batch(items):
    """(wk1 (B, V, V), dest (B,)) of contigs of one V."""
    V = items[0][2]
    wk1 = np.stack([topk.pack_edge_keys(pg, V) for _g, pg, _V in items])
    return wk1, np.array([g.dest for g, _pg, _V in items], np.int32)


def _plain(wk1, dest, V, Kk, ns):
    return topk.topk_walks_batch_plain(torch.from_numpy(wk1),
                                       torch.from_numpy(dest), V, Kk,
                                       ns).numpy()


def _jax(wk1, dest, V, Kk, ns):
    return np.asarray(jtopk.topk_walks_batch(wk1, dest, V=V, K=Kk,
                                             n_sweeps=ns))


def test_pack_edge_keys_matches_jax():
    """The port's pack_edge_keys of the port's PackedGraph equals JAX's of
    JAX's on every eligible synth_hard contig."""
    ours = _synth_hard()
    theirs = _eligible(jax_read_paf(DATA_DIR / "synth_hard.paf").contigs,
                       jax_build_graph, jax_pack_graph, JAX_CONFIG)
    assert len(ours) == len(theirs) >= 10
    for (g, pg, V), (jg, jpg, jV) in zip(ours, theirs):
        assert (g.n_vertices, V) == (jg.n_vertices, jV)
        got = topk.pack_edge_keys(pg, V)
        want = jtopk.pack_edge_keys(jpg, V)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_plain_matches_jax_on_synth_hard():
    """The plain version equals JAX's function on every eligible
    synth_hard contig at K = 16 and n_sweeps = n + 2 (tests/test_topk.py's
    call), batched by (V, n_sweeps)."""
    groups = {}
    for item in _synth_hard():
        groups.setdefault((item[2], item[0].n + 2), []).append(item)
    n = 0
    for (V, ns), items in groups.items():
        wk1, dest = _batch(items)
        np.testing.assert_array_equal(_plain(wk1, dest, V, K, ns),
                                      _jax(wk1, dest, V, K, ns))
        n += len(items)
    assert n == len(_synth_hard()) >= 30


@pytest.mark.parametrize("ns", ["1", "3", "V"])
@pytest.mark.parametrize("Kk", [1, 4, 16])
@pytest.mark.parametrize("V", [8, 16, 64])
def test_plain_matches_jax_on_random_batches(V, Kk, ns):
    """The plain version equals JAX's function on ``_topk_case`` batches
    (B = 8: every flavour), INF + x selected in the cycle's contig."""
    ns = V if ns == "V" else int(ns)
    wk1, dest = _topk_case(8, V, 100 + V + Kk + ns)
    got = _plain(wk1, dest, V, Kk, ns)
    np.testing.assert_array_equal(got, _jax(wk1, dest, V, Kk, ns))
    assert _inf_plus_x(torch.from_numpy(got[5]))


@pytest.mark.parametrize("V,Kk,seed", TOPK_EXTREME_SEEDS)
def test_plain_matches_jax_where_minus_2_63_is_selected(V, Kk, seed):
    """Sums that wrap and -2^63, which top_k(-cand) sorts last, as JAX."""
    wk1, dest = _topk_extremes(64, V, seed)
    got = _plain(wk1, dest, V, Kk, 4)
    np.testing.assert_array_equal(got, _jax(wk1, dest, V, Kk, 4))
    assert (got == -2**63).any()


def _eppstein_keys(g):
    kd = KShortestWalks(g.adj, D.CALC_SUM).solve(g.src, g.dest, K)
    return sorted((D.score_sum(d) << 16) | d[D.A] for d in kd)


@pytest.mark.parametrize("corpus", ["synth_hard", "long"])
def test_topk_matches_eppstein_prefix(corpus, long_corpus):
    """The port's mirror of tests/test_topk.py: ``topk[src]``'s finite keys
    are the (sum, anom) keys of the port's Eppstein engine's first K
    walks, on synth_hard (n_sweeps = n + 2) and on the long corpus's
    contigs of V <= 128 (n_sweeps = the batch's largest vertex count, as
    chip_smoke.py runs long2000)."""
    items = _synth_hard() if corpus == "synth_hard" else long_corpus
    by_v = {}
    for item in items:
        by_v.setdefault(item[2], []).append(item)
    checked = 0
    for V, group in by_v.items():
        wk1, dest = _batch(group)
        ns = max(g.n + 2 if corpus == "synth_hard" else g.n_vertices
                 for g, _pg, _V in group)
        out = topk.topk_walks_batch(torch.from_numpy(wk1),
                                    torch.from_numpy(dest), V, K, ns)
        for b, (g, _pg, _V) in enumerate(group):
            got = [int(x) for x in out[b, g.src] if x < INF]
            assert got == _eppstein_keys(g), (corpus, b)
            checked += 1
    assert checked >= (30 if corpus == "synth_hard" else 20)


# --- csrc/topk.cu emulated ---------------------------------------------

M64 = 2**64 - 1
BIAS = 2**63 - 1     # csrc/topk.cu kBias: ord(x) = x + BIAS (mod 2^64)
LAST = M64           # ord(-2^63), the order's last value
ORD_INF = INF + BIAS


def _ord(x):
    """csrc/topk.cu's key space: top_k(-cand)'s order as an unsigned one,
    in which adding an edge key commutes (ord(x + k) = ord(x) + k)."""
    return (x + BIAS) & M64


def _route(Kk):
    """csrc/topk.cu lanes_of() and keys_of(): a row's lanes G and keys a
    lane R (N = G R = next_pow2(K), G at most GROUP_LANES); (0, 0), a
    thread a row, for K > 32."""
    if Kk > 32:
        return 0, 0
    n = 1 << (Kk - 1).bit_length()
    G = min(n, cuda_topk.GROUP_LANES)
    return G, n // G


def _step(x, L, key, Kk, first, stats):
    """csrc/topk.cu Group::step() for a group with an edge, element by
    element (element e = r G + l is lane l's register r; a stride of G or
    more is a compare-exchange between a lane's registers, a smaller one
    a shuffle): x holds the row's N keys (ascending), L the child's Kk
    keys; returns x's keys of the N smallest of x and key + L.  A run
    whose sum carries on some elements but not all is rotated back to
    sorted order; the row's first run is an element-wise minimum, a
    later one the minimum against the run reversed, sorted by log2 N
    compare-exchange stages."""
    N = len(x)
    o = [L[e] if e < Kk else LAST for e in range(N)]
    c = [(o[e] + key) & M64 if e < Kk else LAST for e in range(N)]
    carry = [e for e in range(Kk) if c[e] < o[e]]
    if 0 < len(carry) < Kk:
        m = carry[0]
        stats["rotated"] += 1
        c = [c[(e + m) % Kk] if e < Kk else LAST for e in range(N)]
    if first:
        return [min(a, b) for a, b in zip(x, c)]
    y = c[::-1]
    if not any(b < a for a, b in zip(x, y)):
        return x
    x = [min(a, b) for a, b in zip(x, y)]
    s = N // 2
    while s:
        x = [max(x[e], x[e ^ s]) if e & s else min(x[e], x[e ^ s])
             for e in range(N)]
        s //= 2
    return x


def _insert(r, c, Kk):
    if c >= r[Kk - 1]:
        return
    p = Kk - 1
    while p > 0 and r[p - 1] > c:
        r[p] = r[p - 1]
        p -= 1
    r[p] = c


def _merge_list(r, L, key, Kk):
    """csrc/topk.cu merge_list(), a thread's merge (K > 32): a sorted run
    merges from the back after counting the m candidates that enter, a
    run whose sum carries inside it by insertion."""
    c = [(key + x) & M64 for x in L]
    if c[0] > c[-1]:
        for x in c:
            _insert(r, x, Kk)
        return
    m = 0
    while m < Kk and c[m] < r[Kk - 1 - m]:
        m += 1
    i, p, j = Kk - m - 1, Kk - 1, m - 1
    while j >= 0:
        if i >= 0 and r[i] > c[j]:
            r[p] = r[i]
            i -= 1
        else:
            r[p] = c[j]
            j -= 1
        p -= 1


def emulate_contig(w, d, V, Kk, ns):
    """One CTA of csrc/topk.cu: each row's valid cells kept in the CSR
    when it has at most ROW_CAP and the 4 V budget holds them (the rows
    claimed in vertex order here, in the warps' order on the card), else
    read in place; the keys in ord space; sweep 1 computes every row but
    dest's, a later sweep the rows read in place and those with a child
    that changed in the sweep before; each row starts as its virtual
    candidates (INF under out-degree V, else -2^63) and merges its
    children's lists, by a group of lanes (``_step``, K <= 32) or by a
    thread (``_merge_list``); the sweeps stop at the first that changes
    no row.  (On the card a warp's groups step together, a group without
    an edge feeding nothing, which changes no key.)  Returns (keys, stats): stats
    counts the sweeps, the rows computed, the rotated runs and the rows
    read in place."""
    w = [[int(x) for x in row] for row in w]
    csr, pool = [], 0
    stats = dict(sweeps=0, rows=0, rotated=0, in_place=0)
    for u in range(V):
        cols = [c for c in range(V) if w[u][c] < INF]
        fits = False
        if len(cols) <= cuda_topk.ROW_CAP:
            fits = pool + len(cols) <= cuda_topk.EDGES_PER_VERTEX * V
            pool += len(cols)
        csr.append((len(cols), cols if fits else None))
        stats["in_place"] += not fits
    r0 = d + V if d < 0 else d
    tk = [[_ord(0) if (j == 0 and u == r0) else ORD_INF for j in range(Kk)]
          for u in range(V)]
    G, R = _route(Kk)
    active = [u for u in range(V) if u != d]
    for _ in range(max(ns, 0)):
        new = {}
        for u in active:
            n, cols = csr[u]
            if cols is None:  # in place: the row's valid cells, in order
                cols = [c for c in range(V) if w[u][c] < INF]
            fill = ORD_INF if n < V else LAST
            if G:
                x = [fill if e < Kk else LAST for e in range(G * R)]
                for i, c in enumerate(cols):
                    x = _step(x, tk[c], w[u][c] & M64, Kk, i == 0, stats)
                x = x[:Kk]
            else:
                x = [fill] * Kk
                for c in cols:
                    _merge_list(x, tk[c], w[u][c] & M64, Kk)
            if x != tk[u]:
                new[u] = x
        stats["sweeps"] += 1
        stats["rows"] += len(active)
        if not new:
            break
        for u, x in new.items():
            tk[u] = x
        active = [u for u in range(V) if u != d and (
            csr[u][1] is None or any(c in new for c in csr[u][1]))]
    keys = [[(x - BIAS) & M64 for x in row] for row in tk]
    keys = [[x - 2**64 if x >= 2**63 else x for x in row] for row in keys]
    return np.array(keys, np.int64).reshape(V, Kk), stats


def _emulation_runs(case, long_corpus):
    """(wk1, dest, [(V, K, n_sweeps), ...]) of an emulation case."""
    if case == "long":
        items = [it for it in long_corpus if it[2] == 64]
        wk1, dest = _batch(items)
        return wk1, dest, [(64, 16, max(g.n_vertices for g, _p, _V in items))]
    if case == "extremes":
        return (*_topk_extremes(32, 2, 3), [(2, 2, 4), (2, 4, 4), (2, 1, 2)])
    if case == "minus-2-63":
        return (*_topk_extremes(64, 3, 39), [(3, 2, 4), (3, 45, 4)])
    if case == "wrapped":
        wk1, dest = _topk_case(8, 16, 41)
        return wk1[6:7], dest[6:7], [(16, 4, 16), (16, 16, 16), (16, 33, 16)]
    if case == "dests":
        wk1, dest = _topk_case(4, 16, 5)
        return (np.repeat(wk1[:1], 4, 0), np.array([-1, -16, 16, 19], np.int32),
                [(16, 4, 16), (16, 40, 16)])
    if case == "budget":
        return (*_topk_budget_case(2, 16, 3), [(16, 4, 16), (16, 16, 16)])
    if case == "v32-k17":
        return (*_topk_case(8, 32, 77), [(32, 17, 32)])
    if case == "sweeps-0-1":
        return (*_topk_case(8, 16, 13), [(16, 16, 0), (16, 16, 1), (16, 1, 1)])
    V = int(case.split("-")[1])
    return (*_topk_case(8, V, 7 + V),
            [(V, Kk, ns) for Kk in (1, 4, 16) for ns in (3, V)])


@pytest.mark.parametrize("case", ["dag-8", "dense-33", "long", "extremes",
                                  "minus-2-63", "wrapped", "dests",
                                  "budget", "v32-k17", "sweeps-0-1"])
def test_kernel_emulation_matches_plain(case, long_corpus):
    """The emulated kernel equals the plain version, and its sweep count is
    the plain sweeps' fixed point (``_topk_fixpoint``).  "dense-33" has
    rows past the 32 edges a CSR row holds (read in place); "minus-2-63"
    selects -2^63, "wrapped" rotates runs whose sums carry, both also by a
    thread a row (K > 32); "dests" has negative and out-of-range dests;
    "budget" rows past the CSR's 4 V edges; "v32-k17" a 32-lane group
    with 15 padding lanes; "sweeps-0-1" n_sweeps 0 and 1."""
    wk1, dest, runs = _emulation_runs(case, long_corpus)
    seen = dict(rotated=0, in_place=0, minus=False)
    for V, Kk, ns in runs:
        want = _plain(wk1, dest, V, Kk, ns)
        for b in range(wk1.shape[0]):
            got, st = emulate_contig(wk1[b], int(dest[b]), V, Kk, ns)
            np.testing.assert_array_equal(got, want[b])
            one = [torch.from_numpy(a) for a in (wk1[b:b + 1], dest[b:b + 1])]
            assert _topk_fixpoint(
                lambda n: topk.topk_walks_batch_plain(*one, V, Kk, n),
                st["sweeps"], ns), (V, Kk, ns, b, st)
            seen["rotated"] += st["rotated"]
            seen["in_place"] += st["in_place"]
        seen["minus"] |= bool((want == -2**63).any())
    if case == "wrapped":
        assert seen["rotated"] > 0
    if case in ("dense-33", "budget"):
        assert seen["in_place"] > 0
    if case == "minus-2-63":
        assert seen["minus"]
    if case == "budget":  # every row fits ROW_CAP but row 1: the budget
        assert seen["in_place"] > len(runs) * wk1.shape[0]


def test_frontier_skips_rows(long_corpus):
    """On the long corpus's V = 128 contigs (long2000's generator), the
    emulated kernel computes far fewer rows than V a sweep, and its keys
    still equal the plain version's."""
    items = [it for it in long_corpus if it[2] == 128][:4]
    wk1, dest = _batch(items)
    ns = max(g.n_vertices for g, _p, _V in items)
    want = _plain(wk1, dest, 128, K, ns)
    rows = full = 0
    for b in range(len(items)):
        got, st = emulate_contig(wk1[b], int(dest[b]), 128, K, ns)
        np.testing.assert_array_equal(got, want[b])
        rows += st["rows"]
        full += 128 * st["sweeps"]
    assert len(items) == 4 and rows * 8 < full


def test_dispatch_and_wrapper_checks():
    """CPU tensors take the plain version (no launch); the kernel's wrapper
    checks types, shapes and the shared-memory limit first (also for CPU
    tensors) and then raises on a CPU tensor."""
    wk1, dest = (torch.from_numpy(a) for a in _topk_case(4, 8, 3))
    n = cuda_topk.topk_walks_batch.launches
    got = topk.topk_walks_batch(wk1, dest, 8, 4, 8)
    assert torch.equal(got, topk.topk_walks_batch_plain(wk1, dest, 8, 4, 8))
    assert cuda_topk.topk_walks_batch.launches == n
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cuda_topk.topk_walks_batch(wk1, dest, 8, 4, 8)
    with pytest.raises(TypeError, match="wk1 must be 3-d torch.int64"):
        cuda_topk.topk_walks_batch(wk1.int(), dest, 8, 4, 8)
    with pytest.raises(TypeError, match="dest must be 1-d torch.int32"):
        cuda_topk.topk_walks_batch(wk1, dest.long(), 8, 4, 8)
    with pytest.raises(ValueError, match="must be \\(B, V, V\\)"):
        cuda_topk.topk_walks_batch(wk1, dest, 16, 4, 8)
    with pytest.raises(ValueError, match="n_sweeps must fit int32"):
        cuda_topk.topk_walks_batch(wk1, dest, 8, 4, 2**31)
    for V, Kk in ((512, 50), (1024, 22)):
        big = torch.full((1, V, V), INF, dtype=torch.int64)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_topk.topk_walks_batch(big, dest[:1], V, Kk, 2)
    assert cuda_topk.topk_walks_batch.launches == n
    # the stated limits: V <= 512 at K <= 49, V <= 256 at K <= 106, V <=
    # 1024 at K <= 21, V <= 2048 at K <= 7; the old ones (V <= 512 at K <=
    # 17, V <= 256 at K <= 45, V = 1024 at K = 1) stay inside
    fits = [(V, Kk) for V, Kk in ((512, 17), (256, 45), (1024, 1),
                                  (512, 49), (512, 50), (256, 106),
                                  (256, 107), (1024, 21), (1024, 22),
                                  (2048, 7), (2048, 8))
            if cuda_topk.smem_bytes(V, Kk) <= cuda_topk.SMEM_MAX]
    assert fits == [(512, 17), (256, 45), (1024, 1), (512, 49), (256, 106),
                    (1024, 21), (2048, 7)]
    # two blocks an SM at V = 512, K = 16 (228 KB an SM, 1 KB a block)
    assert 2 * (cuda_topk.smem_bytes(512, 16) + 1024) <= 228 * 1024
