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
    TOPK_EXTREME_SEEDS, _inf_plus_x, _topk_case, _topk_extremes,
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
TOP = 2**63  # -2^63's bits, the order's last value


def _ord(x):
    """csrc/topk.cu ord(): top_k(-cand)'s order as an unsigned one."""
    return ((x - 1) & M64) ^ TOP


def _insert(r, c, Kk):
    oc = _ord(c)
    if oc >= _ord(r[Kk - 1]):
        return
    p = Kk - 1
    while p > 0 and _ord(r[p - 1]) > oc:
        r[p] = r[p - 1]
        p -= 1
    r[p] = c


def _merge_list(r, L, key, Kk):
    """csrc/topk.cu merge_list(): a sorted run merges from the back after
    counting the m candidates that enter, a wrapped one by insertion."""
    c = [(key + x) & M64 for x in L]
    if _ord(c[0]) > _ord(c[-1]):
        for x in c:
            _insert(r, x, Kk)
        return
    m = 0
    while m < Kk and _ord(c[m]) < _ord(r[Kk - 1 - m]):
        m += 1
    i, p, j = Kk - m - 1, Kk - 1, m - 1
    while j >= 0:
        if i >= 0 and _ord(r[i]) > _ord(c[j]):
            r[p] = r[i]
            i -= 1
        else:
            r[p] = c[j]
            j -= 1
        p -= 1


def emulate_contig(w, d, V, Kk, ns):
    """One CTA of csrc/topk.cu: the rows' edges (at most ROW_CAP kept,
    a denser row read from w in place each sweep), each row filled with
    its virtual candidates (INF under out-degree V, else -2^63), its
    edges' lists merged in, dest's row written directly, the sweeps
    stopped at the first that changes nothing.  Returns (keys, sweeps)."""
    w = [[int(x) for x in row] for row in w]
    kept = []
    for u in range(V):
        cols = [c for c in range(V) if w[u][c] < INF]
        kept.append((len(cols), cols if len(cols) <= cuda_topk.ROW_CAP
                     else None))
    r0 = d + V if d < 0 else d
    cur = [[0 if (j == 0 and u == r0) else INF for j in range(Kk)]
           for u in range(V)]
    ran = 0
    for _ in range(max(ns, 0)):
        nxt = []
        for u in range(V):
            if u == d:
                nxt.append([0] + [INF] * (Kk - 1))
                continue
            deg, cols = kept[u]
            r = [INF if deg < V else TOP] * Kk
            if cols is None:  # in place: the dense row, every sweep
                cols = [c for c in range(V) if w[u][c] < INF]
            for c in cols:
                _merge_list(r, cur[c], w[u][c] & M64, Kk)
            nxt.append(r)
        ran += 1
        changed = nxt != cur
        cur = nxt
        if not changed:
            break
    keys = [[x - 2**64 if x >= TOP else x for x in row] for row in cur]
    return np.array(keys, np.int64).reshape(V, Kk), ran


@pytest.mark.parametrize("case", ["dag-8", "dense-33", "long", "extremes"])
def test_kernel_emulation_matches_plain(case, long_corpus):
    """The emulated kernel equals the plain version, and its sweep count is
    the plain sweeps' fixed point: the state after ``ran`` sweeps equals
    the one after ``ran - 1`` (unless it ran them all) and not the one
    after ``ran - 2``.  "dense-33" has rows over the kernel's 16 edges
    kept in shared memory (read in place)."""
    if case == "long":
        items = [it for it in long_corpus if it[2] == 64]
        wk1, dest = _batch(items)
        runs = [(64, 16, max(g.n_vertices for g, _p, _V in items))]
    elif case == "extremes":
        wk1, dest = _topk_extremes(32, 2, 3)
        runs = [(2, 2, 4), (2, 4, 4), (2, 1, 2)]
    else:
        V = int(case.split("-")[1])
        wk1, dest = _topk_case(8, V, 7 + V)
        runs = [(V, Kk, ns) for Kk in (1, 4, 16) for ns in (3, V)]
    for V, Kk, ns in runs:
        want = _plain(wk1, dest, V, Kk, ns)
        for b in range(wk1.shape[0]):
            got, ran = emulate_contig(wk1[b], int(dest[b]), V, Kk, ns)
            np.testing.assert_array_equal(got, want[b])
            one = (wk1[b:b + 1], dest[b:b + 1], V, Kk)
            assert 1 <= ran <= ns
            if ran < ns:
                np.testing.assert_array_equal(_plain(*one, ran),
                                              _plain(*one, ran - 1))
            if ran >= 2:
                assert not np.array_equal(_plain(*one, ran - 1),
                                          _plain(*one, ran - 2))


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
    for V, Kk in ((512, 18), (1024, 16)):
        big = torch.full((1, V, V), INF, dtype=torch.int64)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_topk.topk_walks_batch(big, dest[:1], V, Kk, 2)
    assert cuda_topk.topk_walks_batch.launches == n
    # the stated limits: V <= 512 at K <= 17, V <= 256 at K <= 45
    fits = [(V, Kk) for V, Kk in ((512, 16), (512, 17), (512, 18),
                                  (256, 45), (256, 46), (1024, 1))
            if cuda_topk.smem_bytes(V, Kk) <= cuda_topk.SMEM_MAX]
    assert fits == [(512, 16), (512, 17), (256, 45), (1024, 1)]
