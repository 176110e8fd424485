"""The int64 relaxation of the port's Python plane on the CPU against the
JAX package.

``solve_graph_batch_plain`` (ops/relax.py) is held bit for bit to the
JAX ``solve_graph_batch`` on the real int64 buckets of a query-sparse
corpus (every contig's path sums may pass int32, so ``python_buckets``
makes int64 buckets only); the Python plane end to end on that corpus to
``solve_dataset_tpu(dataset, cfg)``; a numpy emulation of what
csrc/relax64.cu does differently from the plain version (a CSR of the
valid edges in any order within a vertex, invalid edges folded into a
per-vertex flag, the winner as the lowest edge index) to both; and the
wrapper's argument checks.  Every value is an integer: the tolerance is
0.
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
        want = jsolve_graph_batch(*bk["args"], V=bk["V"], n_sweeps=ns)
        got = relax.solve_graph_batch_plain(*_t(bk["args"]), V=bk["V"],
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
                    rng):
    """One contig as csrc/relax64.cu computes it: the valid edges in a
    CSR by eu, shuffled within each vertex (the kernel's atomics fix no
    order), a vertex that an invalid edge leaves starts its minima at INF
    instead of segment_min's identity, the winner is the lowest edge
    index among the reached edges whose erank equals m3."""
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
    for _ in range(ns):
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


@pytest.mark.parametrize("case", ["querysparse", "querysparse-2", "wild"])
def test_kernel_emulation_matches_plain_and_jax(buckets, case):
    """The kernel's CSR order, invalid-edge flag and min-index winner give
    the plain version's (and the JAX function's) every output, on the
    corpus's buckets and on random graphs where int64 sums wrap and ranks
    tie."""
    if case == "wild":
        cases = [(_wild_bucket(3, 32, 128, 5), 32, 32)]
    else:
        cases = [(bk["args"], bk["V"],
                  bk["n_sweeps"] if case == "querysparse" else 2)
                 for bk in buckets]
    for args, V, ns in cases:
        got = _emulate(args, V, ns)
        want = relax.solve_graph_batch_plain(*_t(args), V=V, n_sweeps=ns)
        _assert_equal(got, {k: v.numpy() for k, v in want.items()})
        jwant = jsolve_graph_batch(*args, V=V, n_sweeps=ns)
        _assert_equal(got, {k: np.asarray(v) for k, v in jwant.items()})


def test_wrapper_refuses_what_the_kernel_does_not_take(buckets):
    """relax64 takes contiguous CUDA tensors of the Python plane's dtypes
    and shapes only, and counts no launch for a refused call;
    solve_graph_batch sends CPU tensors to the plain version."""
    bk = buckets[0]
    args, V = _t(bk["args"]), bk["V"]
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
