"""The dense shortest-path kernel's checked pass (csrc/dense_sp.cu),
emulated in Python, against the plain ``dense_sp_plain`` and JAX
``dense_sp_xla`` / ``dense_sp_pallas(interpret=True)``.

The emulation follows the pass: the CSR of the cells with ws < INF32 by
row in column order, the workspace's room for it (check (d)), Kahn's
order from the sources a frontier at a time (each frontier's pushes in a
random order, as the atomics leave them; check (a)), and the rows in
reverse order replaying each vertex's change history: a row evaluated at
the first sweep after a successor is reached and after each successor's
change, its edges (in a random order) folded into the cascade in one
pass (``_Fold``, the kernel's lexicographic merge), lane 0's append of a
change of (s, a, nz, tot) and the pool's capacity (check (d)).  A
flagged contig takes the literal sweeps, which ``dense_sp_plain`` is.
Inputs: ``pack_dense`` contigs of the long corpus's dense buckets (the
generator of chip_smoke.py's long2000, at 40 contigs) at the bucket's
n_sweeps and at 1 and 2, and random DAGs (``_dense_sp_case``) with tied
ranks, int32 sums that wrap, several dest lanes, cycles, and histories
that outgrow the pool.  Every value is an integer or an f32 key: the
tolerance is 0.
"""

import functools
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from alignasm_tpu.ops import pallas_relax as jpr
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.io.paf import read_paf
from alignasm_tpu_torch.ops import dense_sp
from alignasm_tpu_torch.runtime import scheduler
from alignasm_tpu_torch.testing.synth import generate_paf
from tests.test_torch_kernels import _dense_sp_case

INF32 = dense_sp.INF32
NO_TIME = 2**31 - 1


def pass_words(V):
    """csrc/dense_sp.cu pass_words() and its spill pool's entries: a
    contig's workspace in int32 words (shared memory up to V = 1024), and
    the global history entries beside it."""
    if V <= 256:
        return (113 * 1024 - 64) // 4, 16 * V
    if V <= 1024:
        return (227 * 1024 - 64) // 4, 16 * V
    return 100 * V + 8, 0


def _w(x):
    """int32 wrap of an integer."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _q(nz, tot):
    """The f32 mapq key, IEEE division."""
    return float(-(np.float32(nz) / np.float32(max(tot, 1))))


class _Fold:
    """csrc/dense_sp.cu Fold: the cascade's minima over a row's columns,
    every level from its off value."""

    def __init__(self, V):
        self.keys = (INF32, INF32, float("inf"), INF32)
        self.nz, self.tot, self.w = INF32, INF32, V

    def merge(self, o):
        for a, b in zip(self.keys, o.keys):
            if b < a:
                self.keys, self.nz, self.tot, self.w = (o.keys, o.nz, o.tot,
                                                        o.w)
                return
            if a < b:
                return
        self.nz, self.tot, self.w = (min(self.nz, o.nz), min(self.tot, o.tot),
                                     min(self.w, o.w))

    def push(self, cs, ca, cnz, ctot, r, v, V):
        if cs > INF32:
            return
        c = _Fold(V)
        keys = [cs, INF32, float("inf"), INF32]
        if ca <= INF32:
            keys[1], keys[2] = ca, _q(cnz, ctot)
            if r <= INF32:
                keys[3] = r
                c.nz, c.tot, c.w = min(cnz, INF32), min(ctot, INF32), v
        c.keys = tuple(keys)
        self.merge(c)


def _pass_contig(ws, wa, wnz, wtot, wrank, drow, ns, words, rng):
    """One contig as the pass computes it: (flag, the six rows).
    ``words``: the workspace's words and the spill pool's entries."""
    V = ws.shape[0]
    rows = [np.nonzero(ws[u] < INF32)[0] for u in range(V)]
    E = sum(map(len, rows))
    rest = words[0] - (5 * V + 1) - 7 * E
    if rest < 0:
        return 1, None                                 # (d) the CSR
    cap = rest // 5 + words[1]  # entries of five words, then the spill
    indeg = np.zeros(V, np.int64)
    for r in rows:
        indeg[r] += 1
    frontier = [v for v in range(V) if indeg[v] == 0]
    order = list(frontier)
    while frontier:
        new = []
        for u in rng.permutation(frontier):
            for v in rows[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    new.append(int(v))
        rng.shuffle(new)
        order += new
        frontier = new
    if len(order) != V:
        return 1, None                                 # (a) a cycle
    isd = np.arange(V) == drow
    out = np.zeros((6, V), np.int64)
    out[0] = np.where(isd, 0, INF32)
    out[4] = np.where(isd, -1, INF32)
    out[5] = -1
    hist = [[] for _ in range(V)]  # (sweep, s, a, nz, tot) of each change
    used, limit = 0, min(ns, V + 1)
    for u in reversed(order):
        if not len(rows[u]):
            continue
        t = min(1 if isd[v] else hist[v][0][0] + 1 if hist[v] else NO_TIME
                for v in rows[u])
        x = (0 if isd[u] else INF32, 0, 0, 0)
        rank, win = (-1 if isd[u] else INF32), -1
        cur = {int(v): -1 for v in rows[u]}  # the edges' cursors
        while t <= limit:
            fold, nxt = _Fold(V), NO_TIME
            for v in rng.permutation(rows[u]):
                h, p = hist[v], cur[v]
                while p + 1 < len(h) and h[p + 1][0] < t:
                    p += 1
                cur[v] = p
                if p + 1 < len(h):
                    nxt = min(nxt, h[p + 1][0] + 1)
                sv = h[p][1:] if p >= 0 else (0 if isd[v] else INF32, 0, 0, 0)
                if sv[0] < INF32:
                    e = [int(m[u, v]) for m in (ws, wa, wnz, wtot, wrank)]
                    fold.push(*(_w(x + y) for x, y in zip(e, sv)), e[4],
                              int(v), V)
            (c1, c2, c3, c4), inc = fold.keys, _q(x[2], x[3])
            better = c1 < x[0] or (c1 == x[0] and (c2 < x[1] or (
                c2 == x[1] and (c3 < inc or (c3 == inc and c4 < rank)))))
            if better and c1 < INF32:
                nx = (c1, c2, fold.nz, fold.tot)
                if nx != x:
                    if used < cap:
                        hist[u].append((t, *nx))
                    used += 1
                x, rank, win = nx, c4, fold.w
            t = nxt
        out[:, u] = (*x, rank, win)
        if used > cap:
            return 1, None                             # (d) the pool
    return 0, out.astype(np.int32)


def emulate_dense_sp(mats, drow, ns, words=None, seed=0):
    """A bucket through the pass and, for each flagged contig, the
    literal sweeps: the six rows and the flags."""
    rng = np.random.default_rng(seed)
    B, V, _ = mats[0].shape
    words = pass_words(V) if words is None else words
    outs, flags = np.empty((6, B, 1, V), np.int32), []
    for b in range(B):
        flag, out = _pass_contig(*(m[b] for m in mats), drow[b, 0], ns,
                                 words, rng)
        if flag:
            one = dense_sp.dense_sp_plain(
                *(torch.from_numpy(m[b:b + 1]) for m in (*mats, drow)), ns)
            out = np.stack([one[k][0, 0].numpy() for k in dense_sp.DSP_ROWS])
        outs[:, b, 0] = out
        flags.append(flag)
    return dict(zip(dense_sp.DSP_ROWS, outs)), flags


@functools.lru_cache(maxsize=None)
def _long_buckets():
    """The long corpus's dense buckets (of 8 contigs: sorted by size as
    long2000's buckets of 256 are) as (matrices, dest row, n_sweeps) of
    the contigs ``pack_dense`` takes."""
    with tempfile.TemporaryDirectory() as d:
        paf = pathlib.Path(d) / "long40.paf"
        paf.write_text(generate_paf(n_contigs=40, seed=9,
                                    max_records_per_contig=180))
        stats = dict(singleton=0, oversize=0)
        _res, packed = scheduler.pack_dataset(read_paf(str(paf)),
                                              DEFAULT_CONFIG, stats)
    out = []
    for bk in scheduler.python_buckets(packed, DEFAULT_CONFIG, batch_size=8):
        if bk["kind"] != "dense":
            continue
        V = bk["V"]
        ms = [dense_sp.pack_dense(pg, V) for _i, pg in bk["chunk"]]
        dests = [pg.g.dest for (_i, pg), m in zip(bk["chunk"], ms)
                 if m is not None]
        ms = [m for m in ms if m is not None]
        mats = [np.stack([m[k] for m in ms]) for k in range(5)]
        drow = np.repeat(np.array(dests, np.int32)[:, None, None], V, 2)
        out.append((mats, drow, bk["n_sweeps"]))
    assert len(out) >= 2
    return out


def _cases(case):
    """(matrices, dest row, n_sweeps, workspace words and spill entries,
    expected flags)."""
    if case.startswith("long"):
        for mats, drow, ns in _long_buckets():
            ns = {"long": ns, "long-1": 1, "long-2": 2}[case]
            yield mats, drow, ns, None, [0] * len(drow)
        return
    B, V = 4, 48
    kind = "ladder" if case.startswith("ladder") else \
        "dag" if case.startswith("small") else case
    mats, drow = _dense_sp_case(B, V, 5, kind)
    if case == "ladder":  # ~V^2 / 2 changes outgrow the pool
        V = 256
        mats, drow = _dense_sp_case(2, V, 6, "ladder")
        yield mats, drow, V, None, [1, 1]
    elif case == "ladder-fits":
        yield mats, drow, V, None, [0] * B
    elif case == "cycle":
        yield mats, drow, V, None, [1] * B
    elif case == "small-pool":  # the CSR fits, the history does not
        E = int((mats[0][0] < INF32).sum())
        yield [m[:1] for m in mats], drow[:1], V, \
            (5 * V + 1 + 7 * E + 5 * 8, 0), [1]
    elif case == "small-csr":
        yield [m[:1] for m in mats], drow[:1], V, (5 * V + 1 + 7 * 10, 0), [1]
    else:
        for ns in (V, 1, 2):
            yield mats, drow, ns, None, [0] * B


PASS_CASES = ["long", "long-1", "long-2", "dag", "ties", "wrap", "dests",
              "cycle", "ladder", "ladder-fits", "small-pool", "small-csr"]


@pytest.mark.parametrize("case", PASS_CASES)
def test_pass_emulation_matches_plain_and_jax(case):
    """The checked pass gives the plain version's (and the JAX function's)
    six rows, with the Jacobi branch taken exactly where a check fails:
    on the corpus's contigs and on random DAGs no contig is flagged; a
    cycle fails (a); a history or a CSR that outgrows the workspace fails
    (d)."""
    for mats, drow, ns, words, want_flags in _cases(case):
        got, flags = emulate_dense_sp(mats, drow, ns, words)
        assert flags == want_flags
        want = dense_sp.dense_sp_plain(
            *(torch.from_numpy(a) for a in (*mats, drow)), ns)
        jwant = jpr.dense_sp_xla(*mats, drow, n_sweeps=ns)
        for k in dense_sp.DSP_ROWS:
            np.testing.assert_array_equal(got[k], want[k].numpy(), k)
            np.testing.assert_array_equal(got[k], np.asarray(jwant[k]), k)


@pytest.mark.parametrize("case", ["ties", "wrap", "dests"])
def test_pass_emulation_matches_pallas_interpret(case):
    """The TPU kernel itself (interpret mode) on small contigs."""
    mats, drow = _dense_sp_case(2, 16, 9, case)
    got, flags = emulate_dense_sp(mats, drow, 16)
    assert flags == [0, 0]
    want = jpr.dense_sp_pallas(*mats, drow, n_sweeps=16, interpret=True)
    for k in dense_sp.DSP_ROWS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)


@pytest.mark.parametrize("seed", range(4))
def test_fold_merges_to_the_literal_cascade(seed):
    """Fold over a row's columns in any order and merged from any split
    gives the literal cascade's minima (m1..m4, nz, tot, win), columns off
    at each level included, tied and wrapped values included."""
    rng = np.random.default_rng(seed)
    V = 40
    for _ in range(200):
        n = int(rng.integers(1, V))
        cols = rng.choice(V, n, replace=False)
        big = [INF32 - 1, INF32, INF32 + 1, 2**31 - 1, -5]
        cs = rng.choice([3, 3, 4, *big], n)
        ca = rng.choice([0, 1, *big], n)
        cnz = rng.choice([0, 1, 2, -1, INF32 + 2], n)
        ctot = rng.choice([0, 1, 2, 4, -3, INF32 + 2], n)
        r = rng.choice([0, 1, *big], n)
        # the literal cascade, every column off the row contributing
        on = np.ones(n, bool)
        m1 = min(INF32, cs.min())
        on &= cs == m1
        m2 = min([INF32, *ca[on]])
        on &= ca == m2
        q = np.array([_q(a, b) for a, b in zip(cnz, ctot)])
        m3 = min([float("inf"), *q[on]])
        on &= q == m3
        m4 = min([INF32, *r[on]])
        on &= r == m4
        want = (m1, m2, m3, m4, min([INF32, *cnz[on]]),
                min([INF32, *ctot[on]]), min([V, *cols[on]]))
        k, perm = int(rng.integers(0, n + 1)), rng.permutation(n)
        parts = []
        for idx in (perm[:k], perm[k:]):
            f = _Fold(V)
            for i in idx:
                f.push(int(cs[i]), int(ca[i]), int(cnz[i]), int(ctot[i]),
                       int(r[i]), int(cols[i]), V)
            parts.append(f)
        parts[0].merge(parts[1])
        f = parts[0]
        assert (*f.keys, f.nz, f.tot, f.w) == want
