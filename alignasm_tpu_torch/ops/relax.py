"""int64 sparse relaxation over the full PafDistance semiring.

PyTorch counterpart of ``alignasm_tpu/ops/relax.py:solve_graph_batch``
(with the packing constants of ``alignasm_tpu/ops/semiring.py``): the
Python plane runs it for the buckets whose path sums may not fit int32
(``fits32`` false: contigs whose query gaps are long, as on a
chromosome-scale scaffold with sparse alignments).
``solve_graph_batch`` takes the plain path (PyTorch ops, int64
``scatter_reduce``) for CPU tensors and launches the hand-written kernel
(ops/cuda_relax64.py, csrc/relax64.cu) for CUDA tensors; there is no
fallback from one to the other.

Distances relax as packed int64 lexicographic keys: k1 = sum << 16 |
anom, then the mapq fraction as ``QUL_ONE - (nz << 30) // tot`` and the
reference's arrival rank, the first-improvement tie-break.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops.dense import COUNT_SAT, _fixed_point
from alignasm_tpu_torch.ops.relax32 import _seg_min, _seg_sum

ANOM_BITS = 16
QUL_BITS = 30
QUL_ONE = 1 << QUL_BITS
INF = 2**62


def _qul_key(nz, tot):
    tot_safe = torch.where(tot == 0, 1, tot)
    return QUL_ONE - torch.div(nz << QUL_BITS, tot_safe, rounding_mode="floor")


def _pack_k1(s, a):
    return (s << ANOM_BITS) | a


def solve_graph_batch_plain(eu, ev, es, ea, enz, etot, erank, evalid, src,
                            dest, V: int, n_sweeps=None):
    """Plain form of ``solve_graph_batch``: one bucket of contig graphs,
    (B, E) edge arrays (``evalid`` bool, the rest integer) and (B,) src /
    dest -> dict of (B, V) int64 ``d_s, d_a, d_nz, d_tot, d_eid, floor_a,
    cnt_tot, cnt_min`` (d_eid int32), as the JAX function returns them."""
    del src  # as in the JAX package: the anomaly floor is symmetric
    B, E = eu.shape
    if n_sweeps is None:
        n_sweeps = V
    dev = eu.device
    i64 = dict(dtype=torch.int64, device=dev)
    eu, ev = eu.long(), ev.long()
    es, ea, enz, etot, erank = (x.long() for x in (es, ea, enz, etot, erank))
    inf = torch.tensor(INF, **i64)
    on_dest = torch.zeros((B, V), dtype=torch.bool, device=dev)
    on_dest[torch.arange(B, device=dev), dest.long()] = True
    zeros = torch.zeros((B, V), **i64)
    eids = torch.arange(E, dtype=torch.int64, device=dev).expand(B, E)

    def sweep(st):
        s, a, nz, tot, rank, eid = st
        sv = s.gather(1, ev)
        cs, ca = sv + es, a.gather(1, ev) + ea
        cnz, ctot = nz.gather(1, ev) + enz, tot.gather(1, ev) + etot
        ok = evalid & (sv < INF)
        ck1 = torch.where(ok, _pack_k1(cs, ca), inf)
        ck2 = _qul_key(cnz, ctot)
        # segmented lexicographic argmin over (ck1, ck2, erank)
        k1 = torch.where(ok, ck1, inf)
        m1 = _seg_min(k1, eu, V)
        on1 = ok & (k1 == m1.gather(1, eu))
        m2 = _seg_min(torch.where(on1, ck2, inf), eu, V)
        on2 = on1 & (ck2 == m2.gather(1, eu))
        m3 = _seg_min(torch.where(on2, erank, inf), eu, V)
        cur1 = torch.where(s < INF, _pack_k1(s, a), inf)
        cur2 = _qul_key(nz, tot)
        new_better = (m1 < cur1) | ((m1 == cur1) & (m2 < cur2)) | (
            (m1 == cur1) & (m2 == cur2) & (m3 < rank))
        win = ok & (erank == m3.gather(1, eu)) & new_better.gather(1, eu)
        w_eid = _seg_min(torch.where(win, eids, E), eu, V)
        got = w_eid < E
        w_c = w_eid.clamp(0, E - 1)

        def upd(cur, cand):
            return torch.where(got, cand.gather(1, w_c), cur)

        return (upd(s, cs), upd(a, ca), upd(nz, cnz), upd(tot, ctot),
                torch.where(got, erank.gather(1, w_c), rank),
                torch.where(got, w_c, eid))

    init = (torch.where(on_dest, 0, inf), zeros, zeros, zeros,
            torch.where(on_dest, -1, inf), torch.full((B, V), -1, **i64))
    s, a, nz, tot, rank, eid = _fixed_point(sweep, init, n_sweeps)

    def sweep_anom(st):
        fv = st[0].gather(1, ev)
        c = torch.where(evalid & (fv < INF), fv + ea, inf)
        return (torch.minimum(st[0], _seg_min(c, eu, V)),)

    (fa,) = _fixed_point(sweep_anom, (torch.where(on_dest, 0, inf),),
                         n_sweeps)
    base = on_dest.long()

    def counts(mask):
        def sweep_cnt(st):
            c = torch.where(mask, st[0].gather(1, ev), 0)
            return ((base + _seg_sum(c, eu, V)).clamp_max(COUNT_SAT),)

        return _fixed_point(sweep_cnt, (base,), n_sweeps)[0]

    cnt_tot = counts(evalid)
    d_k1 = torch.where(s < INF, _pack_k1(s, a), inf)
    sv = s.gather(1, ev)
    ach = evalid & (sv < INF) & (
        _pack_k1(sv + es, a.gather(1, ev) + ea) == d_k1.gather(1, eu))
    cnt_min = counts(ach)
    return dict(d_s=s, d_a=a, d_nz=nz, d_tot=tot, d_eid=eid.to(torch.int32),
                floor_a=fa, cnt_tot=cnt_tot, cnt_min=cnt_min)


def solve_graph_batch(eu, ev, es, ea, enz, etot, erank, evalid, src, dest,
                      V: int, n_sweeps=None, order=None, jacobi=None):
    """The int64 relaxation of a bucket (counterpart of
    alignasm_tpu/ops/relax.py:73) -> the dict of ``solve_graph_batch_plain``.
    CPU tensors take the plain path, CUDA tensors the kernel (which takes
    ``es`` and ``erank`` int64, the other edge arrays int32), with
    ``order`` (B, V) int32 its hint (default: the identity; the result
    does not depend on it) and ``jacobi`` its branch count, as in
    ``ops/relax32.py:sp_batch32``."""
    from alignasm_tpu_torch.ops.dense import _on_cuda

    if _on_cuda(eu):
        from alignasm_tpu_torch.ops import cuda_relax64

        return cuda_relax64.relax64(eu, ev, es, ea, enz, etot, erank, evalid,
                                    src, dest, V,
                                    V if n_sweeps is None else n_sweeps,
                                    order, jacobi)
    return solve_graph_batch_plain(eu, ev, es, ea, enz, etot, erank, evalid,
                                   src, dest, V, n_sweeps)
