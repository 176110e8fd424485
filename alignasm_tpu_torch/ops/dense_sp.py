"""Dense shortest-path fixed point with the full PafDistance tie-break.

PyTorch counterpart of ``alignasm_tpu/ops/pallas_relax.py``
(``dense_sp_pallas``, its XLA twin ``dense_sp_xla`` and ``pack_dense``):
per contig, five dense (V, V) int32 edge matrices (score sum, anomaly,
mapq numerator / denominator, arrival rank; INF32 in ``ws`` where no
edge exists) relax to a fixed point in Jacobi sweeps, each a cascade of
masked row minima — (sum, anom), then the mapq fraction as an f32 key
``-(nz / max(tot, 1))``, then the arrival rank — and the winning
successor ``win`` (-1 where unreachable or at dest).

It is a library entry point: no path of the engine calls it.  ``dense_sp``
takes the plain path for CPU tensors and launches the hand-written
kernel (ops/cuda_dense_sp.py, csrc/dense_sp.cu) for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from alignasm_tpu_torch.ops.dense import INF32, _fixed_point, _on_cuda

DSP_ROWS = ("s", "a", "nz", "tot", "rank", "win")


def _qkey(nz, tot):
    """The mapq-fraction key in f32 with IEEE division, as the JAX
    package computes it."""
    return -(nz.to(torch.float32) / tot.clamp_min(1).to(torch.float32))


def dense_sp_plain(ws, wa, wnz, wtot, wrank, dest, n_sweeps: int):
    """Plain form of ``dense_sp_xla`` / ``_sweep``
    (alignasm_tpu/ops/pallas_relax.py:61, :131): five (B, V, V) int32
    matrices and a (B, 1, V) int32 dest row -> dict of six (B, 1, V)
    int32 state rows ``s, a, nz, tot, rank, win``."""
    B, V, _ = ws.shape
    dev = ws.device
    inf = torch.tensor(INF32, dtype=torch.int32, device=dev)
    vidx = torch.arange(V, dtype=torch.int32, device=dev)
    is_dest = vidx[None, :] == dest[:, 0, :]
    has_edge = ws < INF32
    vcol = vidx.expand(B, V, V)

    def sweep(st):
        s, a, nz, tot, rank, win = st
        valid = has_edge & (s[:, None, :] < INF32)
        cs = torch.where(valid, ws + s[:, None, :], inf)
        m1 = cs.amin(2, keepdim=True)
        on = valid & (cs == m1)
        ca = torch.where(on, wa + a[:, None, :], inf)
        m2 = ca.amin(2, keepdim=True)
        on = on & (ca == m2)
        cnz = wnz + nz[:, None, :]
        ctot = wtot + tot[:, None, :]
        qkm = torch.where(on, _qkey(cnz, ctot), float("inf"))
        m3 = qkm.amin(2, keepdim=True)
        on = on & (qkm == m3)
        rk = torch.where(on, wrank, inf)
        m4 = rk.amin(2, keepdim=True)
        on = on & (rk == m4)
        nzv = torch.where(on, cnz, inf).amin(2)
        totv = torch.where(on, ctot, inf).amin(2)
        wv = torch.where(on, vcol, V).amin(2)
        inc_q = _qkey(nz, tot)
        c1, c2, c3, c4 = m1[..., 0], m2[..., 0], m3[..., 0], m4[..., 0]
        better = (c1 < s) | ((c1 == s) & ((c2 < a) | ((c2 == a) & (
            (c3 < inc_q) | ((c3 == inc_q) & (c4 < rank))))))
        better = better & (c1 < INF32)
        return tuple(torch.where(better, new, old) for new, old in
                     zip((c1, c2, nzv, totv, c4, wv), st))

    zero = torch.zeros((B, V), dtype=torch.int32, device=dev)
    init = (torch.where(is_dest, 0, inf), zero, zero, zero,
            torch.where(is_dest, -1, inf), torch.full_like(zero, -1))
    state = _fixed_point(sweep, init, n_sweeps)
    return {k: v[:, None, :] for k, v in zip(DSP_ROWS, state)}


def dense_sp(ws, wa, wnz, wtot, wrank, dest, n_sweeps: int):
    """Batched dense shortest-path fixed point (counterpart of
    alignasm_tpu/ops/pallas_relax.py:147): ws..wrank (B, V, V) int32,
    dest (B, 1, V) int32 -> dict of six (B, 1, V) int32 rows.  CPU
    tensors take the plain path, CUDA tensors the kernel."""
    if _on_cuda(ws):
        from alignasm_tpu_torch.ops import cuda_dense_sp

        return cuda_dense_sp.dense_sp(ws, wa, wnz, wtot, wrank, dest, n_sweeps)
    return dense_sp_plain(ws, wa, wnz, wtot, wrank, dest, n_sweeps)


def pack_dense(pg, V: int):
    """Dense (V, V) int32 edge matrices of a PackedGraph (copy of
    alignasm_tpu/ops/pallas_relax.py:pack_dense): (ws, wa, wnz, wtot,
    wrank) numpy arrays, ranks re-ranked densely into int32, or None when
    the contig exceeds the int32 / dense bounds."""
    n_v = pg.g.n_vertices
    if n_v > V:
        return None
    es = pg.es
    if len(es) and (es.max() >= 2**28 or len(es) > V * V):
        return None
    ws = np.full((V, V), INF32, np.int32)
    wa = np.zeros((V, V), np.int32)
    wnz = np.zeros((V, V), np.int32)
    wtot = np.zeros((V, V), np.int32)
    wrank = np.full((V, V), INF32, np.int32)
    order = np.argsort(pg.erank, kind="stable")
    dense_rank = np.empty(len(order), np.int64)
    dense_rank[order] = np.arange(len(order))
    ws[pg.eu, pg.ev] = es.astype(np.int32)
    wa[pg.eu, pg.ev] = pg.ea
    wnz[pg.eu, pg.ev] = pg.enz
    wtot[pg.eu, pg.ev] = pg.etot
    wrank[pg.eu, pg.ev] = dense_rank.astype(np.int32)
    return ws, wa, wnz, wtot, wrank
