"""int32 sparse relaxation of the Python plane's buckets.

PyTorch counterpart of ``alignasm_tpu/ops/relax32.py``: per contig, the
same five vectors as the dense sweep solve (lex-min (sum, anom) to dest,
anomaly floor, walk count and count of min walks saturated at
COUNT_SAT) over a padded (B, E) edge list, for buckets whose V is above
``dense_max_v`` or that a dense cell cannot hold.  ``sp_batch32`` takes
the plain path for CPU tensors and launches the hand-written kernel
(ops/cuda_relax32.py, csrc/relax32.cu) for CUDA tensors; there is no
fallback from one to the other.

The segment reductions keep ``jax.ops.segment_min``'s identity: a vertex
no edge leaves gets the dtype's maximum (2^31 - 1), not INF32.  Padded
edges (eu = ev = 0, evalid False) feed INF32 to vertex 0's minima and 0
to its sums, as in the JAX package.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops.dense import COUNT_SAT, INF32, _fixed_point

SP_ROWS = ("d_s", "d_a", "floor_a", "cnt_tot", "cnt_min")


def _seg_min(vals, seg, V: int):
    """(B, E) values -> (B, V) per-segment minima, the dtype's maximum
    where a segment has no element (``jax.ops.segment_min``)."""
    out = torch.full((vals.shape[0], V), torch.iinfo(vals.dtype).max,
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(1, seg, vals, "amin", include_self=False)


def _seg_sum(vals, seg, V: int):
    out = torch.zeros((vals.shape[0], V), dtype=vals.dtype, device=vals.device)
    return out.scatter_add(1, seg, vals)


def sp_batch32_plain(eu, ev, es, ea, evalid, src, dest, V: int, n_sweeps):
    """Plain form of ``sp_batch32`` (alignasm_tpu/ops/relax32.py:37),
    batched: (B, E) int32 edges (bool ``evalid``), (B,) src / dest ->
    (B, 5, V) int32 ``[d_s, d_a, floor_a, cnt_tot, cnt_min]``.  ``src``
    is unused, as there."""
    del src
    B, E = eu.shape
    if n_sweeps is None:
        n_sweeps = V
    dev = eu.device
    eu, ev = eu.long(), ev.long()
    inf = torch.tensor(INF32, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    on_dest = torch.zeros((B, V), dtype=torch.bool, device=dev)
    on_dest[rows, dest.long()] = True
    s0 = torch.where(on_dest, 0, inf)

    def sweep(st):
        s, a = st
        sv = s.gather(1, ev)
        ok = evalid & (sv < INF32)
        k1 = torch.where(ok, sv + es, inf)
        m1 = _seg_min(k1, eu, V)
        on = ok & (k1 == m1.gather(1, eu))
        m2 = _seg_min(torch.where(on, a.gather(1, ev) + ea, inf), eu, V)
        better = (m1 < INF32) & ((m1 < s) | ((m1 == s) & (m2 < a)))
        return torch.where(better, m1, s), torch.where(better, m2, a)

    s, a = _fixed_point(sweep, (s0, torch.zeros_like(s0)), n_sweeps)

    def sweep_anom(st):
        fv = st[0].gather(1, ev)
        c = torch.where(evalid & (fv < INF32), fv + ea, inf)
        return (torch.minimum(st[0], _seg_min(c, eu, V)),)

    (fa,) = _fixed_point(sweep_anom, (s0,), n_sweeps)
    base = on_dest.to(torch.int32)

    def counts(mask):
        def sweep_cnt(st):
            c = torch.where(mask, st[0].gather(1, ev), 0)
            return ((base + _seg_sum(c, eu, V)).clamp_max(COUNT_SAT),)

        return _fixed_point(sweep_cnt, (base,), n_sweeps)[0]

    cnt_tot = counts(evalid)
    sv = s.gather(1, ev)
    ach = evalid & (sv < INF32) & (sv + es == s.gather(1, eu)) \
        & (a.gather(1, ev) + ea == a.gather(1, eu))
    cnt_min = counts(ach)
    return torch.stack([s, a, fa, cnt_tot, cnt_min], 1)


def sp_batch32(eu, ev, es, ea, evalid, src, dest, V: int, n_sweeps=None,
               order=None, jacobi=None):
    """Distance-to-sink, anomaly floor and walk counts of a bucket
    (counterpart of alignasm_tpu/ops/relax32.py:37) -> (B, 5, V) int32.
    CPU tensors take the plain path, CUDA tensors the kernel, with
    ``order`` (B, V) int32 its hint (default: the identity; the result
    does not depend on it) and ``jacobi`` its branch count, as in
    ``ops/dense.py:dense_solve_batch``."""
    from alignasm_tpu_torch.ops.dense import _on_cuda

    if _on_cuda(eu):
        from alignasm_tpu_torch.ops import cuda_relax32

        return cuda_relax32.relax32(eu, ev, es, ea, evalid, src, dest, V,
                                    V if n_sweeps is None else n_sweeps,
                                    order, jacobi)
    return sp_batch32_plain(eu, ev, es, ea, evalid, src, dest, V, n_sweeps)


def unpack_sp(stacked_row):
    """Per-contig dict view of one (5, V) stacked result."""
    return {k: stacked_row[j] for j, k in enumerate(SP_ROWS)}
