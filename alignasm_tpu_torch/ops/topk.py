"""Per-vertex top-K walk keys through a fixed-width candidate tensor.

PyTorch counterpart of ``alignasm_tpu/ops/topk.py`` (``topk_walks_batch``
and ``pack_edge_keys``): every vertex carries the K smallest packed walk
keys ``(score_sum << 16) | anom`` to the sink, and each Jacobi sweep
merges a vertex's children's lists through its out-edges:

    cand[u, v*K + j] = wk1[u, v] + tk[v, j]   where wk1[u, v] < INF, else INF
    tk'[u] = the K smallest of cand[u]         (dest's row reset each sweep)

After |longest path| sweeps ``tk[src]`` holds the (sum, anom) keys of the
first K walks of the Eppstein engine (engine/kshortest.py).  The int64
arithmetic wraps, and the order is JAX's ``top_k(-cand)``: a candidate
equal to -2**63 (whose negation wraps to itself) sorts last.

It is a library entry point: no path of the engine calls it.
``topk_walks_batch`` takes the plain path for CPU tensors and launches
the hand-written kernel (ops/cuda_topk.py, csrc/topk.cu) for CUDA
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from alignasm_tpu_torch.ops.dense import _fixed_point, _on_cuda

INF = 2**62
# int64 cells of one chunk's (b, V, V*K) candidate tensor: a V = 512,
# K = 16 batch runs 32 contigs at a time, ~1 GB a tensor
CHUNK_CELLS = 2**27


def pack_edge_keys(pg, V: int) -> np.ndarray:
    """Dense (V, V) packed (sum << 16 | anom) edge-key matrix of a
    PackedGraph (copy of alignasm_tpu/ops/topk.py:pack_edge_keys)."""
    wk1 = np.full((V, V), np.int64(INF))
    wk1[pg.eu, pg.ev] = (pg.es.astype(np.int64) << 16) | pg.ea
    return wk1


def _plain_chunk(wk1, dest, V: int, K: int, n_sweeps: int):
    b = wk1.shape[0]
    dev = wk1.device
    inf = torch.tensor(INF, dtype=torch.int64, device=dev)
    rows = torch.arange(V, device=dev)
    d = dest.long()
    # the initial empty walk sits at row dest, a negative dest counted
    # from the end as JAX's index counts it, none where dest is out of
    # range; only a dest in [0, V) is reset after each sweep
    r0 = torch.where(d < 0, d + V, d)
    base = torch.full((b, V, K), INF, dtype=torch.int64, device=dev)
    base[:, :, 0] = torch.where(rows[None, :] == r0[:, None], 0, inf)
    is_dest = (rows[None, :] == d[:, None])[:, :, None]
    dest_row = torch.full((K,), INF, dtype=torch.int64, device=dev)
    dest_row[0] = 0
    edge = (wk1 < INF)[..., None]
    w = wk1[..., None]

    def sweep(st):
        (tk,) = st
        cand = torch.where(edge, w + tk[:, None, :, :], inf).reshape(
            b, V, V * K)
        fresh = -torch.topk(-cand, K, dim=2, largest=True, sorted=True).values
        return (torch.where(is_dest, dest_row, fresh),)

    return _fixed_point(sweep, (base,), n_sweeps)[0]


def topk_walks_batch_plain(wk1, dest, V: int, K: int, n_sweeps: int):
    """Plain form of ``topk_walks_batch`` (alignasm_tpu/ops/topk.py:35):
    (B, V, V) int64 packed edge keys (INF or above: no edge) and (B,)
    int32 dest -> (B, V, K) int64 keys, each row ascending in top_k's
    order.  Runs the sweeps in chunks of contigs of at most
    ``CHUNK_CELLS`` candidates, each chunk stopped at its fixed point
    (every later sweep would return the same lists)."""
    B = wk1.shape[0]
    out = torch.empty((B, V, K), dtype=torch.int64, device=wk1.device)
    step = max(1, CHUNK_CELLS // (V * V * K))
    for lo in range(0, B, step):
        out[lo:lo + step] = _plain_chunk(wk1[lo:lo + step],
                                         dest[lo:lo + step], V, K, n_sweeps)
    return out


def topk_walks_batch(wk1, dest, V: int, K: int, n_sweeps: int, sweeps=None):
    """Batched top-K walk keys (counterpart of
    alignasm_tpu/ops/topk.py:35): wk1 (B, V, V) int64, dest (B,) int32 ->
    (B, V, K) int64.  CPU tensors take the plain path, CUDA tensors the
    kernel (which adds the sweeps it ran, summed over the contigs, to
    ``sweeps`` when given)."""
    if _on_cuda(wk1):
        from alignasm_tpu_torch.ops import cuda_topk

        return cuda_topk.topk_walks_batch(wk1, dest, V, K, n_sweeps, sweeps)
    return topk_walks_batch_plain(wk1, dest, V, K, n_sweeps)
