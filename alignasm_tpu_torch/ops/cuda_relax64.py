"""Wrapper of the int64 sparse relaxation kernel (csrc/relax64.cu).

Counterpart of ``alignasm_tpu/ops/relax.py:solve_graph_batch``.  It takes
CUDA tensors only and raises on anything else; the plain version for CPU
tensors is ``ops/relax.py:solve_graph_batch_plain``.  ``launches`` counts
the calls that launched the kernel; a ``jacobi`` tensor counts the
contigs that took the kernel's Jacobi branch (a hint that is not a
topological order, a longest path above ``n_sweeps``, a contig whose
longest path is under 3/4 of its rows, or a change history that outgrows
the pool), as in ops/cuda_sweep.py.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build
from alignasm_tpu_torch.ops.cuda_sweep import check_jacobi, check_order, ptr

MAX_V = 8192
EDGE_DTYPES = (("eu", torch.int32), ("ev", torch.int32), ("es", torch.int64),
               ("ea", torch.int32), ("enz", torch.int32),
               ("etot", torch.int32), ("erank", torch.int64),
               ("evalid", torch.bool))


def _check(edges, src, dest, V: int):
    """Types and shapes first (so a CPU caller sees them too), then the
    device: every tensor a contiguous CUDA tensor."""
    for (name, dtype), t in zip(EDGE_DTYPES, edges):
        if t.dtype != dtype or t.dim() != 2:
            raise TypeError(f"{name} must be 2-d {dtype}, got {t.dim()}-d "
                            f"{t.dtype}")
    for name, t in (("src", src), ("dest", dest)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be 1-d torch.int32, got "
                            f"{t.dim()}-d {t.dtype}")
    B, E = edges[0].shape
    if any(t.shape != edges[0].shape for t in edges) or E < 1 \
            or src.shape[0] != B or dest.shape[0] != B:
        raise ValueError("the eight edge arrays must share one (B, E) shape "
                         "with E >= 1, and src and dest be (B,)")
    if not 1 <= V <= MAX_V:
        raise ValueError(f"V must be in [1, {MAX_V}], got {V}")
    for (name, dtype), t in zip(EDGE_DTYPES, edges):
        _build.require(t, name, dtype, 2)
    _build.require(src, "src", torch.int32, 1)
    _build.require(dest, "dest", torch.int32, 1)


def relax64(eu, ev, es, ea, enz, etot, erank, evalid, src, dest, V: int,
            n_sweeps: int, order=None, jacobi=None):
    """(B, E) int32 ``eu, ev, ea, enz, etot``, int64 ``es, erank``, bool
    ``evalid``; (B,) int32 ``src`` (unused, as in JAX) and ``dest``,
    optional (B, V) int32 hint ``order`` (default: the identity) and (1,)
    int32 branch count ``jacobi`` -> dict of (B, V) int64 ``d_s, d_a,
    d_nz, d_tot, floor_a, cnt_tot, cnt_min`` and int32 ``d_eid``, as
    ``solve_graph_batch_plain`` returns them."""
    edges = (eu, ev, es, ea, enz, etot, erank, evalid)
    _check(edges, src, dest, V)
    B, E = eu.shape
    check_order(order, B, V)
    check_jacobi(jacobi)
    lib = _build.load_library()
    out = torch.empty((7, B, V), dtype=torch.int64, device=eu.device)
    eid = torch.empty((B, V), dtype=torch.int32, device=eu.device)
    flags = torch.zeros(B, dtype=torch.int32, device=eu.device)
    work = torch.empty(lib.aln_relax64_work_words(V, E) * B,
                       dtype=torch.int64, device=eu.device)
    dev, stream = _build.stream_of(eu)
    rc = lib.aln_relax64(dev, *(t.data_ptr() for t in edges), dest.data_ptr(),
                         ptr(order), B, E, V, int(n_sweeps), flags.data_ptr(),
                         ptr(jacobi),
                         work.data_ptr() if work.numel() else None,
                         out.data_ptr(), eid.data_ptr(), stream)
    _build.check(rc, "relax64")
    relax64.launches += 1
    d_s, d_a, d_nz, d_tot, floor_a, cnt_tot, cnt_min = out  # the C order
    return dict(d_s=d_s, d_a=d_a, d_nz=d_nz, d_tot=d_tot, d_eid=eid,
                floor_a=floor_a, cnt_tot=cnt_tot, cnt_min=cnt_min)


relax64.launches = 0
