"""Wrapper of the dense sweep solve kernel (csrc/sweep_dense.cu).

Counterpart of ``alignasm_tpu/ops/dense.py:dense_solve_batch`` and
``dense_solve_slabs_pallas``.  It takes CUDA tensors only and raises on
anything else; the plain versions for CPU tensors are
``ops/dense.py:solve_one`` / ``solve_slabs``.  Each entry's ``launches``
counts the calls that launched the kernel through it.  An entry given a
``jacobi`` tensor (one int32 on the card) adds to it the number of
contigs that took the kernel's Jacobi branch, on the call's stream: a
contig whose hint ``order`` is not a topological order, whose longest
path exceeds ``n_sweeps``, or whose cells could wrap an int32 sum
(csrc/topo_pass.cuh).
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build

MAX_V = 8192


def _check_v(V: int):
    if not 1 <= V <= MAX_V:
        raise ValueError(f"V must be in [1, {MAX_V}], got {V}")


def check_order(order, B: int, V: int):
    """The hint's check: None, or a contiguous (B, V) int32 CUDA tensor
    (``order[b, t]`` the vertex at topological position t)."""
    if order is None:
        return
    _build.require(order, "order", torch.int32, 2)
    if tuple(order.shape) != (B, V):
        raise ValueError(f"order must be (B, V) = ({B}, {V}), got "
                         f"{tuple(order.shape)}")


def check_jacobi(jacobi, name: str = "jacobi"):
    """A branch count's check: None, or a one-element int32 CUDA
    tensor."""
    if jacobi is None:
        return
    _build.require(jacobi, name, torch.int32, 1)
    if jacobi.numel() != 1:
        raise ValueError(f"{name} must hold one int32, got "
                         f"{tuple(jacobi.shape)}")


def ptr(t):
    """A tensor's device pointer, or None for no tensor."""
    return None if t is None else t.data_ptr()


def _launch(ws, wa, dest, order, jacobi, packed: bool, B: int, V: int,
            n_sweeps: int, out):
    """Launch the kernel: its pass, then its Jacobi branch."""
    check_order(order, B, V)
    check_jacobi(jacobi)
    lib = _build.load_library()
    dev, stream = _build.stream_of(ws)
    flags = torch.zeros(B, dtype=torch.int32, device=ws.device)
    work = torch.empty(lib.aln_sweep_dense_work_words(V) * B,
                       dtype=torch.int32, device=ws.device)
    rc = lib.aln_sweep_dense(
        dev, ws.data_ptr(), ptr(wa), ptr(dest), ptr(order), int(packed), B,
        V, int(n_sweeps), flags.data_ptr(), ptr(jacobi),
        work.data_ptr() if work.numel() else None, out.data_ptr(), stream)
    _build.check(rc, "sweep_dense")


def sweep_dense_batch(ws, wa, dest, n_sweeps: int, order=None, jacobi=None):
    """(B, V, V) int32 ``ws`` (INF32 = no edge) and ``wa``, (B,) int32
    ``dest``, optional (B, V) int32 hint ``order`` and (1,) int32 branch
    count ``jacobi`` -> (B, 5, V) int32 ``[d_s, d_a, floor_a, cnt_tot,
    cnt_min]``."""
    _build.require(ws, "ws", torch.int32, 3)
    _build.require(wa, "wa", torch.int32, 3)
    _build.require(dest, "dest", torch.int32, 1)
    B, V, V2 = ws.shape
    if V2 != V or wa.shape != ws.shape or dest.shape[0] != B:
        raise ValueError(f"ws, wa must be (B, V, V) and dest (B,); got "
                         f"{tuple(ws.shape)}, {tuple(wa.shape)}, "
                         f"{tuple(dest.shape)}")
    _check_v(V)
    out = torch.empty((B, 5, V), dtype=torch.int32, device=ws.device)
    _launch(ws, wa, dest, order, jacobi, False, B, V, n_sweeps, out)
    sweep_dense_batch.launches += 1
    return out


def sweep_dense_slabs(packed, n_sweeps: int, order=None, jacobi=None):
    """(B, V+1, V) int32 packed slabs, optional (B, V) int32 hint ``order``
    (default: the identity, the exporter's Kahn order) and branch count
    ``jacobi`` as in ``sweep_dense_batch`` -> (B, 2V+4) int32 rows ``[d_s,
    d_a, floor_a@src, cnt_tot@src, cnt_min@src, src]``."""
    _build.require(packed, "packed", torch.int32, 3)
    B, V1, V = packed.shape
    if V1 != V + 1:
        raise ValueError(f"packed must be (B, V+1, V), got {tuple(packed.shape)}")
    _check_v(V)
    out = torch.empty((B, 2 * V + 4), dtype=torch.int32, device=packed.device)
    _launch(packed, None, None, order, jacobi, True, B, V, n_sweeps, out)
    sweep_dense_slabs.launches += 1
    return out


sweep_dense_batch.launches = 0
sweep_dense_slabs.launches = 0
