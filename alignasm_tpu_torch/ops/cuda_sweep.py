"""Wrapper of the dense sweep solve kernel (csrc/sweep_dense.cu).

Counterpart of ``alignasm_tpu/ops/dense.py:dense_solve_batch`` and
``dense_solve_slabs_pallas``.  It takes CUDA tensors only and raises on
anything else; the plain versions for CPU tensors are
``ops/dense.py:solve_one`` / ``solve_slabs``.  Each entry's ``launches``
counts the calls that launched the kernel through it.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build

MAX_V = 8192


def _check_v(V: int):
    if not 1 <= V <= MAX_V:
        raise ValueError(f"V must be in [1, {MAX_V}], got {V}")


def _launch(ws, wa, dest, packed: bool, B: int, V: int, n_sweeps: int,
            out) -> None:
    lib = _build.load_library()
    dev, stream = _build.stream_of(ws)
    rc = lib.aln_sweep_dense(
        dev, ws.data_ptr(), None if wa is None else wa.data_ptr(),
        None if dest is None else dest.data_ptr(), int(packed), B, V,
        int(n_sweeps), out.data_ptr(), stream)
    _build.check(rc, "sweep_dense")


def sweep_dense_batch(ws, wa, dest, n_sweeps: int):
    """(B, V, V) int32 ``ws`` (INF32 = no edge) and ``wa``, (B,) int32
    ``dest`` -> (B, 5, V) int32 ``[d_s, d_a, floor_a, cnt_tot, cnt_min]``."""
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
    _launch(ws, wa, dest, False, B, V, n_sweeps, out)
    sweep_dense_batch.launches += 1
    return out


def sweep_dense_slabs(packed, n_sweeps: int):
    """(B, V+1, V) int32 packed slabs -> (B, 2V+4) int32 rows ``[d_s,
    d_a, floor_a@src, cnt_tot@src, cnt_min@src, src]``."""
    _build.require(packed, "packed", torch.int32, 3)
    B, V1, V = packed.shape
    if V1 != V + 1:
        raise ValueError(f"packed must be (B, V+1, V), got {tuple(packed.shape)}")
    _check_v(V)
    out = torch.empty((B, 2 * V + 4), dtype=torch.int32, device=packed.device)
    _launch(packed, None, None, True, B, V, n_sweeps, out)
    sweep_dense_slabs.launches += 1
    return out


sweep_dense_batch.launches = 0
sweep_dense_slabs.launches = 0
