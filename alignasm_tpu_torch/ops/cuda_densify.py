"""Wrappers of the wire-densify kernels (csrc/densify.cu).

They take CUDA tensors only and raise on anything else; the plain
versions for CPU tensors are ``ops/dense.py:densify_wire_ragged`` and
``densify_wire16``.  Each wrapper counts its calls that launched the
kernel in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build
from alignasm_tpu_torch.ops.cuda_sweep import check_jacobi, ptr
from alignasm_tpu_torch.ops.dense import INF32


def densify_ragged(wire, B: int, V: int):
    """(2, capN) int32 ragged wire -> (B, V+1, V) int32 slabs."""
    _build.require(wire, "wire", torch.int32, 2)
    if wire.shape[0] != 2:
        raise ValueError(f"wire must be (2, capN), got {tuple(wire.shape)}")
    lib = _build.load_library()
    trash = B * V * (V + 1)
    flat = torch.full((trash + 1,), INF32, dtype=torch.int32,
                      device=wire.device)
    n = wire.shape[1]
    dev, stream = _build.stream_of(wire)
    rc = lib.aln_densify_scatter(dev, wire.data_ptr(), wire[1].data_ptr(), n,
                                 trash, flat.data_ptr(), stream)
    _build.check(rc, "densify_ragged")
    densify_ragged.launches += 1
    return flat[:trash].view(B, V + 1, V)


densify_ragged.launches = 0


def densify_wire16(deltas, vidx, table, seeds, n_real: int, B: int, V: int,
                   scatter_branch=None):
    """16-bit wire (raw u16 ``deltas``/``vidx`` in int16 tensors, int32
    ``table``, (2, S) int32 ``seeds``) -> (B, V+1, V) int32 slabs, each
    cell written once from a tile of the kernel (no pre-fill, no trash
    cell).  ``scatter_branch``, if given (one int32 on the card), gets 1
    added on the call's stream when the positions wrap int32 and the
    kernel's per-entry scatter branch runs."""
    for t, name in ((deltas, "deltas"), (vidx, "vidx")):
        _build.require(t, name, torch.int16, 1)
    _build.require(table, "table", torch.int32, 1)
    _build.require(seeds, "seeds", torch.int32, 2)
    check_jacobi(scatter_branch, "scatter_branch")
    if vidx.shape != deltas.shape or seeds.shape[0] != 2:
        raise ValueError("vidx must match deltas and seeds must be (2, S)")
    if table.shape[0] < 1:
        raise ValueError("table must hold at least one value")
    cells = B * V * (V + 1)
    if not 1 <= cells < 2**31:
        raise ValueError(f"B * V * (V+1) = {cells} must be in [1, 2^31)")
    lib = _build.load_library()
    n_real = max(0, min(int(n_real), deltas.shape[0]))
    flat = torch.empty((cells,), dtype=torch.int32, device=deltas.device)
    scratch = torch.empty(lib.aln_densify_wire16_scratch_words(n_real, cells),
                          dtype=torch.int32, device=deltas.device)
    dev, stream = _build.stream_of(deltas)
    rc = lib.aln_densify_wire16(
        dev, deltas.data_ptr(), vidx.data_ptr(), table.data_ptr(),
        table.shape[0], seeds.data_ptr(), seeds.shape[1], n_real, cells,
        scratch.data_ptr(), flat.data_ptr(), ptr(scatter_branch), stream)
    _build.check(rc, "densify_wire16")
    densify_wire16.launches += 1
    return flat.view(B, V + 1, V)


densify_wire16.launches = 0
