"""Wrapper of the dense shortest-path kernel (csrc/dense_sp.cu).

Counterpart of ``alignasm_tpu/ops/pallas_relax.py:dense_sp_pallas``.  It
takes CUDA tensors only and raises on anything else; the plain version
for CPU tensors is ``ops/dense_sp.py:dense_sp_plain``.  ``launches``
counts the calls that launched the kernel.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build

MAX_V = 4096
ROWS = ("s", "a", "nz", "tot", "rank", "win")


def dense_sp(ws, wa, wnz, wtot, wrank, dest, n_sweeps: int):
    """Five (B, V, V) int32 matrices and a (B, 1, V) int32 dest row ->
    dict of six (B, 1, V) int32 rows ``s, a, nz, tot, rank, win``."""
    mats = (("ws", ws), ("wa", wa), ("wnz", wnz), ("wtot", wtot),
            ("wrank", wrank))
    for name, t in mats:
        _build.require(t, name, torch.int32, 3)
    _build.require(dest, "dest", torch.int32, 3)
    B, V, V2 = ws.shape
    if V2 != V or any(t.shape != ws.shape for _n, t in mats) \
            or tuple(dest.shape) != (B, 1, V):
        raise ValueError("the matrices must be (B, V, V) and dest (B, 1, V)")
    if not 1 <= V <= MAX_V:
        raise ValueError(f"V must be in [1, {MAX_V}], got {V}")
    lib = _build.load_library()
    out = torch.empty((6, B, 1, V), dtype=torch.int32, device=ws.device)
    dev, stream = _build.stream_of(ws)
    rc = lib.aln_dense_sp(dev, *(t.data_ptr() for _n, t in mats),
                          dest.data_ptr(), B, V, int(n_sweeps),
                          out.data_ptr(), stream)
    _build.check(rc, "dense_sp")
    dense_sp.launches += 1
    return dict(zip(ROWS, out))


dense_sp.launches = 0
