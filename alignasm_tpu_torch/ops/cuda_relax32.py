"""Wrapper of the int32 sparse relaxation kernel (csrc/relax32.cu).

Counterpart of ``alignasm_tpu/ops/relax32.py:sp_batch32``.  It takes CUDA
tensors only and raises on anything else; the plain version for CPU
tensors is ``ops/relax32.py:sp_batch32_plain``.  ``launches`` counts the
calls that launched the kernel.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build

MAX_V = 8192


def relax32(eu, ev, es, ea, evalid, src, dest, V: int, n_sweeps: int):
    """(B, E) int32 ``eu, ev, es, ea`` and bool ``evalid``, (B,) int32
    ``src`` (unused, as in JAX) and ``dest`` -> (B, 5, V) int32 ``[d_s,
    d_a, floor_a, cnt_tot, cnt_min]``."""
    del src
    for name, t in (("eu", eu), ("ev", ev), ("es", es), ("ea", ea)):
        _build.require(t, name, torch.int32, 2)
    _build.require(evalid, "evalid", torch.bool, 2)
    _build.require(dest, "dest", torch.int32, 1)
    B, E = eu.shape
    if any(t.shape != eu.shape for t in (ev, es, ea, evalid)) \
            or dest.shape[0] != B or E < 1:
        raise ValueError("eu, ev, es, ea, evalid must share one (B, E) shape "
                         "with E >= 1, and dest be (B,)")
    if not 1 <= V <= MAX_V:
        raise ValueError(f"V must be in [1, {MAX_V}], got {V}")
    lib = _build.load_library()
    out = torch.empty((B, 5, V), dtype=torch.int32, device=eu.device)
    dev, stream = _build.stream_of(eu)
    rc = lib.aln_relax32(dev, eu.data_ptr(), ev.data_ptr(), es.data_ptr(),
                         ea.data_ptr(), evalid.data_ptr(), dest.data_ptr(),
                         B, E, V, int(n_sweeps), out.data_ptr(), stream)
    _build.check(rc, "relax32")
    relax32.launches += 1
    return out


relax32.launches = 0
