"""Wrapper of the reverse-topological scan kernel (csrc/topo_scan.cu).

Counterpart of ``alignasm_tpu/ops/pallas_topo.py``.  It takes CUDA
tensors only and raises on anything else; the plain version for CPU
tensors is ``ops/dense.py:solve_slab_topo_nxt8``.  ``launches`` counts
the calls that launched the kernel.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build


def topo_scan_nxt8(slabs):
    """(B, V+1, V) int32 slabs, 2 <= V <= 256 (row V holds [dest, src])
    -> (B, V+2) uint8 gate rows ``[nxt (-1 encoded as dest), fast,
    src]``."""
    _build.require(slabs, "slabs", torch.int32, 3)
    B, V1, V = slabs.shape
    if V1 != V + 1 or not 2 <= V <= 256:
        raise ValueError(f"slabs must be (B, V+1, V) with 2 <= V <= 256, "
                         f"got {tuple(slabs.shape)}")
    lib = _build.load_library()
    out = torch.empty((B, V + 2), dtype=torch.uint8, device=slabs.device)
    dev, stream = _build.stream_of(slabs)
    rc = lib.aln_topo_scan_nxt8(dev, slabs.data_ptr(), B, V, out.data_ptr(),
                                stream)
    _build.check(rc, "topo_scan_nxt8")
    topo_scan_nxt8.launches += 1
    return out


topo_scan_nxt8.launches = 0
