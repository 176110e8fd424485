"""Wrapper of the blocked tropical triangular solve kernel
(csrc/blocked_dp.cu).

Counterpart of ``alignasm_tpu/ops/dense.py:_blocked_dp`` /
``solve_slab_topo_nxt16_blocked``.  It takes CUDA tensors only and raises
on anything else; the plain version for CPU tensors is
``ops/dense.py:solve_slab_topo_nxt16_blocked``.  ``launches`` counts the
calls that launched the kernel.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build

# The block sizes the kernel takes.  The rows do not depend on the choice
# when no edge (r, dest) comes from a row r past dest, as on exporter wires
# (csrc/blocked_dp.cu says why).
BLOCK_SIZES = (32, 64, 128)


def blocked_dp_nxt16(slabs, Bk: int):
    """(B, V+1, V) int32 slabs, Bk in BLOCK_SIZES, V a multiple of Bk up
    to 32767 -> (B, V+2) int16 gate rows ``[nxt (-1 encoded as dest),
    fast, src]``."""
    if Bk not in BLOCK_SIZES:
        raise ValueError(f"Bk must be one of {BLOCK_SIZES}, got {Bk}")
    _build.require(slabs, "slabs", torch.int32, 3)
    B, V1, V = slabs.shape
    if V1 != V + 1 or V % Bk or not Bk <= V <= 32767:
        raise ValueError(f"slabs must be (B, V+1, V) with V a multiple of "
                         f"Bk, V <= 32767; got {tuple(slabs.shape)}, "
                         f"Bk={Bk}")
    if B > 65535:
        raise ValueError(f"at most 65535 contigs per launch, got {B}")
    if slabs.data_ptr() % 16:
        raise ValueError("slabs must be 16-byte aligned")
    lib = _build.load_library()
    scratch = torch.empty((lib.aln_blocked_dp_scratch_words(), B, V),
                          dtype=torch.int32, device=slabs.device)
    out = torch.empty((B, V + 2), dtype=torch.int16, device=slabs.device)
    dev, stream = _build.stream_of(slabs)
    rc = lib.aln_blocked_dp_nxt16(dev, slabs.data_ptr(), B, V, Bk,
                                  scratch.data_ptr(), out.data_ptr(), stream)
    _build.check(rc, "blocked_dp_nxt16")
    blocked_dp_nxt16.launches += 1
    return out


blocked_dp_nxt16.launches = 0
