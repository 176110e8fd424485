"""Wrapper of the top-K walk kernel (csrc/topk.cu).

Counterpart of ``alignasm_tpu/ops/topk.py:topk_walks_batch``.  It takes
CUDA tensors only and raises on anything else; the plain version for CPU
tensors is ``ops/topk.py:topk_walks_batch_plain``.  ``launches`` counts
the calls that launched the kernel.  Given a ``sweeps`` tensor (one int32
on the card), a call adds to it, on its stream, the sweeps the kernel ran
summed over the contigs: each contig stops at the first sweep that
changes none of its keys.

A block holds a contig's keys, its compacted edges (a CSR of
``EDGES_PER_VERTEX`` V edges), its active-row lists and masks and a few
staging rows in shared memory, ``smem_bytes(V, K)`` bytes, at most
``SMEM_MAX``: V <= 512 at K <= 49, V <= 256 at K <= 106, V <= 1024 at
K <= 21, V <= 2048 at K <= 7; a larger (V, K) raises ValueError.  The
kernel also uses the output tensor as scratch until it writes the result.
"""

from __future__ import annotations

import torch

from alignasm_tpu_torch.ops import _build
from alignasm_tpu_torch.ops.cuda_sweep import check_jacobi, ptr

ROW_CAP = 32             # csrc/topk.cu kRowCap: edges a row keeps in the CSR
EDGES_PER_VERTEX = 4     # csrc/topk.cu kEdgesPerVertex: the CSR's budget
SMEM_MAX = 227 * 1024    # csrc/topk.cu kSmemMax
MAX_THREADS = 512        # csrc/topk.cu kMaxThreads
GROUP_LANES = 8          # csrc/topk.cu kGroupLanes: lanes a row at most
I32_MAX = 2**31 - 1


def smem_bytes(V: int, K: int) -> int:
    """csrc/topk.cu layout(V, K).total: the (V, K) int64 keys, the CSR (an
    int64 key and a uint16 column for each of EDGES_PER_VERTEX V edges),
    the staging rows (a row of K keys for each lane group, K <= 32) or the
    warps' compaction buffers, whichever is larger, two V-bit
    masks, four counters, and per vertex a uint16 row start, degree and
    two active-list entries."""
    threads = MAX_THREADS if V >= MAX_THREADS else (V + 31) // 32 * 32
    lanes = min(1 << (K - 1).bit_length(), GROUP_LANES) if K <= 32 else 0
    stage = threads // lanes if lanes else 0
    E = EDGES_PER_VERTEX * V
    staging = max(8 * stage * K, threads // 32 * ROW_CAP * 10)
    return (8 * V * K + 10 * E + staging + 8 * ((V + 31) // 32) + 16
            + 8 * V)


def _check(wk1, dest, V: int, K: int, n_sweeps: int):
    """Types and shapes first (so a CPU caller sees them too), then the
    device: every tensor a contiguous CUDA tensor."""
    if wk1.dtype != torch.int64 or wk1.dim() != 3:
        raise TypeError(f"wk1 must be 3-d torch.int64, got {wk1.dim()}-d "
                        f"{wk1.dtype}")
    if dest.dtype != torch.int32 or dest.dim() != 1:
        raise TypeError(f"dest must be 1-d torch.int32, got {dest.dim()}-d "
                        f"{dest.dtype}")
    B = wk1.shape[0]
    if tuple(wk1.shape) != (B, V, V) or dest.shape[0] != B:
        raise ValueError(f"wk1 must be (B, V, V) with V = {V} and dest (B,), "
                         f"got {tuple(wk1.shape)} and {tuple(dest.shape)}")
    if V < 1 or K < 1:
        raise ValueError(f"V and K must be >= 1, got V = {V}, K = {K}")
    if smem_bytes(V, K) > SMEM_MAX:
        raise ValueError(
            f"V = {V}, K = {K} needs {smem_bytes(V, K)} bytes of shared "
            f"memory a block (8 V K keys, {10 * EDGES_PER_VERTEX + 8} V of "
            f"edges and lists, staging rows), over the {SMEM_MAX} it "
            f"holds: V <= 512 at K <= 49, V <= 1024 at K <= 21")
    if n_sweeps > I32_MAX:
        raise ValueError(f"n_sweeps must fit int32, got {n_sweeps}")
    _build.require(wk1, "wk1", torch.int64, 3)
    _build.require(dest, "dest", torch.int32, 1)


def topk_walks_batch(wk1, dest, V: int, K: int, n_sweeps: int, sweeps=None):
    """(B, V, V) int64 ``wk1``, (B,) int32 ``dest`` and an optional (1,)
    int32 sweep count ``sweeps`` -> (B, V, K) int64 keys, as
    ``topk_walks_batch_plain`` returns them."""
    n_sweeps = int(n_sweeps)
    _check(wk1, dest, V, K, n_sweeps)
    check_jacobi(sweeps, "sweeps")
    lib = _build.load_library()
    B = wk1.shape[0]
    out = torch.empty((B, V, K), dtype=torch.int64, device=wk1.device)
    dev, stream = _build.stream_of(wk1)
    rc = lib.aln_topk(dev, wk1.data_ptr(), dest.data_ptr(), B, V, K,
                      max(n_sweeps, 0), ptr(sweeps), out.data_ptr(), stream)
    _build.check(rc, "topk")
    topk_walks_batch.launches += 1
    return out


topk_walks_batch.launches = 0
