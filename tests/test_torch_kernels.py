"""The port's CUDA kernels against their plain PyTorch versions, and the
checks around them that need no card.

This file imports no JAX, so it also runs where JAX is not installed:
on a machine with a CUDA device, ``python -m pytest
tests/test_torch_kernels.py --noconftest -q`` runs the ``gpu`` tests,
which skip where there is no CUDA device.  Inputs are random
topo-ordered DAG wires made with numpy from a seed; everything is
integer, so the tolerance is bit-equality.
"""

import numpy as np
import pytest
import torch

from alignasm_tpu_torch.ops import dense as tdense
from alignasm_tpu_torch.ops.dense import ANOM_SHIFT
from alignasm_tpu_torch.ops.wire import (
    as_device, ragged_to_device, wire16_to_device,
)


def _np(t):
    return t.cpu().numpy()


def _rand_wire(B, V, density, seed, nv=None, score_max=1000):
    """Random topo-ordered DAGs in the ragged wire layout (as
    tests/test_dense.py:_rand_wire), dest at nv-1, src at 0."""
    rng = np.random.default_rng(seed)
    entries = []
    for b in range(B):
        n = nv or V
        mask = np.triu(rng.random((V, V)) < density, k=1)
        mask[n - 1:, :] = False
        mask[:, n:] = False
        us, vs = np.nonzero(mask)
        ws = rng.integers(0, score_max, len(us)).astype(np.int64)
        wa = rng.integers(0, 4, len(us)).astype(np.int64)
        val = (ws | (wa << ANOM_SHIFT)).astype(np.int32)
        base = b * V * (V + 1)
        ent = np.stack([base + us * V + vs, val])
        extra = np.array([[base + V * V, base + V * V + 1], [n - 1, 0]])
        entries.append(np.concatenate([ent, extra], axis=1))
    w = np.concatenate(entries, axis=1).astype(np.int32)
    trash = np.array([[B * V * (V + 1)], [0]], np.int32)
    return np.concatenate([w, np.repeat(trash, 5, axis=1)], axis=1)


def _ragged_to_wire16(wire, B, V):
    """Encode a ragged wire in the 16-bit layout (export.cc:
    aln_export_wire16): sorted cells as u16 deltas, values as u16 indices
    into a table, a power-of-two stream with trash-directed padding."""
    trash = B * V * (V + 1)
    real = wire[0] < trash
    order = np.argsort(wire[0][real], kind="stable")
    cells = wire[0][real][order].astype(np.int64)
    vals = wire[1][real][order]
    deltas = np.diff(cells, prepend=0)
    assert (deltas < 2**16).all()
    table, inv = np.unique(vals, return_inverse=True)
    n_real = len(cells)
    cap = 1 << max(3, (n_real - 1).bit_length())
    d16 = np.zeros(cap, np.uint16)
    v16 = np.zeros(cap, np.uint16)
    d16[:n_real] = deltas
    v16[:n_real] = inv
    tcap = 1 << max(3, (len(table) - 1).bit_length())
    tab = np.zeros(tcap, np.int32)
    tab[: len(table)] = table
    seeds = np.full((2, 8), trash, np.int32)
    seeds[1] = 0
    return d16, v16, tab, np.int32(n_real), seeds, np.ones(B, bool)


def test_wire16_transport_keeps_u16_bytes():
    """The u16 streams travel as their 2 raw bytes and widen exactly,
    values of 2^15 and above included."""
    deltas = np.array([0, 1, 40000, 65535, 7, 0, 0, 0], np.uint16)
    vidx = np.array([65535, 32768, 2, 0, 1, 0, 0, 0], np.uint16)
    w16 = (deltas, vidx, np.arange(8, dtype=np.int32), np.int32(5),
           np.zeros((2, 8), np.int32), np.ones(1, bool))
    d, vi, _t, _s, n_real = wire16_to_device(w16, "cpu")
    assert d.dtype == torch.int16 and d.numel() * 2 == deltas.nbytes
    assert n_real == 5
    np.testing.assert_array_equal(_np(d.to(torch.int32) & 0xFFFF), deltas)
    np.testing.assert_array_equal(_np(vi.to(torch.int32) & 0xFFFF), vidx)
    np.testing.assert_array_equal(_np(tdense.wire16_positions(d)),
                                  np.cumsum(deltas.astype(np.int64)))


def test_cuda_request_without_a_card_raises(monkeypatch):
    """A CUDA device that is not available raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        as_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        ragged_to_device(_rand_wire(1, 8, 0.5, 0), "cuda")


def test_kernel_wrappers_take_only_cuda_tensors():
    from alignasm_tpu_torch.ops import cuda_blocked, cuda_densify, cuda_topo

    slabs = torch.full((2, 9, 8), tdense.INF32, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_topo.topo_scan_nxt8(slabs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_densify.densify_ragged(torch.zeros((2, 8), dtype=torch.int32), 1, 8)
    big = torch.full((1, 513, 512), tdense.INF32, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_blocked.blocked_dp_nxt16(big, 32)
    assert cuda_topo.topo_scan_nxt8.launches == 0
    assert cuda_blocked.blocked_dp_nxt16.launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("V,density,seed,nv", [
    (8, 0.5, 0, None), (64, 0.05, 1, 40), (128, 0.9, 2, None),
    (256, 0.05, 3, 150), (256, 0.9, 4, None),
])
def test_kernels_match_plain_on_the_card(cuda_device, V, density, seed, nv):
    """Both densify kernels and the scan kernel bit-equal their plain
    versions on the same CUDA tensors."""
    from alignasm_tpu_torch.ops import cuda_densify, cuda_topo

    B = 37
    w = _rand_wire(B, V, density, seed, nv)
    rag = ragged_to_device(w, cuda_device)
    slabs = cuda_densify.densify_ragged(rag, B, V)
    assert torch.equal(slabs, tdense.densify_wire_ragged(rag, B, V))
    rows = cuda_topo.topo_scan_nxt8(slabs)
    assert torch.equal(rows, tdense.solve_slab_topo_nxt8(slabs))
    if V <= 128:
        args = wire16_to_device(_ragged_to_wire16(w, B, V), cuda_device)
        assert torch.equal(cuda_densify.densify_wire16(*args, B, V), slabs)
        assert torch.equal(tdense.densify_wire16(*args, B, V), slabs)


@pytest.mark.gpu
@pytest.mark.parametrize("Bk", [32, 64])
@pytest.mark.parametrize("V,density,seed,nv", [
    (512, 0.08, 9, None),     # random DAG
    (512, 0.0005, 4, None),   # mostly unreachable
    (512, 0.05, 3, 300),      # padding past nv (dest mid-slab)
    (1024, 0.02, 1, None),
    (1024, 0.9, 2, 900),      # near-complete: deep tie sets, saturation
])
def test_blocked_kernel_matches_plain_on_the_card(cuda_device, V, density,
                                                  seed, nv, Bk):
    """The blocked solve kernel bit-equals its plain version, with a
    padding slab (all INF32, dest = src = 0) behind the random ones."""
    from alignasm_tpu_torch.ops import cuda_blocked

    B = 3
    rag = ragged_to_device(_rand_wire(B, V, density, seed, nv), cuda_device)
    pad = torch.full((1, V + 1, V), tdense.INF32, dtype=torch.int32,
                     device=cuda_device)
    pad[0, V, :2] = 0
    slabs = torch.cat([tdense.densify_wire_ragged(rag, B, V), pad])
    rows = cuda_blocked.blocked_dp_nxt16(slabs, Bk)
    assert torch.equal(rows, tdense.solve_slab_topo_nxt16_blocked(slabs, Bk))
    assert rows[-1, V] == 1  # the padding slab: src = dest, fast


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["synth50", "synth_hard"])
def test_cuda_slice_matches_goldens(cuda_device, tmp_path, name):
    """The main path through the kernels writes the committed goldens."""
    import dataclasses
    from pathlib import Path

    from alignasm_tpu.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.ops import launch_counts, reset_launch_counts
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    data = Path(__file__).resolve().parent / "data"
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    reset_launch_counts()
    solve_dataset_torch(None, cfg, src_paths=(str(data / f"{name}.paf"), None),
                        write_prefix=str(tmp_path / name), device=cuda_device)
    stats = solve_dataset_torch.last_stats
    assert "device_error" not in stats and stats["device"] > 0, stats
    counts = launch_counts()
    assert counts["topo_scan"] + counts["blocked_dp"] == stats["dense_buckets"]
    for suf in ("", ".alt", ".all"):
        got = (tmp_path / f"{name}.aln{suf}.paf").read_bytes()
        assert got == (data / f"{name}.aln{suf}.paf").read_bytes(), suf
