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
from alignasm_tpu_torch.ops.topk import INF as TOPK_INF
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


def _wire16_case(B, V, seed, filler=False, pad=0, unsorted=False,
                 bad_vidx=False, wrap=False, dup=False):
    """A 16-bit wire of B random DAGs (``_rand_wire`` encoded as
    ``_ragged_to_wire16`` does) over padB = B + ``pad`` slabs, with seeds
    seeding the padding contigs' dest/src cells and padded with the trash
    cell as export.cc writes them, and entries past n_real that are not
    zeros.  Variants: ``filler`` rewrites contig 1's span as the exporter
    rewrites a rejected contig's (its dest cell, then zero deltas that
    repeat its src cell with value 0); ``unsorted`` shuffles the seeds;
    ``bad_vidx`` points a few entries past the table (a JAX gather
    clamps); ``wrap`` (pad >= 1) appends u16 deltas that carry the int32
    positions past 2^31 (dropped), around 2^32 and back into the first
    padding slab's first rows, cells no other entry or seed writes;
    ``dup`` repeats a few cells right after themselves with other values
    (a serial scatter keeps the last) and follows the first seed with two
    more pairs of its cell (values 7, then 9).  Returns (the wire as
    export_wire16 returns it, padB)."""
    rng = np.random.default_rng(seed)
    M = V * (V + 1)
    padB = B + pad
    trash = padB * M
    w = _rand_wire(B, V, 0.3, seed)
    real = w[0] < B * M
    order = np.argsort(w[0][real], kind="stable")
    cells = w[0][real][order].astype(np.int64)
    vals = w[1][real][order].astype(np.int64)
    if filler:
        lo, hi = np.searchsorted(cells, [M, 2 * M])
        cells[lo:hi] = M + V * V + 1
        cells[lo] = M + V * V
        vals[lo:hi] = 0
    if dup:
        k = np.sort(rng.choice(len(cells), 5, replace=False))
        cells = np.insert(cells, k, cells[k])
        vals = np.insert(vals, k, rng.integers(0, 1000, 5))
    deltas = np.diff(cells, prepend=0)
    if wrap:  # every position between lies outside [0, padB * M)
        assert pad >= 1
        targets = B * M + np.array([3, 5, 17, 18])
        first = int(cells[-1]) + 65535
        k, r = divmod(2**32 + int(targets[0]) - 65535 - first, 65535)
        deltas = np.concatenate([deltas, np.full(k + 1, 65535), [r, 65535],
                                 np.diff(targets)])
        vals = np.concatenate([vals, rng.integers(0, 1000, k + 3 + 3)])
    assert ((deltas >= 0) & (deltas < 2**16)).all()
    table, inv = np.unique(vals, return_inverse=True)
    n_real = len(deltas)
    cap = 1 << max(3, n_real.bit_length())  # room past n_real
    d16 = rng.integers(0, 2**16, cap).astype(np.uint16)
    v16 = rng.integers(0, 2**16, cap).astype(np.uint16)
    d16[:n_real] = deltas
    v16[:n_real] = inv
    if bad_vidx:
        v16[rng.choice(n_real, 4, replace=False)] = [65535, 40000,
                                                     len(table), 9999]
    tcap = 1 << max(3, (len(table) - 1).bit_length())
    tab = np.zeros(tcap, np.int32)
    tab[: len(table)] = table
    S = 1 << max(3, (max(2 * pad, 1) - 1).bit_length())
    seeds = np.full((2, S), trash, np.int32)
    seeds[1] = 0
    for k in range(pad):
        seeds[0, 2 * k] = (B + k) * M + V * V
        seeds[0, 2 * k + 1] = (B + k) * M + V * V + 1
    if dup:  # still sorted: the two pairs follow the first
        seeds = np.insert(seeds, [1, 1], [[seeds[0, 0]] * 2, [7, 9]], axis=1)
    if unsorted:
        seeds = seeds[:, rng.permutation(seeds.shape[1])]
    return (d16, v16, tab, np.int32(n_real), np.ascontiguousarray(seeds),
            np.ones(B, bool)), padB


def _inf_sum_slabs(B, V):
    """Slabs whose contig b holds, at base = 3b mod (V - 7), a chain
    base+2 -> base+3 -> ... -> base+7 = dest whose score sum from base+2
    is INF32 exactly (four edges of 2^28 - 1, then 4), so row base+2 is
    unreachable and its one edge still achieves (INF32, 0), as
    ``_topo_scan``'s ``ach`` has it; src = base+2, and row base+1 reaches
    dest directly."""
    top = (1 << ANOM_SHIFT) - 1
    slabs = np.full((B, V + 1, V), tdense.INF32, np.int32)
    for b in range(B):
        o = 3 * b % (V - 7)
        for u, v, ws, wa in ((6, 7, top, 0), (5, 6, top, 0), (4, 5, top, 0),
                             (3, 4, top, 0), (2, 3, 4, 0), (1, 2, 5, 1),
                             (1, 7, 3, 0)):
            slabs[b, o + u, o + v] = ws | (wa << ANOM_SHIFT)
        slabs[b, V, :2] = (o + 7, o + 2)
    return slabs


def test_scan_counts_an_edge_whose_sum_is_exactly_inf32():
    """The plain scan keeps _topo_scan's int32 literalness: the unreachable
    row base+2 has cm = 1 and nxt = base+3 (its edge into the reachable
    base+3 sums to INF32 exactly), so the gate at src = base+2 is fast."""
    B, V = 5, 16
    (s, _a, _fa, _ct, cm, nxt), _dest, _src = tdense.topo_scan(
        torch.from_numpy(_inf_sum_slabs(B, V)))
    for b in range(B):
        o = 3 * b % (V - 7)
        assert s[b, o + 3] == tdense.INF32 - 4 and s[b, o + 2] == tdense.INF32
        assert cm[b, o + 2] == 1 and nxt[b, o + 2] == o + 3
    rows = tdense.solve_slab_topo_nxt8(torch.from_numpy(_inf_sum_slabs(B, V)))
    assert rows[:, V].tolist() == [1] * B


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
    assert cuda_blocked.BLOCK_SIZES == (32, 64, 128)
    for Bk in cuda_blocked.BLOCK_SIZES:
        with pytest.raises(ValueError, match="CUDA tensor"):
            cuda_blocked.blocked_dp_nxt16(big, Bk)
    for Bk in (0, 16, 48, 96, 256, 512):
        with pytest.raises(ValueError, match="Bk must be one of"):
            cuda_blocked.blocked_dp_nxt16(big, Bk)
    assert cuda_topo.topo_scan_nxt8.launches == 0
    assert cuda_blocked.blocked_dp_nxt16.launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _add_edges_into_dest(slabs, seed):
    """Edges (r, dest) from rows r past dest, which the scan and the
    blocked solve read as dest's column below the diagonal (dest may sit
    anywhere in a slab); returns the contigs' dests."""
    rng = np.random.default_rng(seed)
    B, _, V = slabs.shape
    dests = slabs[:, V, 0].tolist()
    for b, d in enumerate(dests):
        rows = [r for r in range(d + 1, V) if rng.random() < 0.3]
        for r in rows:
            slabs[b, r, d] = int(rng.integers(0, 1000)) | \
                (int(rng.integers(0, 4)) << ANOM_SHIFT)
    return dests


@pytest.mark.gpu
@pytest.mark.parametrize("V,density,seed,nv,into_dest", [
    (8, 0.5, 0, None, False), (64, 0.05, 1, 40, False),
    (128, 0.9, 2, None, False), (256, 0.05, 3, 150, False),
    (256, 0.9, 4, None, False),
    # one warp per contig, four contigs per CTA: B = 37 leaves the last
    # CTA partly empty; V around the 32-column lane strides and the
    # staged (V <= 64) / streamed split; V = 2 is the least V whose row V
    # holds [dest, src]
    (2, 0.5, 5, None, False), (31, 0.3, 6, 20, False),
    (33, 0.3, 7, None, False), (64, 0.9, 8, None, False),
    (65, 0.1, 9, 50, False), (200, 0.05, 10, 150, False),
    (64, 0.1, 11, 40, True), (200, 0.05, 12, 150, True),
])
def test_kernels_match_plain_on_the_card(cuda_device, V, density, seed, nv,
                                         into_dest):
    """Both densify kernels and the scan kernel bit-equal their plain
    versions on the same CUDA tensors."""
    from alignasm_tpu_torch.ops import cuda_densify, cuda_topo

    B = 37
    w = _rand_wire(B, V, density, seed, nv)
    rag = ragged_to_device(w, cuda_device)
    slabs = cuda_densify.densify_ragged(rag, B, V)
    assert torch.equal(slabs, tdense.densify_wire_ragged(rag, B, V))
    if into_dest:
        slabs = slabs.clone()
        _add_edges_into_dest(slabs, seed)
    rows = cuda_topo.topo_scan_nxt8(slabs)
    assert torch.equal(rows, tdense.solve_slab_topo_nxt8(slabs))
    if V <= 128 and not into_dest:
        args = wire16_to_device(_ragged_to_wire16(w, B, V), cuda_device)
        count = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        assert torch.equal(cuda_densify.densify_wire16(*args, B, V, count),
                           slabs)
        assert int(count) == 0  # the tiles, not the scatter branch
        assert torch.equal(tdense.densify_wire16(*args, B, V), slabs)


@pytest.mark.gpu
@pytest.mark.parametrize("case,kw", [
    ("seeds", dict(pad=3)), ("filler", dict(filler=True, pad=2)),
    ("unsorted", dict(pad=5, unsorted=True)),
    ("bad-vidx", dict(pad=1, bad_vidx=True)), ("dup", dict(pad=4, dup=True)),
    ("dup-unsorted", dict(pad=4, dup=True, unsorted=True)),
    ("wrap", dict(pad=2, wrap=True)),
    ("wrap-unsorted", dict(pad=2, wrap=True, unsorted=True, filler=True)),
    ("big", dict(pad=300, filler=True)),
    ("big-unsorted", dict(pad=300, unsorted=True)),
])
def test_wire16_kernel_matches_plain_on_the_card(cuda_device, case, kw):
    """The 16-bit densify kernel (tiles, or the scatter branch when the
    int32 positions wrap) bit-equals the plain version run on the CPU,
    where a repeated cell or seed keeps the last pair in stream order: a
    rejected contig's filler, padding seeds sorted and shuffled, repeated
    cells and seeds of other values, value indices past the table, entries
    past n_real that are not zeros, and a wire of several scan chunks
    over many tiles ("big": 316 slabs of V = 64).  ``scatter_branch`` counts the wrap."""
    from alignasm_tpu_torch.ops import cuda_densify

    B, V = (16, 64) if case.startswith("big") else (6, 8)
    w16, padB = _wire16_case(B, V, 11, **kw)
    count = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = cuda_densify.densify_wire16(*wire16_to_device(w16, cuda_device),
                                      padB, V, count)
    want = tdense.densify_wire16(*wire16_to_device(w16, "cpu"), padB, V)
    assert torch.equal(got.cpu(), want)
    assert int(count) == int("wrap" in case)


@pytest.mark.gpu
@pytest.mark.parametrize("V", [8, 64, 200])
def test_scan_kernel_counts_an_edge_whose_sum_is_exactly_inf32(cuda_device,
                                                                V):
    """The scan kernel keeps _topo_scan's `ach` where a sum is INF32
    exactly (B = 5: the last CTA holds one contig)."""
    from alignasm_tpu_torch.ops import cuda_topo

    slabs = torch.from_numpy(_inf_sum_slabs(5, V)).to(cuda_device)
    rows = cuda_topo.topo_scan_nxt8(slabs)
    assert torch.equal(rows, tdense.solve_slab_topo_nxt8(slabs))
    assert rows[:, V].tolist() == [1] * 5


@pytest.mark.gpu
@pytest.mark.parametrize("Bk", [32, 64, 128])
@pytest.mark.parametrize("V,density,seed,nv,B,into_dest", [
    (512, 0.08, 9, None, 3, False),     # random DAG
    (512, 0.0005, 4, None, 3, False),   # mostly unreachable
    (512, 0.05, 3, 300, 3, False),      # padding past nv (dest mid-slab)
    (1024, 0.02, 1, None, 3, False),
    (1024, 0.9, 2, 900, 3, False),      # near-complete: deep tie sets
    (2048, 0.01, 5, None, 1, False),    # a lone contig (B = 1)
    # dest below the last blocks, with edges into it from the rows past
    # it: the dest-below-lo cell of the nxt rule
    (1024, 0.03, 6, 200, 3, True),
    # the ceiling of device_max_v: a lone V = 16384 contig, a 1.07 GB slab
    (16384, 0.0003, 8, 16000, 1, False),
])
def test_blocked_kernel_matches_plain_on_the_card(cuda_device, V, density,
                                                  seed, nv, B, into_dest, Bk):
    """The blocked solve kernel bit-equals its plain version, with a
    padding slab (all INF32, dest = src = 0) behind the random ones, and
    (on DAG slabs) the plain scan's int16 row."""
    from alignasm_tpu_torch.ops import cuda_blocked

    rag = ragged_to_device(_rand_wire(B, V, density, seed, nv), cuda_device)
    pad = torch.full((1, V + 1, V), tdense.INF32, dtype=torch.int32,
                     device=cuda_device)
    pad[0, V, :2] = 0
    slabs = torch.cat([tdense.densify_wire_ragged(rag, B, V), pad])
    if into_dest:
        assert max(_add_edges_into_dest(slabs, seed)[:B]) < V - Bk
    rows = cuda_blocked.blocked_dp_nxt16(slabs, Bk)
    assert torch.equal(rows, tdense.solve_slab_topo_nxt16_blocked(slabs, Bk))
    # an edge (r, dest) with dest below r's block feeds the blocked rows'
    # nxt only, the scan's every value: there the rows depend on Bk
    if not into_dest:
        assert torch.equal(rows, tdense.solve_slab_topo_nxt16(slabs))
    assert rows[-1, V] == 1  # the padding slab: src = dest, fast


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["synth50", "synth_hard"])
def test_cuda_slice_matches_goldens(cuda_device, tmp_path, name):
    """The main path through the kernels writes the committed goldens."""
    import dataclasses
    from pathlib import Path

    from alignasm_tpu_torch.config import DEFAULT_CONFIG
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


def _rand_dag_mats(B, V, density, seed, nv=None):
    """Random topo-ordered DAGs as dense (B, V, V) int32 matrices: ws
    (INF32 = no edge), wa, and the mapq numerator / denominator and a
    unique arrival rank per edge; dest at nv-1 (a sink), src at 0."""
    rng = np.random.default_rng(seed)
    n = nv or V
    mask = np.triu(rng.random((B, V, V)) < density, k=1)
    mask[:, n - 1:, :] = False
    mask[:, :, n:] = False
    ws = np.where(mask, rng.integers(0, 1000, (B, V, V)), tdense.INF32)
    wa = np.where(mask, rng.integers(0, 3, (B, V, V)), 0)
    wnz = np.where(mask, rng.integers(0, 60, (B, V, V)), 0)
    wtot = np.where(mask, wnz + rng.integers(0, 60, (B, V, V)), 0)
    wrank = np.full((B, V, V), tdense.INF32)
    for b in range(B):
        k = int(mask[b].sum())
        wrank[b][mask[b]] = rng.permutation(k)
    dest = np.full(B, n - 1)
    return [a.astype(np.int32) for a in (ws, wa, wnz, wtot, wrank, dest)]


def _to(dev, *arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


DENSE_SP_CASES = ("dag", "ties", "wrap", "dests", "cycle", "ladder")


def _dense_sp_case(B, V, seed, case):
    """Dense shortest-path inputs of one case: five (B, V, V) int32
    matrices and the (B, 1, V) dest row, each contig numbered in a
    shuffled order.  "dag": position i links to up to three of the next
    16 positions, to i + 1, and to dest (position V - 1) with probability
    0.2; scores in [0, 1000), anomalies in [0, 3), mapq fractions
    nz / tot with 0 <= nz <= tot < 120, unique ranks.  "ties": scores,
    anomalies and fractions from a few values and ranks from four, so
    that candidates tie at every level.  "wrap": scores in [-2^31, 2^30)
    and anomalies, numerators, totals and ranks anywhere in int32, so
    that sums wrap and keys pass the cascade's off values.  "dests": a dest row that names
    several lanes (each one starts as a dest).  "cycle": the DAG plus an
    edge from position i + 2 back to i.  "ladder": a chain through every
    position into dest and an edge from each position to dest at three
    times the chain's cost, so that position i finds a cheaper path one
    sweep after another (about V^2 / 2 changes)."""
    rng = np.random.default_rng(seed)
    mats = [np.full((B, V, V), tdense.INF32, np.int32)]
    mats += [np.zeros((B, V, V), np.int32) for _ in range(3)]
    mats.append(np.full((B, V, V), tdense.INF32, np.int32))
    drow = np.empty((B, 1, V), np.int32)
    for b in range(B):
        if case == "ladder":
            u = np.concatenate([np.arange(V - 1), np.arange(V - 2)])
            v = np.concatenate([np.arange(1, V), np.full(V - 2, V - 1)])
        else:
            pairs = {(i, i + 1) for i in range(V - 1)}
            for i in range(V - 1):
                for j in rng.integers(i + 1, min(V, i + 17),
                                      rng.integers(0, 4)):
                    pairs.add((i, int(j)))
                if rng.random() < 0.2:
                    pairs.add((i, V - 1))
            if case == "cycle":
                pairs.add((min(2, V - 1), 0))
            u, v = np.array(sorted(pairs)).T
        k = len(u)
        if case == "ladder":
            vals = [np.where(v == u + 1, 1, 3 * (V - 1 - u)), np.zeros(k),
                    np.ones(k), np.full(k, 2), rng.permutation(k)]
        elif case == "ties":
            nz = rng.integers(0, 3, k)
            vals = [rng.integers(0, 3, k) * 100, rng.integers(0, 2, k), nz,
                    2 * nz + rng.integers(0, 2, k), rng.integers(0, 4, k)]
        elif case == "wrap":
            i32 = (-2**31, 2**31)
            vals = [rng.integers(-2**31, 2**30, k), rng.integers(*i32, k),
                    rng.integers(*i32, k), rng.integers(*i32, k),
                    rng.integers(*i32, k)]
        else:
            nz = rng.integers(0, 60, k)
            vals = [rng.integers(0, 1000, k), rng.integers(0, 3, k), nz,
                    nz + rng.integers(0, 60, k), rng.permutation(k)]
        perm = rng.permutation(V)
        for m, x in zip(mats, vals):
            m[b, perm[u], perm[v]] = x
        drow[b] = perm[V - 1]
        if case == "dests":
            lanes = rng.choice(V, 3, replace=False)
            drow[b, 0, lanes] = lanes
    return mats, drow


@pytest.mark.gpu
@pytest.mark.parametrize("V,density,seed,nv,n_sweeps", [
    (8, 0.5, 0, None, 16), (64, 0.1, 1, 40, 64), (256, 0.05, 2, None, 256),
    (256, 0.9, 3, 200, 7), (512, 0.02, 4, None, 1024),
])
def test_sweep_kernel_matches_plain_on_the_card(cuda_device, V, density, seed,
                                                nv, n_sweeps):
    """The sweep solve kernel bit-equals its plain version through both
    entries (a few sweeps, too few to converge, included)."""
    from alignasm_tpu_torch.ops import cuda_sweep

    B = 9
    ws, wa, _nz, _tot, _rk, dest = _to(
        cuda_device, *_rand_dag_mats(B, V, density, seed, nv))
    got = cuda_sweep.sweep_dense_batch(ws, wa, dest, n_sweeps)
    assert torch.equal(got, tdense.solve_one(ws, wa, ws < tdense.INF32, dest,
                                             n_sweeps))
    packed = torch.full((B, V + 1, V), tdense.INF32, dtype=torch.int32,
                        device=cuda_device)
    edge = ws < tdense.INF32
    packed[:, :V] = torch.where(edge, ws | (wa << ANOM_SHIFT), tdense.INF32)
    packed[:, V, 0] = dest
    packed[:, V, 1] = torch.arange(B, device=cuda_device) % V  # src
    rows = cuda_sweep.sweep_dense_slabs(packed, n_sweeps)
    assert torch.equal(rows, tdense.solve_slabs(packed, n_sweeps))


@pytest.mark.gpu
@pytest.mark.parametrize("V,density,seed,nv,n_sweeps", [
    (8, 0.5, 0, None, 16), (64, 0.1, 1, 40, 64), (512, 0.02, 2, 300, 512),
    (1024, 0.01, 3, None, 7),
])
def test_relax32_kernel_matches_plain_on_the_card(cuda_device, V, density,
                                                  seed, nv, n_sweeps):
    """The int32 sparse relaxation kernel bit-equals its plain version on
    padded edge lists (padding edges 0 -> 0, invalid; vertices past nv
    with no out-edge keep segment_min's identity)."""
    from alignasm_tpu_torch.ops import cuda_relax32, relax32

    B = 7
    ws, wa, _nz, _tot, _rk, dest = _rand_dag_mats(B, V, density, seed, nv)
    lists = [np.nonzero(ws[b] < tdense.INF32) for b in range(B)]
    E = 1 << max(3, (max(len(u) for u, _v in lists) + 5 - 1).bit_length())
    eu, ev, es, ea = (np.zeros((B, E), np.int32) for _ in range(4))
    evalid = np.zeros((B, E), bool)
    for b, (u, v) in enumerate(lists):
        k = len(u)
        eu[b, :k], ev[b, :k] = u, v
        es[b, :k], ea[b, :k] = ws[b][u, v], wa[b][u, v]
        evalid[b, :k] = True
    src = np.zeros(B, np.int32)
    args = _to(cuda_device, eu, ev, es, ea, evalid, src, dest)
    got = cuda_relax32.relax32(*args, V, n_sweeps)
    assert torch.equal(got, relax32.sp_batch32_plain(*args, V, n_sweeps))


@pytest.mark.gpu
@pytest.mark.parametrize("V,density,seed,nv,n_sweeps", [
    (8, 0.5, 0, None, 16), (64, 0.2, 1, 40, 64), (256, 0.05, 2, None, 256),
    (512, 0.02, 3, 400, 5),
    # rows of up to 59 edges: more than one a lane
    (128, 0.4, 5, None, 128), (128, 0.4, 5, None, 3),
])
def test_dense_sp_kernel_matches_plain_on_the_card(cuda_device, V, density,
                                                   seed, nv, n_sweeps):
    """The dense shortest-path kernel bit-equals its plain version, the
    f32 mapq-fraction key included, with no contig in its Jacobi
    branch."""
    from alignasm_tpu_torch.ops import cuda_dense_sp, dense_sp

    B = 5
    *mats, dest = _rand_dag_mats(B, V, density, seed, nv)
    mats = _to(cuda_device, *mats)
    drow = _to(cuda_device, np.repeat(dest[:, None, None], V, 2))[0]
    jacobi = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = cuda_dense_sp.dense_sp(*mats, drow, n_sweeps, jacobi)
    want = dense_sp.dense_sp_plain(*mats, drow, n_sweeps)
    for k in dense_sp.DSP_ROWS:
        assert torch.equal(got[k], want[k]), k
    assert int(jacobi) == 0  # DAGs: the checked pass


@pytest.mark.gpu
@pytest.mark.parametrize("V,case", [
    (V, case) for V in (8, 64, 256, 512)
    for case in (*DENSE_SP_CASES[:5], "short")] + [
    (64, "ladder"), (256, "ladder"), (4096, "dag"), (4096, "short")])
def test_dense_sp_kernel_pass_and_jacobi_branch_on_the_card(cuda_device, V,
                                                            case):
    """The dense shortest-path kernel's checked pass bit-equals the plain
    version on shuffled-numbering DAGs (ties at every level of the
    cascade, sums that wrap int32, several dest lanes, n_sweeps 2 below
    the longest path: "short"), with no contig in the Jacobi branch; a
    cycle (check (a)) or, at V = 256, a ladder's ~V^2 / 2 history entries
    (check (d); at V = 64 they fit) send every contig there.  V = 512
    holds the pass's workspace in one CTA's shared memory, V = 4096 in
    the global workspace; up to V = 1024 a global spill pool extends the
    history's."""
    from alignasm_tpu_torch.ops import _build, cuda_dense_sp, dense_sp

    B = 1 if V == 4096 else 3
    mats, drow = _dense_sp_case(B, V, 30 + V, "dag" if case == "short"
                                else case)
    ns = 2 if case == "short" else V
    args = _to(cuda_device, *mats, drow)
    jacobi = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = cuda_dense_sp.dense_sp(*args, ns, jacobi)
    want = dense_sp.dense_sp_plain(*args, ns)
    for k in dense_sp.DSP_ROWS:
        assert torch.equal(got[k], want[k]), k
    branch = case == "cycle" or (case == "ladder" and V == 256)
    assert int(jacobi) == (B if branch else 0)
    # beside shared memory a spill pool of 16V five-word entries, above
    # V = 1024 the whole workspace in global memory
    assert _build.load_library().aln_dense_sp_work_words(V) \
        == (80 * V if V <= 1024 else 100 * V + 8)
    n = cuda_dense_sp.dense_sp.launches
    again = dense_sp.dense_sp(*args, ns)
    assert cuda_dense_sp.dense_sp.launches == n + 1
    assert all(torch.equal(again[k], want[k]) for k in want)


def _shuffled_dag_edges(B, V, seed, chain=3):
    """Random DAGs numbered in a shuffled order, as edge lists: position i
    links to up to three later positions within 64, position V-1 is dest
    (a sink) and takes an edge from a fifth of the others, and a chain
    0 -> 1 -> ... -> ``chain`` makes every longest path at least that
    many edges (V > chain).  Returns [(u, v, ws, wa)] in the shuffled
    numbering, the dests and the hints (orders[b, t] = the vertex at
    position t)."""
    rng = np.random.default_rng(seed)
    edges, dests = [], np.empty(B, np.int32)
    orders = np.empty((B, V), np.int32)
    for b in range(B):
        pairs = {(i, i + 1) for i in range(min(chain, V - 1))}
        for i in range(V - 1):
            for j in rng.integers(i + 1, min(V, i + 65), rng.integers(0, 4)):
                pairs.add((i, int(j)))
            if rng.random() < 0.2:
                pairs.add((i, V - 1))
        u, v = np.array(sorted(pairs), np.int64).reshape(-1, 2).T
        perm = rng.permutation(V).astype(np.int32)
        edges.append((perm[u], perm[v],
                      rng.integers(0, 1000, len(u)).astype(np.int32),
                      rng.integers(0, 3, len(u)).astype(np.int32)))
        dests[b], orders[b] = perm[V - 1], perm
    return edges, dests, orders


def _pass_case(edges, dests, orders, case):
    """Edges, hints and n_sweeps of one branch case: "hint" (the pass),
    "reversed" (every edge backwards), "short" (n_sweeps = 1 below every
    contig's longest path) and "wrap" (one edge per contig whose score
    does not fit the packed cell, check (c))."""
    V = orders.shape[1]
    if case == "reversed":
        orders = orders[:, ::-1].copy()
    if case == "wrap":
        edges = [(u, v, np.where(np.arange(len(u)) == 0, (1 << 28) + 5, ws)
                  .astype(np.int32), wa) for u, v, ws, wa in edges]
    return edges, orders, 1 if case == "short" else V


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hint", "reversed", "short", "wrap"])
@pytest.mark.parametrize("V", [8, 64, 256, 512])
def test_sweep_kernel_pass_and_jacobi_branch_on_the_card(cuda_device, V,
                                                         case):
    """Both entries of the sweep solve bit-equal their plain versions on
    shuffled-numbering DAGs; with a valid hint no contig takes the Jacobi
    branch, with a reversed hint, a short n_sweeps or a cell that could
    wrap every contig does.  V = 512 runs the workspace pass; the slab
    entry's default hint (the identity) is valid on slabs numbered by
    position."""
    from alignasm_tpu_torch.ops import cuda_sweep

    B = 9
    edges, dests, orders = _shuffled_dag_edges(B, V, 20 + V)
    edges, orders, ns = _pass_case(edges, dests, orders, case)
    ws = np.full((B, V, V), tdense.INF32, np.int32)
    wa = np.zeros((B, V, V), np.int32)
    packed = np.full((B, V + 1, V), tdense.INF32, np.int32)
    for b, (u, v, s, a) in enumerate(edges):
        ws[b, u, v], wa[b, u, v] = s, a
        packed[b, u, v] = np.where(s < (1 << 28), s | (a << ANOM_SHIFT),
                                   tdense.INF32 + 5)  # (c): anomaly 4
        packed[b, V, :2] = dests[b], orders[b, 0]
    ws, wa, dest, order, packed = _to(cuda_device, ws, wa, dests, orders,
                                      packed)
    want_j = 0 if case == "hint" else B
    jacobi = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = cuda_sweep.sweep_dense_batch(ws, wa, dest, ns, order, jacobi)
    assert int(jacobi) == want_j
    assert torch.equal(got, tdense.solve_one(ws, wa, ws < tdense.INF32, dest,
                                             ns))
    rows = cuda_sweep.sweep_dense_slabs(packed, ns, order, jacobi)
    assert int(jacobi) == 2 * want_j  # the count adds up over calls
    assert torch.equal(rows, tdense.solve_slabs(packed, ns))
    if case == "hint":  # renumber by position: the identity is the hint
        pos = torch.argsort(order, 1)  # vertex -> position
        idx = order.long()
        by_pos = packed[:, :V].gather(
            1, idx[:, :, None].expand(B, V, V)).gather(
            2, idx[:, None, :].expand(B, V, V))
        tail = pos.gather(1, packed[:, V, :2].long()).to(torch.int32)
        slabs = torch.cat([by_pos, torch.full_like(packed[:, V:], 0)], 1)
        slabs[:, V, :2] = tail
        rows = cuda_sweep.sweep_dense_slabs(slabs.contiguous(), ns,
                                            jacobi=jacobi)
        assert int(jacobi) == 0
        assert torch.equal(rows, tdense.solve_slabs(slabs, ns))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hint", "reversed", "short", "wrap"])
@pytest.mark.parametrize("V", [8, 256, 1024, 8192])
def test_relax32_kernel_pass_and_jacobi_branch_on_the_card(cuda_device, V,
                                                           case):
    """The int32 sparse relaxation bit-equals its plain version on
    shuffled-numbering DAGs padded with invalid edges, the branch counted
    as in the sweep solve's test.  V = 8192 holds the pass's workspace in
    global memory, the others in shared memory."""
    from alignasm_tpu_torch.ops import cuda_relax32, relax32

    B = 3 if V == 8192 else 7
    edges, dests, orders = _shuffled_dag_edges(B, V, 40 + V)
    edges, orders, ns = _pass_case(edges, dests, orders, case)
    E = 1 << max(len(u) for u, _v, _s, _a in edges).bit_length()
    eu, ev, es, ea = (np.zeros((B, E), np.int32) for _ in range(4))
    evalid = np.zeros((B, E), bool)
    rng = np.random.default_rng(V)
    for b, (u, v, s, a) in enumerate(edges):
        k = rng.permutation(len(u))  # the kernel's CSR sorts them
        eu[b, :len(u)], ev[b, :len(u)] = u[k], v[k]
        es[b, :len(u)], ea[b, :len(u)] = s[k], a[k]
        evalid[b, :len(u)] = True
    args = _to(cuda_device, eu, ev, es, ea, evalid, np.zeros(B, np.int32),
               dests)
    order = _to(cuda_device, orders)[0]
    jacobi = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = cuda_relax32.relax32(*args, V, ns, order, jacobi)
    assert int(jacobi) == (0 if case == "hint" else B)
    assert torch.equal(got, relax32.sp_batch32_plain(*args, V, ns))


def _int64_edges(B, V, seed, deg, nv=None, ties=False):
    """Random DAGs as the int64 relaxation's padded (B, E) edge lists, the
    Python plane's dtypes: vertex i links to up to ``deg`` of i+1 .. i+8
    (below nv), dest nv-1, src 0, scores in [2^25, 2^26) so that path sums
    pass int32, the edges shuffled (the kernel's CSR sorts them) and at
    least one invalid padding edge 0 -> 0 per contig.  ``ties`` draws
    scores, anomalies and mapq fractions from a few values, so that many
    candidates tie on k1 and k2 and erank decides."""
    rng = np.random.default_rng(seed)
    n = nv or V
    lists = []
    for _b in range(B):
        u = np.repeat(np.arange(n - 1), deg)
        v = np.minimum(u + rng.integers(1, 9, len(u)), n - 1)
        u, v = np.unique(np.stack([u, v]), axis=1)
        k = rng.permutation(len(u))
        lists.append((u[k], v[k]))
    E = 1 << max(len(u) for u, _v in lists).bit_length()
    i32 = [np.zeros((B, E), np.int32) for _ in range(5)]  # eu ev ea enz etot
    es, erank = np.zeros((B, E), np.int64), np.zeros((B, E), np.int64)
    evalid = np.zeros((B, E), bool)
    for b, (u, v) in enumerate(lists):
        k = len(u)
        nz = rng.integers(0, 3 if ties else 60, k)
        vals = (u, v, rng.integers(0, 2 if ties else 3, k), nz,
                nz + rng.integers(1, 3 if ties else 60, k))
        for arr, val in zip(i32, vals):
            arr[b, :k] = val
        es[b, :k] = 2**25 + (rng.integers(0, 2, k) << 24 if ties
                             else rng.integers(0, 2**25, k))
        erank[b, :k] = rng.permutation(k)
        evalid[b, :k] = True
    eu, ev, ea, enz, etot = i32
    return [eu, ev, es, ea, enz, etot, erank, evalid, np.zeros(B, np.int32),
            np.full(B, n - 1, np.int32)]


def _ladder_edges(B, n):
    """Contigs whose distances improve at almost every sweep, so that
    their change histories outgrow the int64 pass's history pool (check
    (d)): a chain 0 -> 1 -> ... -> n-1 = dest and a direct edge
    i -> dest from every i, three times the chain's cost, so each vertex
    finds a cheaper path one sweep after another (about n^2 / 2 changes).
    Numbered topologically; the edges shuffled and padded as
    ``_int64_edges``."""
    rng = np.random.default_rng(n)
    u = np.concatenate([np.arange(n - 1), np.arange(n - 2)])
    v = np.concatenate([np.arange(1, n), np.full(n - 2, n - 1)])
    es = np.concatenate([np.full(n - 1, 2**25),
                         3 * 2**25 * (n - 1 - u[n - 1:])])
    k = len(u)
    E = 1 << k.bit_length()
    i32 = [np.zeros((B, E), np.int32) for _ in range(5)]  # eu ev ea enz etot
    es_b, erank = np.zeros((B, E), np.int64), np.zeros((B, E), np.int64)
    evalid = np.zeros((B, E), bool)
    for b in range(B):
        p = rng.permutation(k)
        for arr, val in zip(i32, (u, v, np.zeros(k), np.ones(k),
                                  np.full(k, 2))):
            arr[b, :k] = val[p]
        es_b[b, :k], erank[b, :k] = es[p], rng.permutation(k)
        evalid[b, :k] = True
    eu, ev, ea, enz, etot = i32
    return [eu, ev, es_b, ea, enz, etot, erank, evalid,
            np.zeros(B, np.int32), np.full(B, n - 1, np.int32)]


@pytest.mark.gpu
@pytest.mark.parametrize("V,seed,deg,nv,ties,n_sweeps", [
    (64, 1, 2, None, False, None), (64, 2, 3, 40, True, 5),
    (512, 3, 3, None, False, None), (512, 4, 2, 300, True, 2),
    (512, 5, 1, None, True, 0),
    # the state outgrows shared memory: the global workspace
    (2048, 6, 2, None, False, None), (2048, 7, 3, 1500, True, 100),
])
def test_relax64_kernel_matches_plain_on_the_card(cuda_device, V, seed, deg,
                                                  nv, ties, n_sweeps):
    """The int64 relaxation kernel bit-equals its plain version, every
    output and dtype, converged or cut short by n_sweeps, and
    ``solve_graph_batch`` on CUDA tensors launches it."""
    from alignasm_tpu_torch.ops import _build, cuda_relax64, relax

    B = 3 if V == 2048 else 7
    args = _to(cuda_device, *_int64_edges(B, V, seed, deg, nv, ties))
    ns = V if n_sweeps is None else n_sweeps
    got = cuda_relax64.relax64(*args, V, ns)
    want = relax.solve_graph_batch_plain(*args, V=V, n_sweeps=ns)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    if n_sweeps is None and nv is None and V >= 512:
        assert int(want["d_s"][:, 0].min()) >= 2**31  # int32 would wrap
    E = args[0].shape[1]
    in_smem = _build.load_library().aln_relax64_work_words(V, E) == 0
    assert in_smem == (V < 2048)
    n = cuda_relax64.relax64.launches
    again = relax.solve_graph_batch(*args, V=V, n_sweeps=ns)
    assert cuda_relax64.relax64.launches == n + 1
    assert all(torch.equal(again[k], want[k]) for k in want)


def _shallow64(u, v, V):
    """Whether the int64 relaxation's pass leaves a DAG to its Jacobi
    branch for its shape (check (c)): its longest path under 3/4 of its
    rows (the vertices with an out-edge)."""
    L = np.zeros(V, np.int64)
    for _ in range(V):
        new = L.copy()
        np.maximum.at(new, u, L[v] + 1)
        if np.array_equal(new, L):
            break
        L = new
    return 4 * int(L.max()) < 3 * len(np.unique(u))


@pytest.mark.gpu
@pytest.mark.parametrize("V,case", [
    (V, case) for V in (8, 256, 1024)
    for case in ("hint", "reversed", "short", "overflow", "shallow")
    if (V, case) != (8, "overflow")])  # 8 vertices change < 28 times
def test_relax64_kernel_pass_and_jacobi_branch_on_the_card(cuda_device, V,
                                                           case):
    """The int64 relaxation's checked pass bit-equals its plain version on
    shuffled-numbering DAGs with int64 scores: on deep DAGs (a chain
    through every position) with a valid hint no contig takes the Jacobi
    branch; with a reversed hint (check (a)), a short n_sweeps (check (b):
    the distance from the pass, floor and counts from the branch) or a
    history that outgrows the pool (check (d), ``_ladder_edges``) every
    contig does; on wide DAGs (check (c)) those whose longest path is under
    3/4 of their rows do.  V = 1024 holds the pass's workspace in global
    memory."""
    from alignasm_tpu_torch.ops import cuda_relax64, relax

    B = 5
    if case == "overflow":
        # ~6,000 changes: more than any pool holds (227 KB at 40 bytes an
        # entry in shared memory, 4V in the global workspace at V = 1024)
        host = _ladder_edges(B, 110)
        orders, ns = np.tile(np.arange(V, dtype=np.int32), (B, 1)), V
        want_j = B
    else:
        edges, dests, orders = _shuffled_dag_edges(
            B, V, 60 + V, 3 if case == "shallow" else V - 1)
        edges, orders, ns = _pass_case(edges, dests, orders,
                                       "hint" if case == "shallow" else case)
        want_j = sum(_shallow64(u, v, V) for u, v, _s, _a in edges) \
            if case == "shallow" else (0 if case == "hint" else B)
        if case == "shallow" and V > 8:
            assert want_j > 0
        E = 1 << max(len(u) for u, _v, _s, _a in edges).bit_length()
        i32 = [np.zeros((B, E), np.int32) for _ in range(5)]
        es, erank = np.zeros((B, E), np.int64), np.zeros((B, E), np.int64)
        evalid = np.zeros((B, E), bool)
        rng = np.random.default_rng(V)
        for b, (u, v, ws, wa) in enumerate(edges):
            k = len(u)
            nz = rng.integers(0, 60, k)
            for arr, val in zip(i32, (u, v, wa, nz,
                                      nz + rng.integers(1, 60, k))):
                arr[b, :k] = val
            es[b, :k] = 2**25 + (ws.astype(np.int64) << 12)
            erank[b, :k] = rng.permutation(k)
            evalid[b, :k] = True
        host = [i32[0], i32[1], es, i32[2], i32[3], i32[4], erank, evalid,
                np.zeros(B, np.int32), dests]
    args = _to(cuda_device, *host)
    order = _to(cuda_device, orders)[0]
    jacobi = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = cuda_relax64.relax64(*args, V, ns, order, jacobi)
    assert int(jacobi) == want_j
    want = relax.solve_graph_batch_plain(*args, V=V, n_sweeps=ns)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _fixed_wire(B, V, density, seed, nv=None, odd=False):
    """``_rand_wire``'s DAGs in the data axis's fixed-width (B, 2, W)
    layout (export.cc:aln_export_wire): each contig's own flat cells and
    values, its [dest, src] cells, padding at the trash cell V*(V+1);
    ``odd`` adds cells past the trash cell and negative ones (-1 the
    trash cell, -2 the last real cell, as a JAX index counts them)."""
    w = _rand_wire(B, V, density, seed, nv)
    M = V * (V + 1)
    trash = B * M
    real = w[0] < trash
    b_of = w[0][real] // M
    W = 1 << max(3, (int(np.bincount(b_of, minlength=B).max()) + 4 - 1)
                 .bit_length())
    out = np.zeros((B, 2, W), np.int32)
    out[:, 0] = M
    for b in range(B):
        sel = real & (w[0] // M == b)
        n = int(sel.sum())
        out[b, 0, :n] = w[0][sel] - b * M
        out[b, 1, :n] = w[1][sel]
        if odd and n + 2 <= W:
            out[b, :, n:n + 2] = [[M + 5 + b, -2], [7, 9]]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("V,density,seed,nv,B,odd", [
    (8, 0.5, 0, None, 37, False), (64, 0.1, 1, 40, 37, False),
    (128, 0.3, 2, None, 9, False), (256, 0.05, 3, 150, 37, False),
    (256, 0.9, 4, None, 3, False),
    # M = V * (V+1) not a multiple of 4 (scalar stores), V = 2, cells past
    # the trash cell and negative ones, one contig
    (5, 0.5, 5, None, 11, False), (2, 0.5, 6, None, 4, False),
    (64, 0.2, 7, None, 17, True), (90, 0.2, 8, 70, 1, True),
])
def test_densify_wire_kernel_matches_plain_on_the_card(cuda_device, V,
                                                       density, seed, nv, B,
                                                       odd):
    """The fixed-width densify kernel bit-equals its plain version, and the
    data axis's solve from it (densify, then the scan) the plain rows."""
    from alignasm_tpu_torch.ops import cuda_densify

    w = torch.from_numpy(_fixed_wire(B, V, density, seed, nv, odd)).to(
        cuda_device)
    slabs = cuda_densify.densify_wire(w, V)
    assert torch.equal(slabs, tdense.densify_wire(w, V))
    assert torch.equal(tdense.dense_solve_wire_topo_nxt8(w, V),
                       tdense.solve_slab_topo_nxt8(slabs))


def _shard_graph(V, seed, n_shards, deg=3, chain=True):
    """A random DAG over V vertices (dest V-1), pack_graph's edge columns
    (eu-major, erank = the target's reversed position << 26 | index),
    repeated ranks and mapq counts that tie, 5 % invalid edges, padded to
    a multiple of ``n_shards`` as the graph axis pads."""
    rng = np.random.default_rng(seed)
    eu, ev = [], []
    for u in range(V - 1):
        targets = set(rng.integers(u + 1, V, deg).tolist())
        if chain:
            targets.add(u + 1)
        for v in sorted(targets):
            eu.append(u)
            ev.append(v)
    eu, ev = np.asarray(eu), np.asarray(ev)
    E = len(eu)
    nz = rng.integers(0, 3, E)
    cols = [eu, ev, rng.integers(0, 5000, E), rng.integers(0, 4, E), nz,
            nz + rng.integers(0, 3, E),
            ((V - 1 - ev) << 26) | rng.integers(0, 2, E)]
    valid = rng.random(E) < 0.95
    Ep = 1 << max(3, (E - 1).bit_length())
    Ep = -(-Ep // n_shards) * n_shards
    out = []
    for c, t in zip(cols + [valid], (np.int32, np.int32, np.int64, np.int32,
                                     np.int32, np.int32, np.int64, bool)):
        a = np.zeros(Ep, t)
        a[:E] = c
        out.append(a)
    return out, V - 1


def _shards_on(args, mesh):
    """The graph axis's shards of ``args``: slice k on mesh[k]."""
    per = len(args[0]) // len(mesh)
    return [tuple(torch.from_numpy(a[k * per:(k + 1) * per]).to(d)
                  for a in args) for k, d in enumerate(mesh)]


def _shard_relax_route(shards, V, n_sweeps, dest, route):
    """shard_relax on ``route``, with the route it took: "pass" unless its
    ``rounds`` count moved."""
    from alignasm_tpu_torch.ops.cuda_shard_relax import shard_relax

    rounds = shard_relax.rounds
    got = shard_relax(shards, V, n_sweeps, dest, route=route)
    took = "rounds" if shard_relax.rounds > rounds else "pass"
    if took == "rounds":
        assert 0 < shard_relax.sweeps <= n_sweeps
    else:
        assert shard_relax.sweeps is None
    return got, took


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pass", "rounds"])
@pytest.mark.parametrize("V,n_shards,n_sweeps,seed,chain", [
    (64, 1, 128, 0, True), (64, 2, 128, 1, True), (200, 3, 256, 2, False),
    (512, 8, 1024, 3, True), (512, 2, 3, 4, True), (4096, 2, 8192, 5, True),
    (1000, 5, 40, 6, False), (1000, 2, 2000, 7, False),
])
def test_shard_relax_kernel_matches_plain_on_the_card(cuda_device, V,
                                                      n_shards, n_sweeps,
                                                      seed, chain, route):
    """The edge-sharded relaxation over a mesh of repeated cuda:0 entries
    bit-equals the literal plain rounds on the same CUDA shards, at full
    and cut sweeps (cut: vertices whose successors are all still
    unreachable, m1 == INF): the checked pass (its hint from erank, every
    check holding) and the forced rounds, which stop at their fixpoint
    (2000 sweeps: past their first checks)."""
    from alignasm_tpu_torch.parallel import mesh as tmesh

    args, dest = _shard_graph(V, seed, n_shards, chain=chain)
    shards = _shards_on(args, ("cuda:0",) * n_shards)
    got, took = _shard_relax_route(shards, V, n_sweeps, dest, route)
    assert took == route
    want = tmesh.edge_sharded_sp_plain(shards, V, n_sweeps, dest)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if route == "pass":  # the graph axis's own call takes the pass
        got = tmesh.edge_sharded_sp(("cuda:0",) * n_shards, args, V,
                                    n_sweeps, dest)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hint", "pool"])
def test_shard_relax_pass_failure_takes_the_rounds_on_the_card(
        cuda_device, case, monkeypatch):
    """A contig that fails the pass's check (a) (ranks whose Kahn
    positions are reversed, so the hint runs against every edge) or (d)
    (a pool of no entry) is solved by the rounds, bit-equal to the plain
    rounds."""
    from alignasm_tpu_torch.ops import cuda_shard_relax
    from alignasm_tpu_torch.parallel import mesh as tmesh

    args, dest = _shard_graph(300, 11, 2)
    if case == "hint":
        args[6] = ((args[1].astype(np.int64) << 26) | (args[6] & 3))
    else:
        monkeypatch.setattr(cuda_shard_relax, "POOL_PER_VERTEX", 0)
    shards = _shards_on(args, ("cuda:0",) * 2)
    got, took = _shard_relax_route(shards, 300, 600, dest, "pass")
    assert took == "rounds"
    want = tmesh.edge_sharded_sp_plain(shards, 300, 600, dest)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pass", "rounds"])
def test_shard_relax_kernel_over_every_visible_card(cuda_device, route):
    """Over a mesh of every visible card (the pass's gather, and the
    rounds' peer copies of the folds and the state; skips on one card)
    each route equals the plain rounds."""
    from alignasm_tpu_torch.parallel import mesh as tmesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = tuple(f"cuda:{i}" for i in range(n))
    args, dest = _shard_graph(700, 9, n)
    got, took = _shard_relax_route(_shards_on(args, mesh), 700, 1024, dest,
                                   route)
    assert took == route
    want = tmesh.edge_sharded_sp(("cpu",) * n, args, 700, 1024, dest)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# int64 keys at the edges of the order: -2^63 (top_k(-cand) sorts it last),
# around 0, INF and past it, so that sums wrap
TOPK_EXTREMES = np.array([-2**63, -2**63 + 1, -2**62, -1, 0, 1, 2**61,
                          2**62 - 1, 2**62, 2**63 - 1], dtype=np.int64)


def _topk_case(B, V, seed):
    """Top-K walk inputs: (B, V, V) int64 packed keys ``(s << 16) | a``
    (s < 2^20, a < 2) and (B,) int32 dest, contig b of flavour b % 8 on a
    DAG (position i links to i + 1 and up to three of the next 16; dest
    V - 1): 0, 1 the DAG; 2 a row of out-degree V - 1; 3 cells above INF
    (no edge); 4 a row of out-degree V, a self-loop among them; 5 a cycle
    (2 -> 0), a self-loop and a negative key V-3 -> V-2 into a vertex that
    reaches no sink (INF - 7 is kept at any K); 6 every cell drawn from
    ``TOPK_EXTREMES`` (sums wrap, -2^63 is selected); 7 a dest out of [0,
    V) or negative (the initial 0 counted from the end, no reset)."""
    rng = np.random.default_rng(seed)
    wk1 = np.full((B, V, V), TOPK_INF, np.int64)
    dest = np.full(B, V - 1, np.int32)

    def keys(n):
        return (rng.integers(0, 2**20, n).astype(np.int64) << 16) \
            | rng.integers(0, 2, n)

    for b in range(B):
        kind = b % 8
        if kind == 6:
            wk1[b] = TOPK_EXTREMES[rng.integers(0, len(TOPK_EXTREMES),
                                                (V, V))]
            continue
        for i in range(V - 1):
            cols = {i + 1, *rng.integers(i + 1, min(V, i + 17),
                                         rng.integers(0, 4)).tolist()}
            wk1[b, i, sorted(cols)] = keys(len(cols))
        if kind == 2:
            wk1[b, 0, 1:] = keys(V - 1)
        elif kind == 3:
            cells = rng.integers(0, V, (2, V))
            wk1[b, cells[0], cells[1]] = rng.integers(TOPK_INF, 2**63 - 1, V)
        elif kind == 4:
            wk1[b, 1] = keys(V)
        elif kind == 5 and V >= 4:
            wk1[b, 2, 0] = keys(1)[0]
            wk1[b, V // 2, V // 2] = keys(1)[0]
            wk1[b, V - 3] = TOPK_INF
            wk1[b, V - 2] = TOPK_INF
            wk1[b, V - 3, V - 2] = -7
            wk1[b, V - 4, V - 1] = keys(1)[0]
        elif kind == 7:
            dest[b] = rng.choice([-1, -V, V, V + 3, int(rng.integers(0, V))])
    return wk1, dest


def _topk_extremes(B, V, seed):
    """Tiny contigs whose every cell is drawn from ``TOPK_EXTREMES`` and
    whose dest lies anywhere in [-V - 1, V]: rows of out-degree V, where
    -2^63 (top_k's last) and wrapped sums are selected."""
    rng = np.random.default_rng(seed)
    wk1 = TOPK_EXTREMES[rng.integers(0, len(TOPK_EXTREMES), (B, V, V))]
    return wk1, rng.integers(-V - 1, V + 1, B).astype(np.int32)


def _topk_budget_case(B, V, seed):
    """Top-K walk inputs past csrc/topk.cu's CSR budget of 4 V edges: every
    row links to 5-32 random columns (cycles and self-loops included), row
    1 to 33 (past the 32 edges a CSR row holds), dest V - 1, so the CSR
    fills and the rows after it read their edges in place."""
    rng = np.random.default_rng(seed)
    wk1 = np.full((B, V, V), TOPK_INF, np.int64)
    for b in range(B):
        for u in range(V):
            n = 33 if u == 1 else int(rng.integers(5, 33))
            cols = rng.choice(V, min(n, V), replace=False)
            wk1[b, u, cols] = (rng.integers(0, 2**20, len(cols)).astype(
                np.int64) << 16) | rng.integers(0, 2, len(cols))
    return wk1, np.full(B, V - 1, np.int32)


def _topk_fixpoint(plain, ran, ns):
    """Whether ``ran`` is one contig's fixed-point sweep count: the state
    after ``ran`` plain sweeps equals the one after ``ran - 1`` (unless it
    ran all ``ns``), and the one after ``ran - 1`` differs from the one
    after ``ran - 2``.  ``plain(n)`` is the contig's state after n sweeps;
    a sweep that changes nothing leaves every later one equal, so this is
    the first sweep that changes nothing."""
    if not min(ns, 1) <= ran <= ns:
        return False
    if ran < ns and not torch.equal(plain(ran), plain(ran - 1)):
        return False
    return ran < 2 or not torch.equal(plain(ran - 1), plain(ran - 2))


# (V, K, seed) of _topk_extremes batches (B = 64, 4 sweeps) that select -2^63
TOPK_EXTREME_SEEDS = [(1, 1, 0), (2, 2, 3), (2, 4, 3), (3, 2, 39)]


def _inf_plus_x(out):
    """Whether ``out`` holds a key INF + x, x != 0 (within 2^40 of INF)."""
    return bool(((out != TOPK_INF) & ((out - TOPK_INF).abs() < 2**40)).any())


@pytest.mark.gpu
@pytest.mark.parametrize("V,K,ns", [
    *((V, K, ns) for K in (1, 16) for V, ns in (
        (8, 8), (33, 33), (64, 64), (64, 1), (64, 0), (128, 128),
        (256, 256), (512, 512))),
    (512, 17, 512), (256, 45, 256), (64, 4, 64), (64, 32, 64)])
def test_topk_kernel_matches_plain_on_the_card(cuda_device, V, K, ns):
    """The top-K walk kernel bit-equals its plain version on ``_topk_case``
    batches (B = 8, every flavour: rows past the 32 edges a CSR row holds
    read in place, INF + x selected, wrapped sums, -2^63, odd dests), at
    the edges of the lane routes (K 1, 4, 16, 17, 32) and of a thread a
    row (K = 45), and counts the sweeps it ran: each contig, launched
    alone, its plain version's fixed point, and the batch their sum."""
    from alignasm_tpu_torch.ops import _build, cuda_topk, topk

    B = 8
    wk1, dest = _to(cuda_device, *_topk_case(B, V, 70 + V + ns))
    sweeps = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    n = cuda_topk.topk_walks_batch.launches
    got = topk.topk_walks_batch(wk1, dest, V, K, ns, sweeps)
    assert cuda_topk.topk_walks_batch.launches == n + 1
    want = topk.topk_walks_batch_plain(wk1, dest, V, K, ns)
    assert torch.equal(got, want)
    assert int(sweeps) == _topk_sweeps_at_fixpoint(wk1, dest, V, K, ns)
    if ns >= 1:
        assert _inf_plus_x(want[5])
    assert _build.load_library().aln_topk_smem_bytes(V, K) \
        == cuda_topk.smem_bytes(V, K)


def _topk_sweeps_at_fixpoint(wk1, dest, V, K, ns):
    """The kernel's sweeps of each contig launched alone, each held to its
    plain version's fixed point (``_topk_fixpoint``); returns their sum."""
    from alignasm_tpu_torch.ops import cuda_topk, topk

    total = 0
    for b in range(wk1.shape[0]):
        one = (wk1[b:b + 1], dest[b:b + 1], V, K)
        sweeps = torch.zeros(1, dtype=torch.int32, device=wk1.device)
        cuda_topk.topk_walks_batch(*one, ns, sweeps)
        ran = int(sweeps)
        assert _topk_fixpoint(
            lambda n: topk.topk_walks_batch_plain(*one, n), ran, ns), (b, ran)
        total += ran
    return total


@pytest.mark.gpu
@pytest.mark.parametrize("V,K", [(64, 16), (512, 16), (256, 45)])
def test_topk_kernel_past_the_edge_budget_on_the_card(cuda_device, V, K):
    """The kernel bit-equals its plain version on ``_topk_budget_case``
    (B = 4, n_sweeps = V): rows of 5-33 edges, more than the CSR's 4 V,
    so the rows after it read their edges in place; its sweeps are each
    contig's plain fixed point."""
    from alignasm_tpu_torch.ops import cuda_topk, topk

    wk1, dest = _to(cuda_device, *_topk_budget_case(4, V, 5 + V + K))
    sweeps = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = cuda_topk.topk_walks_batch(wk1, dest, V, K, V, sweeps)
    assert torch.equal(got, topk.topk_walks_batch_plain(wk1, dest, V, K, V))
    assert int(sweeps) == _topk_sweeps_at_fixpoint(wk1, dest, V, K, V)


@pytest.mark.gpu
@pytest.mark.parametrize("V,K,seed", TOPK_EXTREME_SEEDS)
def test_topk_kernel_extremes_on_the_card(cuda_device, V, K, seed):
    """The kernel bit-equals its plain version on ``_topk_extremes``
    (B = 64, 4 sweeps), each batch one where -2^63 is selected."""
    from alignasm_tpu_torch.ops import cuda_topk, topk

    wk1, dest = _to(cuda_device, *_topk_extremes(64, V, seed))
    got = cuda_topk.topk_walks_batch(wk1, dest, V, K, 4)
    want = topk.topk_walks_batch_plain(wk1, dest, V, K, 4)
    assert torch.equal(got, want)
    assert bool((want == -2**63).any())


@pytest.mark.gpu
@pytest.mark.parametrize("V,K", [(512, 50), (1024, 22), (2048, 8)])
def test_topk_kernel_raises_past_shared_memory(cuda_device, V, K):
    """A (V, K) whose keys, edges and lists outgrow a block's 227 KB of
    shared memory raises ValueError, naming the limit, before any launch;
    V = 512 at K = 49 (and at K = 17, the old limit) runs."""
    from alignasm_tpu_torch.ops import cuda_topk

    n = cuda_topk.topk_walks_batch.launches
    wk1 = torch.full((1, V, V), TOPK_INF, dtype=torch.int64,
                     device=cuda_device)
    dest = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_topk.topk_walks_batch(wk1, dest, V, K, 2)
    assert cuda_topk.topk_walks_batch.launches == n
    for k in (17, 49):
        ok = cuda_topk.topk_walks_batch(wk1[:, :512, :512].contiguous(),
                                        dest, 512, k, 2)
        assert ok[0, 0, 0] == 0 and (ok[0, 1:] == TOPK_INF).all()
