"""Device solve of the native exporter's wires: densify, then the
reverse-topo scan (V <= 256, uint8 gate rows) or the blocked tropical
solve (256 < V <= 16384, int16 gate rows); and the Python plane's dense
sweep solve (``dense_solve_batch``, ``dense_solve_slabs``).

PyTorch counterpart of ``alignasm_tpu/ops/dense.py``.
The wire layout contract is the
same one the JAX package reads (export.cc:aln_export_wire16 /
aln_export_wire_ragged): a contig is a (V+1, V) int32 slab, cells
``score | anom << ANOM_SHIFT`` (INF32 = no edge), row V holds
``[dest, src]``, and flat index ``B * V * (V+1)`` is the trash cell that
padding entries point at.

Each function has a plain PyTorch version here.  The public entry points
take the plain path for tensors on the CPU and launch the hand-written
CUDA kernels (ops/cuda_densify.py, ops/cuda_topo.py, ops/cuda_blocked.py)
for tensors on a CUDA device (the sweep solve: ops/cuda_sweep.py); there
is no fallback from one to the other.

Every packed value lies in [0, 2^30], so ``>>`` (an arithmetic shift in
torch) is exact where the JAX package uses a logical shift, and every
sum below stays under 2^31 (see the notes at each step).
"""

from __future__ import annotations

import numpy as np
import torch

INF32 = 2**30
COUNT_SAT = 10_001
ANOM_SHIFT = 28
_SCORE_MASK = (1 << ANOM_SHIFT) - 1
# the blocked solve's "no path" clamps (alignasm_tpu/ops/dense.py:333-335)
INFH = INF32 - (1 << ANOM_SHIFT)  # score closures
INFA = 1 << 20                    # anomaly panels
INFAH = (1 << 20) - 16            # anomaly closures


def _scatter(flat, idx, val, trash):
    """flat[idx] = val, out-of-range indices redirected to the trash cell
    (the JAX scatter drops them; the trash cell is sliced off either way)."""
    idx = idx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx <= trash), idx, trash)
    flat[idx] = val


def densify_wire(wire, V: int):
    """Plain form of ``_densify_wire`` (alignasm_tpu/ops/dense.py:52), the
    data axis's fixed-width wire: (B, 2, W) int32, row b holding W flat
    cells of contig b's own (V+1, V) slab, then their W values; padding
    slots point at the trash cell M = V*(V+1) -> (B, V+1, V) int32 slabs.
    A negative cell counts from the end of the (M+1)-cell buffer once, as
    a JAX index does; a cell outside [0, M] after that is dropped, and the
    trash cell is sliced off.  Real cells are unique on exporter wires."""
    B, _, W = wire.shape
    M = V * (V + 1)
    idx = wire[:, 0].to(torch.int64)
    idx = torch.where(idx < 0, idx + M + 1, idx)
    keep = (idx >= 0) & (idx <= M)
    base = torch.arange(B, device=wire.device)[:, None] * (M + 1)
    flat = torch.full((B * (M + 1),), INF32, dtype=torch.int32,
                      device=wire.device)
    flat[(base + idx)[keep]] = wire[:, 1][keep]
    return flat.view(B, M + 1)[:, :M].reshape(B, V + 1, V)


def densify_wire_ragged(wire, B: int, V: int):
    """Plain form of ``_densify_wire_ragged`` (alignasm_tpu/ops/dense.py:491):
    one (2, capN) int32 stream of (global flat cell, value) pairs ->
    (B, V+1, V) int32 slabs.  On this wire only the trash cell repeats
    (the exporter trash-fills a rejected contig's span)."""
    M = V * (V + 1)
    flat = torch.full((B * M + 1,), INF32, dtype=torch.int32, device=wire.device)
    _scatter(flat, wire[0], wire[1], B * M)
    return flat[: B * M].view(B, V + 1, V)


def wire16_positions(deltas):
    """Absolute cells of the 16-bit wire: the prefix sum of the u16 deltas,
    widened to int32 first (a u16 sum would wrap).  ``deltas`` holds the
    raw u16 bits as int16 (ops/wire.py)."""
    return torch.cumsum(deltas.to(torch.int32) & 0xFFFF, 0, dtype=torch.int32)


def densify_wire16(deltas, vidx, table, seeds, n_real: int, B: int, V: int):
    """Plain form of ``_densify_wire16`` (alignasm_tpu/ops/dense.py:532):
    cell i = cumsum(deltas)[i], value i = table[vidx[i]], entries at or
    past ``n_real`` go to the trash cell, then the (2, S) ``seeds`` pairs
    land on top.  ``deltas``/``vidx`` are raw u16 bits in int16 tensors.
    Cells repeat: the exporter's rejected-contig filler is zero deltas that
    repeat a cell with the same value (a serial scatter keeps the last)."""
    M = V * (V + 1)
    trash = B * M
    pos = wire16_positions(deltas)
    lane = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    pos = torch.where(lane < n_real, pos, trash)
    # a JAX gather clamps an out-of-range index; so does this lookup
    vi = (vidx.to(torch.int64) & 0xFFFF).clamp_max(table.shape[0] - 1)
    flat = torch.full((trash + 1,), INF32, dtype=torch.int32, device=pos.device)
    _scatter(flat, pos, table[vi], trash)
    _scatter(flat, seeds[0], seeds[1], trash)
    return flat[:trash].view(B, V + 1, V)


def topo_scan(slabs):
    """Plain form of ``_topo_scan`` (alignasm_tpu/ops/dense.py:111), batched:
    one reverse-topological scan over (B, V+1, V) slabs.

    Returns ``(s, a, fa, ct, cm, nxt)``, each (B, V) int32 — the lex-min
    (sum, anom) to dest, the anomaly floor, the walk count and the count
    of min walks (both saturated at COUNT_SAT), and the lowest-index
    achieving successor (-1 if none) — plus ``dest`` and ``src`` (B,).
    The int32 arithmetic matches the JAX scan literally: ``ws + s`` with
    s = INF32 is < 2^31 (ws < 2^28), fa may exceed INF32 by the anomaly
    sum of an unreachable suffix (< 3V), and the count sums are at most
    V * COUNT_SAT before saturation."""
    B, V1, V = slabs.shape
    dev = slabs.device
    wsa = slabs[:, :V]
    dest = slabs[:, V, 0].to(torch.int64)
    src = slabs[:, V, 1].to(torch.int64)
    lane = torch.arange(V, dtype=torch.int32, device=dev).expand(B, V)
    i32 = dict(dtype=torch.int32, device=dev)
    inf = torch.tensor(INF32, **i32)
    zero = torch.tensor(0, **i32)
    on_dest = lane == dest[:, None]
    s = torch.where(on_dest, zero, inf)
    a = torch.zeros((B, V), **i32)
    fa = s.clone()
    ct = on_dest.to(torch.int32)
    cm = ct.clone()
    nxt = torch.full((B, V), -1, **i32)
    for u in range(V - 1, -1, -1):
        row = wsa[:, u]
        edge = row != INF32
        ws = row & _SCORE_MASK
        wa = row >> ANOM_SHIFT
        cs = torch.where(edge, ws + s, inf)
        m1 = cs.amin(1, keepdim=True)
        on = edge & (cs == m1)
        m2 = torch.where(on, wa + a, inf).amin(1, keepdim=True)
        reach = m1 < INF32
        s_u = torch.where(reach, m1, inf)
        a_u = torch.where(reach, m2, zero)
        fa_u = torch.where(edge, wa + fa, inf).amin(1, keepdim=True)
        ct_u = torch.where(edge, ct, zero).sum(
            1, keepdim=True, dtype=torch.int32).clamp_max(COUNT_SAT)
        ach = edge & (s < INF32) & (ws + s == s_u) & (wa + a == a_u)
        cm_u = torch.where(ach, cm, zero).sum(
            1, keepdim=True, dtype=torch.int32).clamp_max(COUNT_SAT)
        # lowest achieving lane, not argmax over bools
        low = torch.where(ach, lane, V).amin(1, keepdim=True)
        nxt_u = torch.where(low < V, low, -1)
        keep = (dest == u)[:, None]  # dest's base values are the anchors
        for vec, x in ((s, s_u), (a, a_u), (fa, fa_u), (ct, ct_u),
                       (cm, cm_u), (nxt, nxt_u)):
            vec[:, u : u + 1] = torch.where(keep, vec[:, u : u + 1], x)
    return (s, a, fa, ct, cm, nxt), dest, src


def _scan_rows(slabs, dtype):
    """``[nxt (-1 encoded as dest), fast, src]`` rows of the plain scan,
    the gate ``fast = cm[src] == 1 and not (ct[src] >= 2 and a[src] !=
    fa[src])`` in exact int32."""
    (s, a, fa, ct, cm, nxt), dest, src = topo_scan(slabs)
    at = src[:, None]

    def pick(vec):
        return vec.gather(1, at)[:, 0]

    fast = (pick(cm) == 1) & ~((pick(ct) >= 2) & (pick(a) != pick(fa)))
    nxt_enc = torch.where(nxt < 0, dest[:, None].to(torch.int32), nxt)
    tail = torch.stack([fast.to(torch.int32), src.to(torch.int32)], 1)
    return torch.cat([nxt_enc, tail], 1).to(dtype)


def solve_slab_topo_nxt8(slabs):
    """Plain form of ``solve_slab_topo_nxt8`` (alignasm_tpu/ops/dense.py:217),
    batched: (B, V+1, V) slabs, V <= 256 -> (B, V+2) uint8 rows
    ``[nxt (-1 encoded as dest), fast, src]`` with the on-device gate."""
    return _scan_rows(slabs, torch.uint8)


def solve_slab_topo_nxt16(slabs):
    """Plain form of ``solve_slab_topo_nxt16`` (alignasm_tpu/ops/dense.py:
    249), batched: (B, V+1, V) slabs, V <= 32767 -> (B, V+2) int16 rows
    ``[nxt (-1 encoded as dest), fast, src]`` from one reverse-topological
    scan.  The function the blocked kernel (csrc/blocked_dp.cu) computes;
    ``solve_slab_topo_nxt16_blocked`` gives the same rows at every Bk when
    path sums stay below INFH and no edge (r, dest) comes from a row r
    past dest, as on exporter wires of the device's buckets."""
    return _scan_rows(slabs, torch.int16)


def _mp_closure(A, inf_h: int, nlev: int):
    """(I + A)^(2^nlev) in min-plus over (B, Bk, Bk): the diagonal set to
    0, then nlev squarings clamped at ``inf_h`` ("no path")."""
    eye = torch.eye(A.shape[-1], dtype=torch.bool, device=A.device)
    M = torch.where(eye, 0, A)
    for _ in range(nlev):
        M = (M[:, :, :, None] + M[:, None, :, :]).amin(2).clamp_max(inf_h)
    return M


def _cnt_closure(adj, nlev: int):
    """P[i, k] = number of paths i -> k inside the block (the empty one
    included), saturated at 2, by path doubling: P' = min(P + Q P, 2),
    Q' = min(Q Q, 2) from P = I, Q = adj.  Float32 matrix products as in
    the JAX package: inputs lie in {0, 1, 2}, products are <= 4 and sums
    <= 4 * Bk, at most 1,024 at Bk = 256: exact in float32, and in TF32
    with float32 accumulation (the products of values in {0, 1, 2} are
    exact, and the float32 sums hold every integer below 2^24)."""
    Q = adj.to(torch.float32)
    P = torch.eye(adj.shape[-1], device=adj.device).expand_as(Q)
    for _ in range(nlev):
        P, Q = (P + Q @ P).clamp_max(2.0), (Q @ Q).clamp_max(2.0)
    return P


def blocked_dp(slabs, Bk: int):
    """Plain form of ``_blocked_dp`` (alignasm_tpu/ops/dense.py:277),
    batched: the blocked tropical triangular solve over (B, V+1, V) slabs,
    V a multiple of Bk.  Vertices fall into V/Bk diagonal blocks, solved
    last to first; per block, panels fold the final tail columns
    (>= lo + Bk) into per-row candidates and log-depth closures resolve
    the block's own (Bk, Bk) dependencies, one scalar solve at a time:
    s, then a over the s-achieving edges, fa, ct, and cm over the
    (s, a)-achieving edges, with counts saturated at 2.

    Returns ``(s, a, fa, ct, cm, nxt)``, each (B, V) int32, plus ``dest``
    and ``src`` (B,), as ``topo_scan`` does; the arithmetic is the JAX
    package's step for step (clamps at INFH / INFA / INFAH, every sum
    below 2^31), so the six vectors are bit-equal to it."""
    B, V1, V = slabs.shape
    assert V1 == V + 1 and V % Bk == 0 and V >= Bk
    nb = V // Bk
    nlev = max(1, (Bk - 1).bit_length())
    dev = slabs.device
    i32 = dict(dtype=torch.int32, device=dev)
    wsa = slabs[:, :V]
    dest = slabs[:, V, 0].to(torch.int64)
    src = slabs[:, V, 1].to(torch.int64)
    vidx = torch.arange(V, **i32)
    eye = torch.eye(Bk, dtype=torch.bool, device=dev)
    on_dest = vidx[None, :] == dest[:, None]
    b_s = torch.where(on_dest, 0, INF32).to(torch.int32)
    b_a = torch.where(on_dest, 0, INFA).to(torch.int32)
    b_c = on_dest.to(torch.int32)
    s, a, fa = b_s.clone(), torch.zeros((B, V), **i32), b_s.clone()
    ct, cm = b_c.clone(), b_c.clone()
    nxt = torch.full((B, V), -1, **i32)

    for t in range(nb):
        lo = (nb - 1 - t) * Bk
        blk = slice(lo, lo + Bk)
        rid = lo + torch.arange(Bk, device=dev)
        # dest's outgoing row is guarded in the scan (keep): mask it
        R = torch.where((rid[None, :] == dest[:, None])[:, :, None],
                        INF32, wsa[:, blk])                     # (B, Bk, V)
        edge = R != INF32
        ws = R & _SCORE_MASK
        wa = R >> ANOM_SHIFT
        e_tail = edge & (vidx >= lo + Bk)
        e_in = edge[:, :, blk] & ~eye
        ws_in, wa_in = ws[:, :, blk], wa[:, :, blk]

        # 1. s: min-plus on scores
        ps = torch.minimum(
            torch.where(e_tail, ws + s[:, None, :], INF32).amin(2), b_s[:, blk])
        Ms = _mp_closure(torch.where(e_in, ws_in.clamp_max(INFH), INFH),
                         INFH, nlev)
        xs = (Ms + ps[:, None, :]).amin(2)
        xs = torch.where(xs >= INFH, INF32, xs)

        # 2. a: min-plus on anomalies over the s-achieving edges
        s_upd = s.clone()
        s_upd[:, blk] = xs
        ach = e_tail & (s[:, None, :] < INF32) \
            & (ws + s[:, None, :] == xs[:, :, None])
        pa = torch.minimum(
            torch.where(ach, wa + a[:, None, :], INFA).amin(2), b_a[:, blk])
        ach_in = e_in & (xs[:, None, :] < INF32) \
            & (ws_in + xs[:, None, :] == xs[:, :, None])
        Ma = _mp_closure(torch.where(ach_in, wa_in, INFAH), INFAH, nlev)
        xa = (Ma + pa[:, None, :]).amin(2)
        xa = torch.where(xs < INF32, xa, 0)  # scan: a_u = 0 if unreachable

        # 3. fa: min-plus on anomalies over all edges
        pfa = torch.minimum(
            torch.where(e_tail, wa + fa.clamp_max(INFA)[:, None, :],
                        INFA).amin(2), b_a[:, blk])
        Mf = _mp_closure(torch.where(e_in, wa_in, INFAH), INFAH, nlev)
        xfa = (Mf + pfa[:, None, :]).amin(2)
        xfa = torch.where(xfa >= INFAH, INF32, xfa)

        # 4. ct: {0, 1, 2+} path counting over all edges
        pct = (b_c[:, blk] + torch.where(e_tail, ct[:, None, :], 0).sum(
            2, dtype=torch.int32)).clamp_max(2)
        xct = (_cnt_closure(e_in, nlev) @ pct.to(torch.float32)[:, :, None]
               )[:, :, 0].clamp_max(2.0).to(torch.int32)

        # 5. cm: counting over the (s, a)-achieving edges
        a_upd = a.clone()
        a_upd[:, blk] = xa
        ach2 = ach & (wa + a[:, None, :] == xa[:, :, None])
        ach2_in = ach_in & (wa_in + xa[:, None, :] == xa[:, :, None])
        pcm = (b_c[:, blk] + torch.where(ach2, cm[:, None, :], 0).sum(
            2, dtype=torch.int32)).clamp_max(2)
        xcm = (_cnt_closure(ach2_in, nlev) @ pcm.to(torch.float32)[:, :, None]
               )[:, :, 0].clamp_max(2.0).to(torch.int32)

        # nxt: lowest-index achieving successor over the whole row
        ach_full = edge & (s_upd[:, None, :] < INF32) \
            & (ws + s_upd[:, None, :] == xs[:, :, None]) \
            & (wa + a_upd[:, None, :] == xa[:, :, None])
        low = torch.where(ach_full, vidx, V).amin(2)

        s, a = s_upd, a_upd
        fa[:, blk], ct[:, blk], cm[:, blk] = xfa, xct, xcm
        nxt[:, blk] = torch.where(low < V, low, -1)
    return (s, a, fa, ct, cm, nxt), dest, src


def solve_slab_topo_nxt16_blocked(slabs, Bk: int):
    """Plain form of ``solve_slab_topo_nxt16_blocked``
    (alignasm_tpu/ops/dense.py:464), batched: (B, V+1, V) slabs -> (B, V+2)
    int16 rows ``[nxt (-1 encoded as dest), fast, src]``, the gate
    evaluated at src in exact int32 as in ``solve_slab_topo_nxt8``."""
    (s, a, fa, ct, cm, nxt), dest, src = blocked_dp(slabs, Bk)
    at_src = torch.arange(slabs.shape[2], device=slabs.device) == src[:, None]

    def pick(vec):  # vec[src], 0 where src lies outside the slab (as JAX)
        return torch.where(at_src, vec, 0).sum(1, dtype=torch.int32)

    fast = (pick(cm) == 1) & ~((pick(ct) >= 2) & (pick(a) != pick(fa)))
    nxt_enc = torch.where(nxt < 0, dest[:, None].to(torch.int32), nxt)
    tail = torch.stack([fast.to(torch.int32), src.to(torch.int32)], 1)
    return torch.cat([nxt_enc, tail], 1).to(torch.int16)


DENSE_ROWS = ("d_s", "d_a", "floor_a", "cnt_tot", "cnt_min")


def _fixed_point(step, state, n_sweeps: int):
    """``n_sweeps`` Jacobi sweeps ``state = step(state)`` (a tuple of
    tensors), stopped once a sweep changes nothing: every later sweep
    would return the same state, so the result is the one after all
    ``n_sweeps``."""
    for _ in range(n_sweeps):
        new = step(state)
        if all(torch.equal(x, y) for x, y in zip(new, state)):
            break
        state = new
    return state


def solve_one(ws, wa, edge, dest, n_sweeps: int):
    """Plain form of ``_solve_one`` (alignasm_tpu/ops/dense.py:581),
    batched over (B, V, V) score / anomaly matrices and an edge mask:
    Jacobi sweeps of the lex-min (sum, anom) to ``dest``, the anomaly
    floor, and the walk count and count of min walks saturated at
    COUNT_SAT, each loop ``n_sweeps`` sweeps.  Returns (B, 5, V) int32
    ``[d_s, d_a, floor_a, cnt_tot, cnt_min]``; the int32 arithmetic is the
    JAX package's (sums wrap as there)."""
    B, V, _ = ws.shape
    dev = ws.device
    vidx = torch.arange(V, dtype=torch.int32, device=dev)
    on_dest = vidx[None, :] == dest.to(torch.int32)[:, None]
    inf = torch.tensor(INF32, dtype=torch.int32, device=dev)
    s0 = torch.where(on_dest, 0, inf)

    def sweep(st):
        s, a = st
        cs = torch.where(edge, ws + s[:, None, :], inf)
        m1 = cs.amin(2)
        on = edge & (cs == m1[:, :, None])
        m2 = torch.where(on, wa + a[:, None, :], inf).amin(2)
        better = ((m1 < s) | ((m1 == s) & (m2 < a))) & (m1 < INF32)
        return torch.where(better, m1, s), torch.where(better, m2, a)

    s, a = _fixed_point(sweep, (s0, torch.zeros_like(s0)), n_sweeps)

    def fsweep(st):
        c = torch.where(edge, wa + st[0][:, None, :], inf)
        return (torch.minimum(st[0], c.amin(2)),)

    (fa,) = _fixed_point(fsweep, (s0,), n_sweeps)
    base = on_dest.to(torch.int32)

    def counts(mask):
        def csweep(st):
            tot = torch.where(mask, st[0][:, None, :], 0).sum(
                2, dtype=torch.int32)
            return ((base + tot).clamp_max(COUNT_SAT),)

        return _fixed_point(csweep, (base,), n_sweeps)[0]

    cnt_tot = counts(edge)
    ach = edge & (s[:, None, :] < INF32) \
        & (ws + s[:, None, :] == s[:, :, None]) \
        & (wa + a[:, None, :] == a[:, :, None])
    cnt_min = counts(ach)
    return torch.stack([s, a, fa, cnt_tot, cnt_min], 1)


def solve_slabs(packed, n_sweeps: int):
    """Plain form of ``solve_slab`` (alignasm_tpu/ops/dense.py:646),
    batched: (B, V+1, V) packed slabs -> (B, 2V+4) int32 rows
    ``[d_s, d_a, floor_a@src, cnt_tot@src, cnt_min@src, src]``; a value
    at ``src`` is 0 where src lies outside the slab (the JAX masked
    sum)."""
    B, V1, V = packed.shape
    wsa = packed[:, :V]
    dest = packed[:, V, 0]
    src = packed[:, V, 1]
    # (x >> 28) & 0xF is the logical shift for any int32 bit pattern
    out5 = solve_one(wsa & _SCORE_MASK, (wsa >> ANOM_SHIFT) & 0xF,
                     wsa != INF32, dest, n_sweeps)
    at_src = torch.arange(V, device=packed.device)[None, :] == src[:, None]
    picks = torch.where(at_src[:, None, :], out5[:, 2:], 0).sum(
        2, dtype=torch.int32)
    return torch.cat([out5[:, 0], out5[:, 1], picks, src[:, None]], 1)


def dense_solve_batch(ws, wa, dest, n_sweeps: int, order=None, jacobi=None):
    """Batched (B, V, V) dense solve (counterpart of
    alignasm_tpu/ops/dense.py:564): ``ws``/``wa`` int32 score / anomaly
    matrices, INF32 in ``ws`` where no edge exists, ``dest`` (B,) int32
    -> (B, 5, V) int32 ``[d_s, d_a, floor_a, cnt_tot, cnt_min]``.  CPU
    tensors take the plain path, CUDA tensors the sweep kernel.
    ``order``, (B, V) int32 with ``order[b, t]`` the vertex at
    topological position t, is the kernel's hint for its one-pass branch
    (csrc/topo_pass.cuh); it never changes the result.  ``jacobi``, one
    int32 on the card, gains the number of contigs that took the kernel's
    Jacobi branch.  The plain path reads neither."""
    if _on_cuda(ws):
        from alignasm_tpu_torch.ops import cuda_sweep

        return cuda_sweep.sweep_dense_batch(ws, wa, dest, n_sweeps, order,
                                            jacobi)
    return solve_one(ws, wa, ws < INF32, dest, n_sweeps)


def dense_solve_slabs(packed, n_sweeps: int, order=None, jacobi=None):
    """The sweep solve on (B, V+1, V) packed slabs -> (B, 2V+4) int32
    rows (counterpart of ``dense_solve_slabs_pallas``,
    alignasm_tpu/ops/dense.py:674, without its batch padding to 8).  CPU
    tensors take the plain path, CUDA tensors the sweep kernel, with
    ``order`` (default: the identity) and ``jacobi`` as in
    ``dense_solve_batch``."""
    if _on_cuda(packed):
        from alignasm_tpu_torch.ops import cuda_sweep

        return cuda_sweep.sweep_dense_slabs(packed, n_sweeps, order, jacobi)
    return solve_slabs(packed, n_sweeps)


def unpack_dense(stacked_row):
    """Per-contig dict view of one (5, V) stacked dense result (the
    finish_contig contract)."""
    return {k: stacked_row[j] for j, k in enumerate(DENSE_ROWS)}


def pack_dense_bucket(chunk, V: int):
    """Host packing of a bucket into (B, V, V) int32 matrices (copy of
    alignasm_tpu/ops/dense.py:pack_dense_bucket): ``chunk`` is a list of
    (contig index, PackedGraph).  Returns (ws, wa, dests) numpy arrays,
    or None if a contig has parallel edges (one dense cell holds one
    edge; the sparse kernel takes the bucket then)."""
    B = len(chunk)
    bs, us, vs, ss, as_ = [], [], [], [], []
    dests = np.empty((B,), np.int32)
    for b, (_i, pg) in enumerate(chunk):
        n_e = len(pg.eu)
        if n_e:
            keys = pg.eu.astype(np.int64) * V + pg.ev
            if len(np.unique(keys)) != n_e:
                return None
        bs.append(np.full(n_e, b, np.int32))
        us.append(pg.eu)
        vs.append(pg.ev)
        ss.append(pg.es.astype(np.int32))
        as_.append(pg.ea)
        dests[b] = pg.g.dest
    ws = np.full((B, V, V), INF32, np.int32)
    wa = np.zeros((B, V, V), np.int32)
    b = np.concatenate(bs) if bs else np.empty(0, np.int32)
    u = np.concatenate(us) if us else np.empty(0, np.int32)
    v = np.concatenate(vs) if vs else np.empty(0, np.int32)
    ws[b, u, v] = np.concatenate(ss) if ss else []
    wa[b, u, v] = np.concatenate(as_) if as_ else []
    return ws, wa, dests


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def dense_solve_wire16_topo_nxt8(deltas, vidx, table, seeds, n_real, B, V):
    """Batched solve from the 16-bit wire -> (B, V+2) uint8 gate rows
    (counterpart of alignasm_tpu/ops/dense.py:555).  CPU tensors take the
    plain path, CUDA tensors the kernels."""
    assert V <= 255, "the 16-bit wire requires V*(V+1) <= 65535"
    if _on_cuda(deltas):
        from alignasm_tpu_torch.ops import cuda_densify, cuda_topo

        slabs = cuda_densify.densify_wire16(
            deltas, vidx, table, seeds, int(n_real), B, V)
        return cuda_topo.topo_scan_nxt8(slabs)
    return solve_slab_topo_nxt8(
        densify_wire16(deltas, vidx, table, seeds, int(n_real), B, V))


def dense_solve_wire_topo_nxt8(wire, V):
    """Batched solve from the fixed-width (B, 2, W) wire of the data axis
    -> (B, V+2) uint8 gate rows (counterpart of alignasm_tpu/ops/dense.py:
    241).  CPU tensors take the plain path, CUDA tensors the kernels."""
    assert V <= 256, "uint8 nxt entries require V <= 256"
    if _on_cuda(wire):
        from alignasm_tpu_torch.ops import cuda_densify, cuda_topo

        return cuda_topo.topo_scan_nxt8(cuda_densify.densify_wire(wire, V))
    return solve_slab_topo_nxt8(densify_wire(wire, V))


def dense_solve_wire_topo_nxt8_ragged(wire, B, V):
    """Batched solve from the ragged i32 wire -> (B, V+2) uint8 gate rows
    (counterpart of alignasm_tpu/ops/dense.py:513).  CPU tensors take the
    plain path, CUDA tensors the kernels."""
    assert V <= 256, "uint8 nxt entries require V <= 256"
    if _on_cuda(wire):
        from alignasm_tpu_torch.ops import cuda_densify, cuda_topo

        return cuda_topo.topo_scan_nxt8(cuda_densify.densify_ragged(wire, B, V))
    return solve_slab_topo_nxt8(densify_wire_ragged(wire, B, V))


def dense_solve_wire_topo_nxt16_blocked_ragged(wire, B, V, Bk):
    """Batched blocked solve from the ragged i32 wire -> (B, V+2) int16
    gate rows (counterpart of alignasm_tpu/ops/dense.py:481), the big-V
    path.  CPU tensors take the plain path, CUDA tensors the kernels."""
    assert V <= 32767, "int16 nxt entries require V <= 32767"
    if _on_cuda(wire):
        from alignasm_tpu_torch.ops import cuda_blocked, cuda_densify

        return cuda_blocked.blocked_dp_nxt16(
            cuda_densify.densify_ragged(wire, B, V), Bk)
    return solve_slab_topo_nxt16_blocked(densify_wire_ragged(wire, B, V), Bk)
