"""Wrapper of the edge-sharded relaxation kernels (csrc/shard_relax.cu).

Counterpart of the XLA program ``alignasm_tpu/parallel/mesh.py:40``
``make_edge_sharded_sp``.  It takes CUDA tensors only and raises on
anything else; the plain version for CPU tensors is
``parallel/mesh.py:edge_sharded_sp_plain``.  ``launches`` counts the calls
that launched the kernels, ``rounds`` the calls that ran the sharded
Jacobi rounds, and ``sweeps`` is the number of sweeps the last call's
rounds ran (None when its checked pass solved the contig).
"""

from __future__ import annotations

import numpy as np
import torch

from alignasm_tpu_torch.engine.device import _RANK_SHIFT
from alignasm_tpu_torch.ops import _build

INF = 2**62
# (name, dtype) of a shard's edge columns, in the order of the JAX program
EDGE_COLUMNS = (("eu", torch.int32), ("ev", torch.int32),
                ("es", torch.int64), ("ea", torch.int32),
                ("enz", torch.int32), ("etot", torch.int32),
                ("erank", torch.int64), ("evalid", torch.bool))
MAX_SHARDS = 64  # csrc/shard_relax.cu's event table
ROUTES = ("pass", "rounds")
# History entries of the pass's pool per vertex (64 bytes each): a chain's
# vertex changes about once (chip_smoke.py's giant contig needs between
# V / 2 and V entries), a denser DAG's a few times (the 60-record giant
# contig of tests/test_torch_mesh.py more than 4 V); a contig that needs
# more takes the rounds (check (d)).
POOL_PER_VERTEX = 16
# Device bytes of the pass per valid edge (its seven columns, the row's
# cache, the CSR sort's copies), per vertex (CSR offsets, flags, hint and
# its keys, pos, list heads, outputs) and per pool entry.
_PASS_EDGE_BYTES = 2 * 37 + 12
_PASS_VERTEX_BYTES = 8 + 4 + 4 + 16 + 4 + 8 + 32
_POOL_ENTRY_BYTES = 64


def _check(shards, V: int, dest: int) -> None:
    if not 1 <= len(shards) <= MAX_SHARDS:
        raise ValueError(f"1 to {MAX_SHARDS} shards, got {len(shards)}")
    if not 0 <= dest < V < 2**31:
        raise ValueError(f"need 0 <= dest < V < 2^31, got dest {dest}, V {V}")
    for shard in shards:
        if len(shard) != len(EDGE_COLUMNS):
            raise ValueError(f"a shard holds {len(EDGE_COLUMNS)} columns")
        for t, (name, dtype) in zip(shard, EDGE_COLUMNS):
            _build.require(t, name, dtype, 1)
            if t.shape != shard[0].shape or t.device != shard[0].device:
                raise ValueError(f"{name} must match eu's length and device")
        eu = shard[0]
        if int(eu.numel()) and (int(eu.min()) < 0 or int(eu.max()) >= V):
            raise ValueError(f"eu must lie in [0, {V})")


def shard_relax(shards, V: int, n_sweeps: int, dest: int, route="pass"):
    """``n_sweeps`` Jacobi sweeps of the edge-sharded int64 distance to
    ``dest``: ``shards`` is one (eu, ev, es, ea, enz, etot, erank, evalid)
    tuple of 1-D CUDA tensors per mesh entry, each on its entry's device
    (a device may repeat; shard 0's is the first device), eu in [0, V).
    Returns (ds, da, dnz, dtot), (V,) int64 on the first device, the
    outputs of the JAX program.

    ``route="pass"`` (the default) solves the contig in the checked
    history-replay pass on the first device and takes the rounds only
    when a check fails or the pass does not fit the device's free memory;
    ``route="rounds"`` runs the sharded Jacobi rounds alone (stopping at
    their fixpoint)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    _check(shards, V, dest)
    lib = _build.load_library()
    out = _pass(lib, shards, V, n_sweeps, dest) if route == "pass" else None
    shard_relax.sweeps = None
    if out is None:
        out = _rounds(lib, shards, V, n_sweeps, dest)
        shard_relax.rounds += 1
    shard_relax.launches += 1
    return out


def _pass_bytes(V: int, E: int) -> int:
    return (_PASS_EDGE_BYTES * E + _PASS_VERTEX_BYTES * V
            + _POOL_ENTRY_BYTES * POOL_PER_VERTEX * V)


def pass_inputs(shards, V: int, dev0):
    """The pass's inputs on ``dev0`` (any device: the tests emulate the
    kernel on the CPU): every shard's valid edges gathered in one CSR by
    eu (``start``, V + 1 int64 offsets, then ev, es, ea, enz, etot, erank
    in CSR order), ``inv`` (V int32: an invalid edge leaves the vertex)
    and the hint ``order`` (V int32), derived from erank's high bits (each
    edge target's position in the reversed graph's Kahn order,
    engine/device.py:pack_graph): the edge targets by that position
    descending, after the vertices no edge enters (an out-of-range head
    fails the kernel's check (a))."""
    cols = [[] for _ in range(7)]
    inv = torch.zeros(V, dtype=torch.int32, device=dev0)
    for eu, *rest, evalid in shards:
        keep = torch.nonzero(evalid).squeeze(1)
        for j, c in enumerate((eu, *rest)):
            cols[j].append(c[keep].to(dev0))
        inv.index_fill_(0, eu[~evalid].long().to(dev0), 1)
    eu, ev, es, ea, enz, etot, erank = (torch.cat(c) for c in cols)
    by_u = torch.argsort(eu, stable=True)
    edges = [c[by_u].contiguous() for c in (ev, es, ea, enz, etot, erank)]
    start = torch.zeros(V + 1, dtype=torch.int64, device=dev0)
    start[1:] = torch.cumsum(torch.bincount(eu.long(), minlength=V), 0)
    kahn = torch.full((V,), -1, dtype=torch.int64, device=dev0)
    inr = (ev >= 0) & (ev < V)
    kahn.scatter_(0, ev[inr].long(), erank[inr] >> _RANK_SHIFT)
    key = torch.where(kahn < 0, torch.iinfo(torch.int64).min, -kahn)
    order = torch.argsort(key, stable=True).to(torch.int32)
    return start, *edges, inv, order


def _pass(lib, shards, V: int, n_sweeps: int, dest: int):
    """The checked pass on the first device (``pass_inputs``), or None
    when the contig must take the rounds: it does not fit the device's
    free memory, or the kernel's check (a) or (d) failed."""
    dev0 = shards[0][0].device
    E = sum(int(shard[7].sum()) for shard in shards)
    if _pass_bytes(V, E) > torch.cuda.mem_get_info(dev0)[0]:
        return None
    args = pass_inputs(shards, V, dev0)
    cap = POOL_PER_VERTEX * V
    work = torch.empty(lib.aln_shard_pass_work_words(V, E, cap),
                       dtype=torch.int64, device=dev0)
    flag = torch.zeros(1, dtype=torch.int32, device=dev0)
    out = torch.empty((4, V), dtype=torch.int64, device=dev0)
    device, stream = _build.stream_of(out)
    rc = lib.aln_shard_pass(device, *(a.data_ptr() for a in args), V, E,
                            dest, int(n_sweeps), cap, work.data_ptr(),
                            flag.data_ptr(), out.data_ptr(), stream)
    _build.check(rc, "shard_relax")
    if int(flag):  # a check failed
        return None
    return out[0], out[1], out[2], out[3]


def _rounds(lib, shards, V: int, n_sweeps: int, dest: int):
    """The sharded Jacobi rounds: each shard's valid edges put in CSR
    order by eu on its device, beside a byte a vertex that says whether
    the shard holds any edge of it; every device's current stream runs its
    shards, and each sweep's fold of a remote shard is copied to the first
    device and the merged state back, until the fixpoint or ``n_sweeps``."""
    dev0 = shards[0][0].device
    state0 = torch.zeros((5, V), dtype=torch.int64, device=dev0)
    state0[0] = INF
    state0[4] = INF
    state0[0, dest] = 0
    state0[4, dest] = -1
    alive, rows, locs0 = [state0], [], []
    for eu, *cols, evalid in shards:
        d = eu.device
        has = (torch.bincount(eu.long(), minlength=V) > 0).to(torch.uint8)
        valid = torch.nonzero(evalid).squeeze(1)
        order = valid[torch.argsort(eu[valid], stable=True)]
        off = torch.zeros(V + 1, dtype=torch.int64, device=d)
        off[1:] = torch.cumsum(torch.bincount(eu[valid].long(), minlength=V),
                               0)
        cols = [c[order].contiguous() for c in cols] + [has]
        state = state0 if d == dev0 else torch.empty_like(state0, device=d)
        if d != dev0:
            state.copy_(state0)
        loc = torch.empty((7, V), dtype=torch.int64, device=d)
        loc0 = loc if d == dev0 else torch.empty_like(loc, device=dev0)
        alive += [off, *cols, state, loc, loc0]
        locs0.append(loc0.data_ptr())
        rows.append([d.index, torch.cuda.current_stream(d).cuda_stream,
                     off.data_ptr(), *(c.data_ptr() for c in cols),
                     state.data_ptr(), loc.data_ptr(), loc0.data_ptr()])
    ptrs = torch.tensor(locs0, dtype=torch.int64, device=dev0)
    last = torch.full((1,), -1, dtype=torch.int64, device=dev0)
    seen = torch.empty(2, dtype=torch.int64, pin_memory=True)
    swept = np.zeros(1, np.int64)
    desc = np.ascontiguousarray(np.asarray(rows, dtype=np.int64))
    rc = lib.aln_shard_relax(desc.ctypes.data, len(shards), V, int(n_sweeps),
                             ptrs.data_ptr(), last.data_ptr(),
                             seen.data_ptr(), swept.ctypes.data)
    _build.check(rc, "shard_relax")
    shard_relax.sweeps = int(swept[0])
    return state0[0], state0[1], state0[2], state0[3]


shard_relax.launches = 0
shard_relax.rounds = 0
shard_relax.sweeps = None
