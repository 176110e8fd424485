"""The port's multi-device engine on the CPU (alignasm_tpu_torch/parallel,
the mesh branches of runtime/scheduler.py), against the JAX package under
tests/conftest.py's 8-device virtual CPU mesh.

A mesh of repeated CPU entries (``("cpu",) * 8``, and ``("cpu",) * 3``,
a mesh that is not a power of two) drives the sharded code: the data axis
of both planes (the fixed-width wire's densify and scan, the Python
plane's dense and int32 buckets), the graph axis (the literal rounds of
``make_edge_sharded_sp``, and numpy emulations of csrc/shard_relax.cu's
checked pass and of its rounds' fused fold and fixpoint exit), a resumed
run and multihost.  Every value is an integer, so
the tolerance is bit-equality; files are compared byte for byte with the
port's ``native.run``.
"""

import copy
import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from alignasm_tpu_torch import native
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.io.paf import read_paf
from alignasm_tpu_torch.ops import dense as tdense
from alignasm_tpu_torch.parallel import mesh as tmesh
from alignasm_tpu_torch.runtime import scheduler
from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch
from alignasm_tpu_torch.testing.synth import generate_hard_paf, generate_paf

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
SUFFIXES = ("", ".alt", ".all")
CFG = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
MESHES = {"mesh8": ("cpu",) * 8, "mesh3": ("cpu",) * 3}
INF = 2**62
INT64_MAX = 2**63 - 1


def _outputs(prefix):
    return [Path(f"{prefix}.aln{s}.paf").read_bytes() for s in SUFFIXES]


def _jcfg(cfg):
    from alignasm_tpu.config import DEFAULT_CONFIG as JCFG

    return dataclasses.replace(JCFG, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _corpus(tmp_path, name):
    """(paf, cfg): synth50 and synth_hard (committed); long60, 60 long
    contigs in one V = 512 bucket, which stays on the mesh's first device
    (the blocked solve), and at ``device_max_v=256`` in a V = 256 bucket
    of the data axis (``long60-v256``), the rest native."""
    if not name.startswith("long60"):
        return DATA / f"{name}.paf", CFG
    paf = tmp_path / "long60.paf"
    paf.write_text(generate_paf(n_contigs=60, seed=9,
                                max_records_per_contig=180))
    if name == "long60-v256":
        return paf, dataclasses.replace(CFG, device_max_v=256)
    return paf, CFG


def _exporter_wires(paf, cfg=CFG):
    """(V, wire) of every V <= 256 device bucket of ``paf``, exported
    with the fixed-width wire as the data axis exports it (rejected
    contigs dropped)."""
    with native.GraphExporter(str(paf), config=cfg,
                              max_records=scheduler._device_cap(cfg)) as exp:
        meta = exp.meta_bulk()
        idx = np.where(scheduler._eligible_mask(meta, cfg))[0]
        n_v, n_edges = meta[:, 2], meta[:, 3]
        order = idx[n_v[idx].argsort(kind="stable")]
        out = []
        for V, idxs in scheduler._dense_buckets(order, n_v):
            if V > scheduler.MAX_V:
                continue
            W = scheduler._next_pow2(int(n_edges[idxs].max()) + 2)
            wire, ok = exp.export_wire(idxs, V, W)
            out.append((int(V), wire[ok]))
    return out


# --- the fixed-width wire: densify_wire and dense_solve_wire_topo_nxt8 ----

@pytest.mark.parametrize("name", ["synth50", "synth_hard", "long60-v256"])
def test_densify_wire_and_scan_match_jax_on_exporter_wires(tmp_path, name):
    """The plain densify of the fixed-width wire and the solve from it
    equal JAX's ``_densify_wire`` and ``dense_solve_wire_topo_nxt8`` on
    every V <= 256 bucket's exported wire."""
    from alignasm_tpu.ops import dense as jdense

    wires = _exporter_wires(*_corpus(tmp_path, name))
    assert wires
    for V, wire in wires:
        t = torch.from_numpy(wire)
        slabs = tdense.densify_wire(t, V)
        np.testing.assert_array_equal(
            slabs.numpy(), np.asarray(jdense._densify_wire(wire, V)))
        np.testing.assert_array_equal(
            tdense.dense_solve_wire_topo_nxt8(t, V).numpy(),
            np.asarray(jdense.dense_solve_wire_topo_nxt8(wire, V=V)))


def test_densify_wire_index_rules_match_jax():
    """Cells past the trash cell are dropped and a negative cell counts
    from the end of the (M+1)-cell buffer once, as a JAX index does (-1 is
    the trash cell, -2 the last real cell)."""
    from alignasm_tpu.ops import dense as jdense

    rng = np.random.default_rng(3)
    B, V, W = 5, 8, 24
    M = V * (V + 1)
    idx = rng.integers(-M - 8, M + 8, (B, W))
    for b in range(B):  # unique cells per contig, as exporter wires are
        idx[b] = rng.permutation(np.arange(-M - 8, M + 8))[:W]
    wire = np.stack([idx, rng.integers(0, 2**20, (B, W))], 1).astype(np.int32)
    np.testing.assert_array_equal(
        tdense.densify_wire(torch.from_numpy(wire), V).numpy(),
        np.asarray(jdense._densify_wire(wire, V)))


# --- the native plane's data axis ----------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ["synth50", "synth_hard", "long60",
                                  "long60-v256"])
def test_native_data_axis_matches_native_run_and_jax_engine(tmp_path, name,
                                                            mesh):
    """The native plane over a mesh: files byte-equal to the port's
    ``native.run``; the device, fallback, native_direct, singleton and
    dense_buckets counts equal the JAX engine's under its 8-device mesh;
    ``data_mesh_devices`` is the mesh's length and no bucket takes the
    16-bit wire."""
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    paf, cfg = _corpus(tmp_path, name)
    native.run(str(paf), out_prefix=str(tmp_path / "native"), config=cfg)
    solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                        write_prefix=str(tmp_path / "port"),
                        device=MESHES[mesh])
    stats = solve_dataset_torch.last_stats
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")
    assert "device_error" not in stats and stats["device"] > 0, stats
    assert stats["data_mesh_devices"] == len(MESHES[mesh])
    assert "wire16_buckets" not in stats
    solve_dataset_tpu(None, _jcfg(cfg), src_paths=(str(paf), None),
                      write_prefix=str(tmp_path / "jax"))
    jstats = solve_dataset_tpu.last_stats
    assert jstats["data_mesh_devices"] == 8
    for key in ("device", "fallback", "native_direct", "singleton"):
        assert stats[key] == jstats[key], (key, stats, jstats)
    # the buckets are the port's own (merge_cells = 2^25 against JAX's
    # 2^23): long60's V = 256 group pads up into its V = 512 bucket in the
    # port alone; the mesh changes no bucket
    if name == "long60":
        assert (stats["bucket_vs"], jstats["bucket_vs"]) == ([512], [256, 512])
    else:
        assert stats["dense_buckets"] == jstats["dense_buckets"]
        assert stats["bucket_vs"] == jstats["bucket_vs"]


def test_data_axis_pads_rows_by_repeating_the_last():
    """``_pad_rows`` pads dim 0 to a multiple of the mesh with copies of
    the last row; the rows the data axis reads back are sliced to the
    real batch before the finish."""
    a = np.arange(10).reshape(5, 2)
    assert scheduler._mesh_rows(5, 3) == 6 and scheduler._mesh_rows(6, 3) == 6
    (p,) = scheduler._pad_rows((a,), scheduler._mesh_rows(5, 3))
    assert p.shape == (6, 2) and (p[5] == a[4]).all() and (p[:5] == a).all()
    assert scheduler._pad_rows((a,), 5)[0] is a


def test_data_axis_pads_only_to_a_multiple_of_the_mesh(tmp_path,
                                                       monkeypatch):
    """The native data axis pads a bucket's rows to the next multiple of
    the mesh and no further (no power of two: nothing is compiled per
    shape), and each shard gets an equal slice of them."""
    paf, cfg = _corpus(tmp_path, "synth50")
    n = len(MESHES["mesh3"])
    pads, shards = [], []
    pad_rows, launch = scheduler._pad_rows, scheduler.launch_sharded

    def spy_pad(arrays, padB):
        pads.append((arrays[0].shape[0], padB))
        return pad_rows(arrays, padB)

    def spy_launch(mesh, arrays, fn):
        shards.append([arrays[0][sl].shape[0] for sl in
                       tmesh.shard_slices(arrays[0].shape[0], len(mesh))])
        return launch(mesh, arrays, fn)

    monkeypatch.setattr(scheduler, "_pad_rows", spy_pad)
    monkeypatch.setattr(scheduler, "launch_sharded", spy_launch)
    solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                        write_prefix=str(tmp_path / "port"),
                        device=MESHES["mesh3"])
    assert solve_dataset_torch.last_stats["device"] > 0
    assert pads and len(pads) == len(shards)
    for (B, padB), sizes in zip(pads, shards):
        assert padB % n == 0 and 0 <= padB - B < n, (B, padB)
        assert sizes == [padB // n] * n
    assert any(B & (B - 1) for B, _ in pads)  # a batch that is no pow2


def test_data_axis_export_failure_degrades_to_native_solve(tmp_path,
                                                           monkeypatch):
    """A failing fixed-width export (the host plane) degrades every contig
    to the native solve, with the reason recorded and a warning; the files
    stay byte-equal to native.run."""
    paf = tmp_path / "degrade.paf"
    paf.write_text(generate_paf(n_contigs=8, seed=5))

    def boom(*a, **k):
        raise RuntimeError("simulated host-plane failure")

    monkeypatch.setattr(native.GraphExporter, "export_wire", boom)
    with pytest.warns(RuntimeWarning, match="degraded"):
        solve_dataset_torch(None, CFG, src_paths=(str(paf), None),
                            write_prefix=str(tmp_path / "port"),
                            device=MESHES["mesh3"])
    stats = solve_dataset_torch.last_stats
    assert "simulated host-plane failure" in stats["device_error"], stats
    assert stats["device"] == 0 and stats["native_direct"] > 0
    native.run(str(paf), out_prefix=str(tmp_path / "native"), config=CFG)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")


def test_resumed_run_over_the_mesh(tmp_path, monkeypatch):
    """A half journal of synth50 resumed with the cuda engine over a mesh
    of three CPU entries (``solve_missing_torch_native``'s data axis,
    every bucket launched): the files equal native.run's."""
    import json

    from alignasm_tpu_torch.io.paf import write_outputs
    from alignasm_tpu_torch.runtime.checkpoint import (
        Journal, contig_digest, solve_dataset_resumable,
    )

    cal = tmp_path / "cal.json"
    cal.write_text(json.dumps({
        "finish_vs_solve": 0.2, "dispatch_rtt_s": 1e-7,
        "h2d_bytes_per_s": 1e12, "d2h_bytes_per_s": 1e12,
        "device_s_per_contig": 1e-9, "device_s_per_step": 1e-9,
        "solve_s_per_record": 1e-3}))
    monkeypatch.setenv("ALIGNASM_TORCH_COSTMODEL", str(cal))
    paf = DATA / "synth50.paf"
    dataset = read_paf(str(paf))
    full, journal = tmp_path / "full.journal", tmp_path / "j.journal"
    solve_dataset_resumable(dataset, DEFAULT_CONFIG, str(full),
                            engine="native", src_paths=(str(paf), None))
    src, dst = Journal(str(full)), Journal(str(journal))
    for c in dataset.contigs[::2]:
        key = contig_digest(c, DEFAULT_CONFIG)
        dst.put(key, src.get(key))
    src.close()
    dst.close()
    dataset = read_paf(str(paf))
    *results, stats = solve_dataset_resumable(
        dataset, DEFAULT_CONFIG, str(journal), engine="cuda",
        src_paths=(str(paf), None), device=MESHES["mesh3"])
    assert stats["resumed"] == 25 and stats["solved"] == 25, stats
    mstats = solve_dataset_torch.last_stats
    assert mstats["data_mesh_devices"] == 3 and mstats["device"] > 0, mstats
    for s, outs, counts in zip(SUFFIXES, results, (False, False, True)):
        with open(tmp_path / f"port.aln{s}.paf", "w") as fh:
            write_outputs(dataset, outs, fh, name_suffix_counts=counts)
    native.run(str(paf), out_prefix=str(tmp_path / "native"),
               config=DEFAULT_CONFIG)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")


# --- the Python plane's data mesh ----------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ["synth50", "synth_hard"])
def test_python_plane_data_mesh_matches_jax(name, mesh):
    """The Python plane over a mesh: dense and int32 buckets sharded, the
    results and counts equal the JAX Python plane's under its 8-device
    mesh."""
    from alignasm_tpu.io.paf import read_paf as jread
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    paf = DATA / f"{name}.paf"
    got = solve_dataset_torch(read_paf(paf), DEFAULT_CONFIG,
                              device=MESHES[mesh])
    stats = solve_dataset_torch.last_stats
    want = solve_dataset_tpu(jread(paf), _jcfg(DEFAULT_CONFIG))
    jstats = solve_dataset_tpu.last_stats
    assert repr(got) == repr(want)  # dataclass reprs name no module
    assert stats["data_mesh_devices"] == len(MESHES[mesh])
    for key in ("device", "fallback", "singleton", "oversize",
                "dense_buckets", "int32_buckets"):
        assert stats[key] == jstats[key], (key, stats, jstats)
    assert stats["jacobi"] == 0


def test_python_plane_int32_buckets_shard_over_the_mesh(monkeypatch):
    """With dense_max_v below every bucket's V, each bucket is int32
    sparse, sharded over the mesh: results equal the single-device run's
    and the goldens."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, dense_max_v=4)
    paf = DATA / "synth_hard.paf"
    one = solve_dataset_torch(read_paf(paf), cfg, device="cpu")
    got = solve_dataset_torch(read_paf(paf), cfg, device=MESHES["mesh3"])
    stats = solve_dataset_torch.last_stats
    assert stats["int32_buckets"] >= 1 and stats["dense_buckets"] == 0
    assert got == one


# --- the graph axis -------------------------------------------------------

def _giant_contig_edges(n_dev):
    """The exported edges of tests/test_device.py:216-220's giant contig,
    padded as the graph axis pads them for ``n_dev`` devices: the 8 edge
    arrays, (Vp, n_sweeps) and dest."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        paf = Path(tmp) / "giant.paf"
        paf.write_text(generate_paf(n_contigs=1, seed=6,
                                    max_records_per_contig=60,
                                    mean_segment=250))
        with native.GraphExporter(str(paf), config=CFG,
                                  max_records=8192) as exp:
            exp.build_graph_one(0)
            _b, V, E, _src, dest, n = exp.edge_meta(0)
            cols = exp.export_edges(0)
    Ep, Vp, n_sweeps = tmesh._pad_shapes(E, V, n, n_dev)
    dtypes = (np.int32, np.int32, np.int64, np.int32, np.int32, np.int32,
              np.int64)
    args = []
    for c, t in zip(cols, dtypes):
        a = np.zeros(Ep, t)
        a[:E] = c
        args.append(a)
    valid = np.zeros(Ep, bool)
    valid[:E] = True
    return (*args, valid), Vp, n_sweeps, dest


def _jax_sharded(args, Vp, n_sweeps, dest, n_dev):
    import jax

    from alignasm_tpu.parallel import mesh as jmesh

    m = jax.sharding.Mesh(np.array(jax.devices()[:n_dev]), ("graph",))
    sp = jmesh.make_edge_sharded_sp(m, "graph", Vp, n_sweeps)
    return [np.asarray(x) for x in sp(*args, np.int32(dest))]


@pytest.mark.parametrize("n_dev", [8, 2])
def test_edge_sharded_sp_matches_jax(n_dev):
    """The plain ``edge_sharded_sp`` (the port of ``make_edge_sharded_sp``)
    on the giant contig's exported edges: all four outputs bit-equal to
    JAX's on 8 devices and on ``Mesh(jax.devices()[:2])``."""
    args, Vp, n_sweeps, dest = _giant_contig_edges(n_dev)
    want = _jax_sharded(args, Vp, n_sweeps, dest, n_dev)
    got = tmesh.edge_sharded_sp(("cpu",) * n_dev, args, Vp, n_sweeps, dest)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _fused_emulation(args, V, n_sweeps, dest, n_dev, check=None):
    """csrc/shard_relax.cu's rounds in numpy and Python ints: each shard's
    valid edges in CSR order by eu (stable) and whether it holds any edge
    of a vertex; per vertex one lexicographic fold of its valid
    candidates' (k1, k2, rank) with the tied winners' payload minimum
    ((INF, INF, INF) and payload INF when the shard holds edges of the
    vertex but none valid, INT64_MAX throughout when it holds none), the
    lexicographic merge over the shards, then the state update.  With
    ``check`` the host loop's fixpoint exit: every ``check`` sweeps it
    notes the last sweep that changed a state word and reads the previous
    check's note, stopping when that check's sweep changed nothing.
    Returns (d_s, d_a, d_nz, d_tot) and the number of sweeps run."""
    cols = [np.asarray(a) for a in args]
    per = len(cols[0]) // n_dev
    shards = []
    for k in range(n_dev):
        part = [c[k * per:(k + 1) * per] for c in cols]
        has = set(part[0].tolist())
        keep = np.flatnonzero(part[7])
        order = keep[np.argsort(part[0][keep], kind="stable")]
        shards.append([p[order].tolist() for p in part[:7]] + [has])
    st = [[INF] * V, [0] * V, [0] * V, [0] * V, [INF] * V]
    st[0][dest], st[4][dest] = 0, -1

    def qul(nz, tot):
        return (1 << 30) - ((nz << 30) // (tot if tot else 1))

    def key(t):
        return (t[0], t[1], t[2])

    last, pending, run = -1, None, 0
    for sweep in range(n_sweeps):
        locs = []
        for eu, ev, es, ea, enz, etot, erank, has in shards:
            loc = [[INF] * 7 if u in has else [INT64_MAX] * 7
                   for u in range(V)]
            for e, u in enumerate(eu):
                v = ev[e]
                if st[0][v] >= INF:
                    continue
                cs, ca = st[0][v] + es[e], st[1][v] + ea[e]
                cnz, ctot = st[2][v] + enz[e], st[3][v] + etot[e]
                cand = [(cs << 16) | ca, qul(cnz, ctot), erank[e],
                        cs, ca, cnz, ctot]
                if key(cand) < key(loc[u]):
                    loc[u] = cand
                elif key(cand) == key(loc[u]):
                    loc[u][3:] = [min(x, y) for x, y in zip(loc[u][3:],
                                                            cand[3:])]
            locs.append(loc)
        for u in range(V):
            m = list(locs[0][u])
            for loc in locs[1:]:
                if key(loc[u]) < key(m):
                    m = list(loc[u])
                elif key(loc[u]) == key(m):
                    m[3:] = [min(x, y) for x, y in zip(m[3:], loc[u][3:])]
            s, a, nz, tot, rk = (st[j][u] for j in range(5))
            cur1 = (s << 16) | a if s < INF else INF
            cur2 = qul(nz, tot)
            better = m[0] < cur1 or (m[0] == cur1 and m[1] < cur2) or (
                m[0] == cur1 and m[1] == cur2 and m[2] < rk)
            if better and m[3] < INF:
                for j, x in enumerate((m[3], m[4], m[5], m[6], m[2])):
                    if st[j][u] != x:
                        last = sweep
                    st[j][u] = x
        run = sweep + 1
        if run == n_sweeps:
            break
        if check and run % check == 0:
            if pending is not None and pending[0] < pending[1]:
                break
            pending = (last, sweep)
    return [np.asarray(st[j], np.int64) for j in range(4)], run


def _tied_graph(n_dev, seed):
    """A random DAG of 24 vertices over ``n_dev`` shards whose edges tie:
    every edge appears twice (the copies mostly in different shards, so
    the merge meets the tie) with equal (k1, k2, rank); a copy into dest
    carries twice the mapq counts (the same k2, another payload, so the
    payload minimum decides), ranks repeat, some edges are invalid, and
    most vertices have no edge in most shards."""
    rng = np.random.default_rng(seed)
    V, dest = 24, 23
    us, vs = np.nonzero(np.triu(rng.random((V, V)) < 0.25, k=1))
    E = len(us)
    es = rng.integers(0, 50, E)
    rank = (rng.integers(0, 4, E) << 26) | rng.integers(0, 3, E)  # ties
    nz = rng.integers(0, 3, E)
    tot = nz + rng.integers(1, 3, E)
    twice = np.where(vs == dest, 2, 1)
    cols = [np.concatenate([c, c * m]) for c, m in (
        (us, 1), (vs, 1), (es, 1), (rng.integers(0, 4, E), 1), (nz, twice),
        (tot, twice), (rank, 1))]
    valid = np.concatenate([rng.random(E) < 0.9, np.ones(E, bool)])
    Ep = -(-2 * E // n_dev) * n_dev
    out = []
    for c, t in zip(cols + [valid], (np.int32, np.int32, np.int64, np.int32,
                                     np.int32, np.int32, np.int64, bool)):
        a = np.zeros(Ep, t)
        a[:len(c)] = c
        out.append(a)
    return out, V, dest


@pytest.mark.parametrize("case,n_dev,sweeps", [
    ("giant-full", 8, None), ("giant-1", 8, 1), ("giant-2", 8, 2),
    ("giant-3dev", 3, None), ("tied", 3, 30), ("tied-1", 2, 1),
    ("tied-8", 8, 30),
])
def test_fused_fold_matches_literal_rounds(case, n_dev, sweeps):
    """The kernel's one merge a sweep (``_fused_emulation``) equals the
    literal rounds (``edge_sharded_sp_plain``) and the JAX program: on the
    giant contig at full and cut sweeps (after one sweep most vertices'
    successors are unreachable: m1 == INF, no valid candidate) and over 3
    devices; on tied DAGs whose copies of an edge meet in the merge, with
    invalid edges and vertices that have no edge in a shard."""
    if case.startswith("giant"):
        args, V, n_sweeps, dest = _giant_contig_edges(n_dev)
    else:
        args, V, dest = _tied_graph(n_dev, seed=len(case) + n_dev)
        n_sweeps = None
    n_sweeps = sweeps or n_sweeps
    got, run = _fused_emulation(args, V, n_sweeps, dest, n_dev)
    assert run == n_sweeps
    plain = tmesh.edge_sharded_sp(("cpu",) * n_dev, args, V, n_sweeps, dest)
    want = _jax_sharded(args, V, n_sweeps, dest, n_dev)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(p.numpy(), w)
        np.testing.assert_array_equal(g, w)
    assert (want[0] < INF).sum() > 1  # the relaxation reached past dest


def _graph_axis_emulation(args, V, n_sweeps, dest, n_dev, order=None,
                          cap=None):
    """csrc/shard_relax.cu's default route in numpy and Python ints: its
    checked pass (tests/test_torch_relax64.py:_pass_contig with the
    edge-sharded winner, ``shard=True``) over the contig's edges, with the
    hint the wrapper derives (``cuda_shard_relax.pass_inputs``) unless
    ``order`` is given and a pool of ``POOL_PER_VERTEX * V`` entries
    unless ``cap`` is; a contig that fails check (a) or (d) takes the
    rounds with their fixpoint exit.  Returns (outputs, route)."""
    from alignasm_tpu_torch.ops import cuda_shard_relax as csr
    from tests.test_torch_relax64 import _pass_contig

    cols = [np.asarray(a) for a in args]
    if order is None:
        shards = [tuple(torch.from_numpy(c[sl]) for c in cols)
                  for sl in tmesh.shard_slices(len(cols[0]), n_dev)]
        order = csr.pass_inputs(shards, V, torch.device("cpu"))[-1].numpy()
    cap = csr.POOL_PER_VERTEX * V if cap is None else cap
    flag, out = _pass_contig(*cols, dest, V, n_sweeps, order, cap,
                             np.random.default_rng(0), shard=True)
    if flag:
        return _fused_emulation(args, V, n_sweeps, dest, n_dev,
                                check=4)[0], "rounds"
    return [out[k] for k in ("d_s", "d_a", "d_nz", "d_tot")], "pass"


@pytest.mark.parametrize("case,n_dev,sweeps,route", [
    ("giant-full", 8, None, "pass"), ("giant-1", 8, 1, "pass"),
    ("giant-2", 8, 2, "pass"), ("giant-3dev", 3, None, "pass"),
    ("tied", 3, 30, "pass"), ("tied-1", 2, 1, "pass"),
    ("tied-8", 8, 30, "pass"),
    # the hint fails check (a): reversed, and the tied DAGs' own, whose
    # ranks are no Kahn positions
    ("giant-reversed", 8, None, "rounds"), ("tied-hint", 3, 30, "rounds"),
    ("giant-pool", 8, None, "rounds"),  # too small a pool: check (d)
])
def test_graph_axis_pass_emulation_matches_literal_rounds(case, n_dev,
                                                          sweeps, route):
    """csrc/shard_relax.cu's checked pass (``_graph_axis_emulation``)
    equals the literal rounds (``edge_sharded_sp_plain``) and the JAX
    program on the giant contig at full and cut sweeps, on the tied DAGs
    (identity hint), and where check (a) or (d) fails, which sends the
    contig to the rounds."""
    order = cap = None
    if case.startswith("giant"):
        args, V, n_sweeps, dest = _giant_contig_edges(n_dev)
        if case == "giant-reversed":
            order = np.arange(V)[::-1]
        if case == "giant-pool":
            cap = V // 4
    else:
        args, V, dest = _tied_graph(n_dev, seed=len(case) + n_dev)
        n_sweeps = None
        if case != "tied-hint":
            order = np.arange(V)  # every edge climbs: u < v
    n_sweeps = sweeps or n_sweeps
    got, took = _graph_axis_emulation(args, V, n_sweeps, dest, n_dev, order,
                                      cap)
    assert took == route
    plain = tmesh.edge_sharded_sp(("cpu",) * n_dev, args, V, n_sweeps, dest)
    want = _jax_sharded(args, V, n_sweeps, dest, n_dev)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(p.numpy(), w)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case,n_dev", [("giant", 8), ("giant", 3),
                                        ("tied", 3), ("tied", 8)])
@pytest.mark.parametrize("depth", ["below", "above"])
def test_rounds_fixpoint_exit_matches_literal_rounds(case, n_dev, depth):
    """The rounds' fixpoint exit (a check every 4 sweeps in the
    emulation) equals the literal rounds and the JAX program at n_sweeps
    below the longest path L + 2, where no sweep is a fixpoint before the
    last, and above it, where the rounds stop early."""
    if case == "giant":
        args, V, _n, dest = _giant_contig_edges(n_dev)
    else:
        args, V, dest = _tied_graph(n_dev, seed=len(case) + n_dev)
    from tests.test_torch_relax64 import _longest

    L = _longest([np.asarray(a)[None] for a in args], 0, V)
    n_sweeps = max(1, L // 2) if depth == "below" else 2 * L + 16
    got, run = _fused_emulation(args, V, n_sweeps, dest, n_dev, check=4)
    if depth == "above":
        assert run < n_sweeps
    plain = tmesh.edge_sharded_sp(("cpu",) * n_dev, args, V, n_sweeps, dest)
    want = _jax_sharded(args, V, n_sweeps, dest, n_dev)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(p.numpy(), w)
        np.testing.assert_array_equal(g, w)


def _giant_corpus(tmp_path, seed_small=9):
    """Four small contigs and one giant one (tests/test_device.py:228-233)
    and the config that sends the giant contig to the graph axis."""
    p = tmp_path / "giant.paf"
    small = generate_paf(n_contigs=4, seed=seed_small,
                         max_records_per_contig=12)
    big = generate_paf(n_contigs=1, seed=6, max_records_per_contig=60,
                       mean_segment=250)
    big = "\n".join("\t".join(["giantctg"] + ln.split("\t")[1:])
                    for ln in big.splitlines() if ln) + "\n"
    p.write_text(small + big)
    n_big = max(len(c) for c in read_paf(p).contigs)
    cfg = dataclasses.replace(CFG, max_device_records=max(16, n_big - 1),
                              graph_shard_min_records=min(n_big, 48))
    return p, cfg


@pytest.mark.parametrize("mesh", list(MESHES))
def test_native_graph_axis_matches_exact_and_native_run(tmp_path, mesh):
    """tests/test_device.py:209 without the oracle: the giant contig takes
    the graph axis and the rest keeps the native plane; the in-memory
    results equal the exact engine's and the files native.run's."""
    from alignasm_tpu_torch.engine.exact import solve_dataset

    p, cfg = _giant_corpus(tmp_path)
    ds = read_paf(p)
    want = solve_dataset(copy.deepcopy(ds), cfg)
    got = solve_dataset_torch(ds, cfg, src_paths=(str(p), None),
                              device=MESHES[mesh])
    stats = solve_dataset_torch.last_stats
    assert stats["host_plane"] == "native", stats
    assert stats.get("graph_sharded", 0) >= 1, stats
    assert "device_error" not in stats and "shard_s" in stats, stats
    assert tuple(got) == tuple(want)
    solve_dataset_torch(None, cfg, src_paths=(str(p), None),
                        write_prefix=str(tmp_path / "port"),
                        device=MESHES[mesh])
    assert solve_dataset_torch.last_stats["graph_sharded"] == 1
    native.run(str(p), out_prefix=str(tmp_path / "native"), config=cfg)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")


def test_native_graph_axis_counts_match_jax_engine(tmp_path):
    """The same run's counts equal the JAX engine's on its 8-device mesh,
    graph_sharded included."""
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    p, cfg = _giant_corpus(tmp_path)
    solve_dataset_torch(None, cfg, src_paths=(str(p), None),
                        write_prefix=str(tmp_path / "port"),
                        device=MESHES["mesh8"])
    stats = solve_dataset_torch.last_stats
    solve_dataset_tpu(None, _jcfg(cfg), src_paths=(str(p), None),
                      write_prefix=str(tmp_path / "jax"))
    jstats = solve_dataset_tpu.last_stats
    for key in ("device", "fallback", "native_direct", "singleton",
                "oversize", "graph_sharded", "dense_buckets"):
        assert stats.get(key) == jstats.get(key), (key, stats, jstats)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "jax")


def test_graph_axis_host_failure_degrades_to_native(tmp_path, monkeypatch):
    """tests/test_device.py:373 without the oracle: a host-plane failure
    of the sharded solve stops the graph axis with the reason recorded,
    and the native solve covers the contig; the files stay byte-equal to
    native.run."""
    p, cfg = _giant_corpus(tmp_path, seed_small=11)

    def boom(*a, **k):
        raise native.NativeError("simulated mesh failure")

    monkeypatch.setattr(tmesh, "solve_contig_sharded_native", boom)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # degrade notice
        solve_dataset_torch(None, cfg, src_paths=(str(p), None),
                            write_prefix=str(tmp_path / "port"),
                            device=MESHES["mesh8"])
    stats = solve_dataset_torch.last_stats
    assert "simulated mesh failure" in stats["device_error"], stats
    assert stats.get("graph_sharded", 0) == 0, stats
    # the giant contig fits the vertex ceiling: the device buckets take it
    # (the data axis: its bucket is V = 128), as in the JAX test
    assert stats["device"] + stats["fallback"] == 5, stats
    native.run(str(p), out_prefix=str(tmp_path / "native"), config=cfg)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")


def test_graph_axis_kernel_failure_raises(tmp_path, monkeypatch):
    """A failure of the relaxation itself (a kernel's build or launch) is
    not degraded: it raises, and nothing is written."""
    p, cfg = _giant_corpus(tmp_path)

    def failing(*a, **k):
        raise RuntimeError("shard_relax: CUDA launch failed (2: out of "
                           "memory)")

    monkeypatch.setattr(tmesh, "edge_sharded_sp", failing)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        solve_dataset_torch(None, cfg, src_paths=(str(p), None),
                            write_prefix=str(tmp_path / "port"),
                            device=MESHES["mesh3"])
    assert not list(tmp_path.glob("port.aln*"))


def test_python_plane_graph_axis_matches_exact(tmp_path):
    """tests/test_device.py:122 without the oracle, on the Python plane:
    an oversize contig over graph_shard_min_records takes the graph axis
    (``solve_contig_sharded``), results equal the exact engine's and the
    JAX plane's."""
    from alignasm_tpu.io.paf import read_paf as jread
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu
    from alignasm_tpu_torch.engine.exact import solve_dataset

    paf = tmp_path / "shard.paf"
    paf.write_text(generate_paf(n_contigs=1, seed=6,
                                max_records_per_contig=60, mean_segment=250))
    ds = read_paf(paf)
    assert len(ds.contigs[0]) >= 40
    cfg = dataclasses.replace(DEFAULT_CONFIG, max_device_records=16,
                              graph_shard_min_records=32)
    want = solve_dataset(copy.deepcopy(ds), cfg)
    got = solve_dataset_torch(ds, cfg, device=MESHES["mesh8"])
    stats = solve_dataset_torch.last_stats
    assert stats["graph_sharded"] == 1 and stats["oversize"] == 1, stats
    assert tuple(got) == tuple(want)
    assert repr(got) == repr(solve_dataset_tpu(jread(paf), _jcfg(cfg)))
    assert solve_dataset_tpu.last_stats["graph_sharded"] == 1


def test_one_device_takes_neither_axis(tmp_path):
    """On one device the graph axis does not run (the giant contig solves
    natively) and no data_mesh_devices is written, as in JAX on one
    device."""
    p, cfg = _giant_corpus(tmp_path)
    solve_dataset_torch(None, cfg, src_paths=(str(p), None),
                        write_prefix=str(tmp_path / "port"), device="cpu")
    stats = solve_dataset_torch.last_stats
    assert "graph_sharded" not in stats and "data_mesh_devices" not in stats
    native.run(str(p), out_prefix=str(tmp_path / "native"), config=cfg)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")


# --- the mesh, the wrappers --------------------------------------------

def test_as_mesh():
    assert tmesh.as_mesh("cpu") == (torch.device("cpu"),)
    assert tmesh.as_mesh(("cpu",) * 3) == (torch.device("cpu"),) * 3
    assert tmesh.as_mesh([torch.device("cpu")]) == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="one type"):
        tmesh.as_mesh(())
    with pytest.raises(ValueError, match="unsupported device"):
        tmesh.as_mesh("meta")


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", ("cuda:0", "cuda:0")):
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.as_mesh(device)


def test_new_kernel_wrappers_take_only_cuda_tensors():
    """densify_wire and shard_relax refuse CPU tensors (their plain
    versions are ``ops/dense.py:densify_wire`` and
    ``parallel/mesh.py:edge_sharded_sp_plain``) and launch nothing."""
    from alignasm_tpu_torch.ops import cuda_densify, cuda_shard_relax

    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_densify.densify_wire(torch.zeros((2, 2, 8), dtype=torch.int32),
                                  8)
    args, V, n_sweeps, dest = _giant_contig_edges(2)
    shard = tuple(torch.from_numpy(a) for a in args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_shard_relax.shard_relax([shard], V, n_sweeps, dest)
    with pytest.raises(ValueError, match="dest < V"):
        cuda_shard_relax.shard_relax([shard], V, n_sweeps, V)
    with pytest.raises(ValueError, match="route"):
        cuda_shard_relax.shard_relax([shard], V, n_sweeps, dest,
                                     route="sweeps")
    assert cuda_densify.densify_wire.launches == 0
    assert cuda_shard_relax.shard_relax.launches == 0
    assert cuda_shard_relax.shard_relax.rounds == 0


def test_mesh_paths_import_no_jax(tmp_path):
    """Both planes' data axes and the graph axis over a CPU mesh load no
    JAX module and nothing of the JAX package."""
    p, _cfg = _giant_corpus(tmp_path)
    code = (
        "import dataclasses, sys\n"
        "from alignasm_tpu_torch.config import DEFAULT_CONFIG as C\n"
        "from alignasm_tpu_torch.io.paf import read_paf\n"
        "from alignasm_tpu_torch.runtime.scheduler import "
        "solve_dataset_torch as s\n"
        f"p = {str(p)!r}\n"
        "cfg = dataclasses.replace(C, device_routing='always', "
        f"max_device_records=16, graph_shard_min_records=32)\n"
        "s(None, cfg, src_paths=(p, None), device=('cpu',) * 3)\n"
        "assert s.last_stats['graph_sharded'] == 1\n"
        "s(read_paf(p), cfg, device=('cpu',) * 3)\n"
        "assert s.last_stats['graph_sharded'] == 1\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'alignasm_tpu.')) or m == 'alignasm_tpu']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   capture_output=True, timeout=300)


# --- multihost --------------------------------------------------------------

# The port's multihost.py is the JAX package's with its import prefixes
# changed and these lines edited: torch.distributed's gloo group in place
# of jax.distributed (and the comment and help text that name it).
MULTIHOST_EDITS = {
    '"""Multi-host scale-out over jax.distributed.':
        '"""Multi-host scale-out over torch.distributed.',
    "            import jax\n\n"
    "            jax.distributed.initialize(\n"
    "                coordinator_address=coordinator,\n"
    "                num_processes=num_processes,\n"
    "                process_id=process_id,\n":
        "            import torch.distributed as dist\n\n"
        "            dist.init_process_group(\n"
        '                "gloo", init_method=f"tcp://{coordinator}",\n'
        "                world_size=num_processes, rank=process_id,\n",
    "    # jax.distributed; its grpc handshake costs ~1.2 s of fixed latency\n"
    "    # per job); the solve/merge itself is shared-filesystem.":
        "    # torch.distributed's gloo group at tcp://<coordinator>); the\n"
        "    # solve/merge itself is shared-filesystem.",
    'help="initialize jax.distributed (needed only when "\n'
    '                        "ranks drive accelerator collectives)")':
        'help="initialize torch.distributed (gloo; needed only "\n'
        '                        "when ranks drive accelerator '
        'collectives)")',
}


def test_multihost_copy_differs_only_in_its_listed_edits():
    src = (REPO / "alignasm_tpu/parallel/multihost.py").read_text()
    port = (REPO / "alignasm_tpu_torch/parallel/multihost.py").read_text()
    for old, new in MULTIHOST_EDITS.items():
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src = src.replace("from alignasm_tpu import", "from alignasm_tpu_torch "
                      "import").replace("alignasm_tpu.", "alignasm_tpu_torch.")
    assert port == src


@pytest.mark.parametrize("device_runtime", [False, True],
                         ids=["native", "gloo"])
def test_multihost_two_ranks_match_native_run(tmp_path, device_runtime):
    """``python -m alignasm_tpu_torch.parallel.multihost --local-procs 2``
    (with ``--device-runtime``: a gloo process group over localhost) writes
    the files of the port's native.run."""
    import socket

    paf = tmp_path / "mh.paf"
    paf.write_text(generate_hard_paf(n_contigs=30, seed=4))
    ref = tmp_path / "ref.paf"
    ref.write_bytes(paf.read_bytes())
    cmd = [sys.executable, "-m", "alignasm_tpu_torch.parallel.multihost",
           str(paf), "--local-procs", "2"]
    if device_runtime:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        cmd += ["--device-runtime", "--coordinator", f"localhost:{port}"]
    subprocess.run(cmd, check=True, cwd=REPO, capture_output=True,
                   timeout=300)
    native.run(str(ref), out_prefix=str(tmp_path / "ref"))
    assert _outputs(tmp_path / "mh") == _outputs(tmp_path / "ref")
