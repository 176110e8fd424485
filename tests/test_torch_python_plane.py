"""The port's Python plane on the CPU against the JAX package.

The plain PyTorch versions of the three new device functions — the dense
sweep solve (``dense_solve_batch`` / ``dense_solve_slabs``), the int32
sparse relaxation (``sp_batch32``) and the dense shortest-path fixed
point (``dense_sp``) — and the int64 relaxation (``solve_graph_batch``)
are held bit for bit to the JAX functions (the Pallas kernels in
interpret mode); then ``solve_dataset_torch(dataset, cfg,
device="cpu")`` to ``solve_dataset_tpu(dataset, cfg)``, results and
counts; the native plane's degrade to it; and the copies the port keeps
of the JAX package's JAX-free modules.  Inputs are made with numpy from
a seed or read from the committed PAF files; every value is an integer
or an exactly rounded f32 key, so the tolerance is 0.
"""

import dataclasses
import io
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from alignasm_tpu import native as jnative
from alignasm_tpu.config import DEFAULT_CONFIG as JCFG
from alignasm_tpu.engine.device import pack_graph as jpack_graph
from alignasm_tpu.engine.graph import build_graph as jbuild_graph
from alignasm_tpu.io.paf import read_paf as jread_paf
from alignasm_tpu.ops import dense as jdense
from alignasm_tpu.ops import pallas_relax as jpr
from alignasm_tpu.ops.relax import solve_graph_batch as jsolve_graph_batch
from alignasm_tpu.ops.relax32 import sp_batch32 as jsp_batch32
from alignasm_tpu.runtime.scheduler import solve_dataset_tpu
from alignasm_tpu.testing import synth as jsynth
from alignasm_tpu_torch import cli, native
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.io.paf import read_paf, write_outputs
from alignasm_tpu_torch.ops import dense, dense_sp, relax, relax32
from alignasm_tpu_torch.runtime import scheduler
from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch
from alignasm_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
SUFFIXES = ("", ".alt", ".all")
INF32 = 2**30


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _rand_dag_bucket(B, V, density, seed):
    """Random topo-ordered DAGs as dense (B, V, V) ws / wa matrices, with
    random dests (a sink each) and sources."""
    rng = np.random.default_rng(seed)
    mask = np.triu(rng.random((B, V, V)) < density, k=1)
    dests = rng.integers(V // 2, V, B).astype(np.int32)
    for b in range(B):
        mask[b, dests[b], :] = False
    ws = np.where(mask, rng.integers(0, 5000, (B, V, V)), INF32)
    wa = np.where(mask, rng.integers(0, 4, (B, V, V)), 0)
    return ws.astype(np.int32), wa.astype(np.int32), dests


@pytest.mark.parametrize("V,density,seed,n_sweeps", [
    (8, 0.5, 0, 1), (16, 0.3, 1, 4), (32, 0.2, 2, 64), (64, 0.05, 3, 64),
])
def test_sweep_solve_matches_dense_solve_batch(V, density, seed, n_sweeps):
    """The dense sweep solve's plain version bit-equals the JAX
    ``dense_solve_batch``, converged or not (few sweeps)."""
    ws, wa, dests = _rand_dag_bucket(6, V, density, seed)
    want = np.asarray(jdense.dense_solve_batch(ws, wa, dests,
                                               n_sweeps=n_sweeps))
    got = dense.dense_solve_batch(*_t(ws, wa, dests), n_sweeps)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_sweeps", [3, 8])
def test_sweep_slabs_match_pallas_interpret(n_sweeps):
    """The slab entry's plain version bit-equals
    ``dense_solve_slabs_pallas`` in interpret mode on the random slabs of
    tests/test_dense.py (B 4, V 16, S 8), and on dests and sources
    outside the slab."""
    rng = np.random.default_rng(12)
    B, V = 4, 16
    mask = np.triu(rng.random((B, V, V)) < 0.25, k=1)
    packed = np.full((B, V + 1, V), INF32, np.int32)
    scores = rng.integers(1, 1000, (B, V, V)).astype(np.int32)
    anoms = rng.integers(0, 3, (B, V, V)).astype(np.int32)
    packed[:, :V][mask] = scores[mask] | (anoms[mask] << jdense.ANOM_SHIFT)
    packed[:, V, 0] = rng.integers(V // 2, V, B)
    packed[:, V, 1] = rng.integers(0, V // 2, B)
    packed[3, V, :2] = (V + 3, V + 5)  # no dest, src outside: picks are 0
    want = np.asarray(jdense.dense_solve_slabs_pallas(
        packed, n_sweeps=n_sweeps, interpret=True))
    got = dense.dense_solve_slabs(torch.from_numpy(packed), n_sweeps)
    np.testing.assert_array_equal(got.numpy(), want)


def _graphs(path, max_v=64, max_n=24):
    """(JAX PackedGraph, port PackedGraph) pairs of the small contigs of
    ``path``, built by each package."""
    from alignasm_tpu_torch.engine.device import pack_graph
    from alignasm_tpu_torch.engine.graph import build_graph

    out = []
    for jc, tc in zip(jread_paf(path).contigs, read_paf(path).contigs):
        if not 2 <= len(jc) <= max_n:
            continue
        jpg = jpack_graph(jbuild_graph(jc, JCFG))
        if jpg.g.n_vertices <= max_v:
            out.append((jpg, pack_graph(build_graph(tc, DEFAULT_CONFIG))))
    assert out
    return out


def _pad_edges(pgs, E, es_dtype=np.int32):
    """(B, E) edge lists of packed graphs, padded with invalid 0 -> 0
    edges."""
    B = len(pgs)

    def pad(arrs, dtype):
        out = np.zeros((B, E), dtype)
        for b, a in enumerate(arrs):
            out[b, : len(a)] = a
        return out

    evalid = np.zeros((B, E), bool)
    for b, pg in enumerate(pgs):
        evalid[b, : len(pg.eu)] = True
    return dict(
        eu=pad([pg.eu for pg in pgs], np.int32),
        ev=pad([pg.ev for pg in pgs], np.int32),
        es=pad([pg.es for pg in pgs], es_dtype),
        ea=pad([pg.ea for pg in pgs], np.int32),
        enz=pad([pg.enz for pg in pgs], np.int32),
        etot=pad([pg.etot for pg in pgs], np.int32),
        erank=pad([pg.erank for pg in pgs], np.int64),
        evalid=evalid,
        src=np.asarray([pg.g.src for pg in pgs], np.int32),
        dest=np.asarray([pg.g.dest for pg in pgs], np.int32),
    )


@pytest.mark.parametrize("n_sweeps", [None, 2, 30])
def test_relax32_matches_sp_batch32(n_sweeps):
    """The int32 sparse relaxation's plain version bit-equals the JAX
    ``sp_batch32`` on padded buckets: padding edges (0 -> 0, invalid),
    vertices past a contig's own (no out-edge: segment_min's identity
    2^31 - 1) and a contig whose only edge leaves a sink-only vertex."""
    pgs = [jpg for jpg, _tpg in _graphs(DATA / "synth_small.paf")]
    e = _pad_edges(pgs, 1 << (max(len(pg.eu) for pg in pgs) + 8).bit_length())
    # one more contig: 0 -> 1 only, dest 2 unreachable, vertex 3 isolated
    for k, val in dict(eu=0, ev=1, es=7, ea=1, evalid=True, src=0,
                       dest=2).items():
        row = np.zeros_like(e[k][:1])
        row.flat[0] = val
        e[k] = np.concatenate([e[k], row])
    V = 64
    args = [e[k] for k in ("eu", "ev", "es", "ea", "evalid", "src", "dest")]
    want = np.asarray(jsp_batch32(*args, V=V, n_sweeps=n_sweeps))
    got = relax32.sp_batch32(*_t(*args), V=V, n_sweeps=n_sweeps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[-1, 0, 3] == INF32) and (want[-1, 0, 1] == INF32)


@pytest.mark.parametrize("n_sweeps", [2, 30])
def test_solve_graph_batch_matches_jax(n_sweeps):
    """The int64 relaxation (PyTorch ops) bit-equals the JAX
    ``solve_graph_batch``, every output and dtype."""
    pgs = [jpg for jpg, _tpg in _graphs(DATA / "synth_small.paf")]
    e = _pad_edges(pgs, 1 << (max(len(pg.eu) for pg in pgs) + 4).bit_length(),
                   es_dtype=np.int64)
    keys = ("eu", "ev", "es", "ea", "enz", "etot", "erank", "evalid", "src",
            "dest")
    want = jsolve_graph_batch(*[e[k] for k in keys], V=64, n_sweeps=n_sweeps)
    got = relax.solve_graph_batch(*_t(*[e[k] for k in keys]), V=64,
                                  n_sweeps=n_sweeps)
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


def _dense_sp_inputs(V, max_n):
    graphs = _graphs(DATA / "synth_small.paf", max_v=V, max_n=max_n)
    mats_j, mats_t, dests = [], [], []
    for jpg, tpg in graphs:
        mj, mt = jpr.pack_dense(jpg, V), dense_sp.pack_dense(tpg, V)
        assert (mj is None) == (mt is None)
        if mj is None:
            continue
        for a, b in zip(mj, mt):
            np.testing.assert_array_equal(a, b)
        mats_j.append(mj)
        dests.append(np.full((1, V), jpg.g.dest, np.int32))
    arrs = [np.stack([m[i] for m in mats_j]) for i in range(5)]
    n_sweeps = max(jpg.g.n for jpg, _ in graphs) + 2
    return arrs, np.stack(dests), n_sweeps


@pytest.mark.parametrize("V,max_n,interpret", [(32, 6, True), (64, 24, False)])
def test_dense_sp_matches_pallas_and_xla(V, max_n, interpret):
    """The dense shortest-path fixed point's plain version bit-equals
    ``dense_sp_pallas`` in interpret mode (V 32) and ``dense_sp_xla``
    (V 64) on synth_small graphs, the f32 mapq key included; the port's
    ``pack_dense`` equals the JAX one."""
    arrs, dest, n_sweeps = _dense_sp_inputs(V, max_n)
    if interpret:
        arrs, dest = [a[:2] for a in arrs], dest[:2]
        want = jpr.dense_sp_pallas(*arrs, dest, n_sweeps=n_sweeps,
                                   interpret=True)
    else:
        want = jpr.dense_sp_xla(*arrs, dest, n_sweeps=n_sweeps)
    got = dense_sp.dense_sp(*_t(*arrs, dest), n_sweeps)
    for k in dense_sp.DSP_ROWS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


def test_pack_dense_bucket_matches_jax():
    pairs = _graphs(DATA / "synth_small.paf")
    want = jdense.pack_dense_bucket([(i, j) for i, (j, _t) in enumerate(pairs)],
                                    64)
    got = dense.pack_dense_bucket([(i, t) for i, (_j, t) in enumerate(pairs)],
                                  64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _texts(dataset, results):
    texts = []
    for outs, counts in zip(results, (False, False, True)):
        fh = io.StringIO()
        write_outputs(dataset, outs, fh, name_suffix_counts=counts)
        texts.append(fh.getvalue())
    return texts


def _python_plane_vs_jax(paf, batch_size=256):
    """solve_dataset_torch(dataset, cfg, device="cpu") against
    solve_dataset_tpu(dataset, cfg) on ``paf``: equal results (as the
    written files) and equal counts.  Returns the port's stats."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    jcfg = dataclasses.replace(JCFG, device_routing="always")
    ds = read_paf(paf)
    got = solve_dataset_torch(ds, cfg, device="cpu", batch_size=batch_size)
    stats = solve_dataset_torch.last_stats
    jds = jread_paf(paf)
    want = solve_dataset_tpu(jds, jcfg, batch_size=batch_size)
    jstats = solve_dataset_tpu.last_stats
    assert repr(got) == repr(want)  # dataclass reprs name no module
    assert _texts(ds, got) == _texts(ds, want)
    for key in ("device", "fallback", "singleton", "oversize", "dense_buckets",
                "int32_buckets", "fallback_reasons", "host_plane"):
        assert stats[key] == jstats[key], (key, stats, jstats)
    assert stats["jacobi"] == 0  # the plain versions take no branch
    return stats


@pytest.mark.parametrize("name", ["synth50", "synth_hard"])
def test_python_plane_matches_jax_and_goldens(name):
    stats = _python_plane_vs_jax(DATA / f"{name}.paf")
    assert stats["device"] > 0 and stats["dense_buckets"] >= 1
    ds = read_paf(DATA / f"{name}.paf")
    got = solve_dataset_torch(ds, DEFAULT_CONFIG, device="cpu")
    assert _texts(ds, got) == [(DATA / f"{name}.aln{s}.paf").read_text()
                               for s in SUFFIXES]


def test_python_plane_dense_and_int32_buckets(tmp_path):
    """Long contigs in buckets of 8: dense buckets up to V = 256 and int32
    sparse buckets at V = 512, with fallbacks and a singleton."""
    paf = tmp_path / "long.paf"
    paf.write_text(synth.generate_paf(n_contigs=30, seed=9,
                                      max_records_per_contig=180))
    stats = _python_plane_vs_jax(paf, batch_size=8)
    assert stats["dense_buckets"] >= 1 and stats["int32_buckets"] >= 1, stats


def test_python_plane_int64_bucket(monkeypatch):
    """A bucket that fails fits32 goes to the int64 relaxation, in both
    packages; results and counts stay equal."""
    monkeypatch.setattr(scheduler, "_fits32", lambda pg: False)
    ds = read_paf(DATA / "synth_hard.paf")
    got = solve_dataset_torch(ds, DEFAULT_CONFIG, device="cpu")
    assert solve_dataset_torch.last_stats["int32_buckets"] == 0
    assert solve_dataset_torch.last_stats["dense_buckets"] == 0
    assert _texts(ds, got) == [(DATA / f"synth_hard.aln{s}.paf").read_text()
                               for s in SUFFIXES]


def test_python_plane_needs_a_dataset():
    with pytest.raises(ValueError, match="dataset or src_paths"):
        solve_dataset_torch(None, DEFAULT_CONFIG, device="cpu")


def test_python_plane_rejects_several_devices(monkeypatch):
    """Several devices are no longer rejected: the JAX plane's
    multi-device branches are ported (tests/test_torch_mesh.py holds them
    to JAX).  On a mesh of two entries the data mesh and the graph-sharded
    solve run where a NotImplementedError used to stop them, and the
    results equal the one-device run's."""
    ds = read_paf(DATA / "synth_small.paf")
    one = solve_dataset_torch(ds, DEFAULT_CONFIG, device="cpu")
    assert solve_dataset_torch(ds, DEFAULT_CONFIG,
                               device=("cpu", "cpu")) == one
    assert solve_dataset_torch.last_stats["data_mesh_devices"] == 2
    cfg = dataclasses.replace(DEFAULT_CONFIG, max_device_records=2,
                              graph_shard_min_records=3)
    got = solve_dataset_torch(ds, cfg, device=("cpu", "cpu"))
    assert solve_dataset_torch.last_stats["graph_sharded"] >= 1
    assert got == solve_dataset_torch(ds, cfg, device="cpu")


def _boom(*a, **k):
    raise native.NativeError("simulated native failure")


def test_native_error_degrades_to_python_plane(monkeypatch):
    """A NativeError of the native plane degrades to the Python plane
    when a dataset was given: a RuntimeWarning, the reason in the stats,
    results equal to the goldens; without a dataset it raises."""
    paf = DATA / "synth50.paf"
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    monkeypatch.setattr(native, "GraphExporter", _boom)
    ds = read_paf(paf)
    with pytest.warns(RuntimeWarning, match="native host plane unavailable"):
        got = solve_dataset_torch(ds, cfg, src_paths=(str(paf), None),
                                  device="cpu")
    stats = solve_dataset_torch.last_stats
    assert stats["host_plane"] == "python" and stats["device"] > 0
    assert "simulated native failure" in stats["native_error"]
    assert _texts(ds, got) == [(DATA / f"synth50.aln{s}.paf").read_text()
                               for s in SUFFIXES]
    with pytest.raises(native.NativeError):
        solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                            device="cpu")


@pytest.mark.parametrize("name", ["synth50", "synth_hard"])
def test_cli_degrade_writes_goldens(tmp_path, monkeypatch, capsys, name):
    """The port's CLI, with the native plane failing, reads the PAF and
    runs the Python plane, writing the goldens (as alignasm_tpu.cli)."""
    paf = tmp_path / f"{name}.paf"
    paf.write_bytes((DATA / f"{name}.paf").read_bytes())
    # the cuda engine's "auto" routing reaches the native plane through
    # the exporter or, when its cost model predicts no win, native.run
    monkeypatch.setattr(native, "GraphExporter", _boom)
    monkeypatch.setattr(native, "run", _boom)
    assert cli.run([str(paf)], device="cpu") == 0
    assert "degrading to the Python plane" in capsys.readouterr().err
    for s in SUFFIXES:
        assert (tmp_path / f"{name}.aln{s}.paf").read_bytes() == \
            (DATA / f"{name}.aln{s}.paf").read_bytes(), s


@pytest.mark.parametrize("name", ["synth50", "synth_hard"])
def test_native_copy_matches_jax_native_and_goldens(tmp_path, name):
    """The port's copy of the C++ host plane (its own library, loaded
    RTLD_LOCAL beside the JAX package's in this process) writes the same
    bytes as alignasm_tpu.native.run and the goldens."""
    paf = DATA / f"{name}.paf"
    native.run(str(paf), out_prefix=str(tmp_path / "port"),
               config=DEFAULT_CONFIG)
    jnative.run(str(paf), out_prefix=str(tmp_path / "jax"), config=JCFG)
    for s in SUFFIXES:
        got = (tmp_path / f"port.aln{s}.paf").read_bytes()
        assert got == (tmp_path / f"jax.aln{s}.paf").read_bytes(), s
        assert got == (DATA / f"{name}.aln{s}.paf").read_bytes(), s
    assert native.library_path().parent.name == "build"


# The port's edits to the copied C++ sources, (old, new) in order, each old
# found once in the text it is applied to: the host plane's counter table
# (solver.h's TraceSlot, switched and read through aln_trace /
# aln_trace_read) grown from the solve_prof table in place of the four
# environment-switched stderr printers (ALN_SOLVE_PROF, ALN_BUILD_PROF,
# ALN_READ_PROF, ALN_SHARD_PROF) and the clock reads they took whether
# on or off; ALN_DEBUG_WALKS read once a process.
NATIVE_SOURCE_EDITS = {
    "api.cc": (
        ('                aln::SolveProfScope ps(7);\n',
         '                aln::TraceScope ps(aln::kFormat);\n'),
        (r"""        if (aln::solve_prof_on()) {
            for (int k = 0; k < 8; k++)
                fprintf(stderr, "solve_prof %s %.1f ms\n",
                        aln::solve_prof_names[k],
                        aln::solve_prof_ns[k].exchange(0) / 1e6);
        }
""",
         ""),
        (r"""        auto prof_t0 = std::chrono::steady_clock::now();
        auto prof = [&](const char *tag) {
            if (!getenv("ALN_SHARD_PROF")) return;
            auto now = std::chrono::steady_clock::now();
            fprintf(stderr, "run_shard r%lld %s %.2f ms\n", rank, tag,
                    std::chrono::duration<double, std::milli>(
                        now - prof_t0).count());
            prof_t0 = now;
        };
""",
         ""),
        ('        prof("parse_solve");\n',
         ""),
        ('        prof("solve_tail");\n',
         ""),
        ('            prof("direct_flush");\n',
         ""),
        ('            prof("publish");\n',
         ""),
    ),
    "export.cc": (
        ("""    const auto &r = ctx.results[i];
    ctx.pout[i].clear();
""",
         """    aln::TraceScope ts(aln::kFormat);
    const auto &r = ctx.results[i];
    ctx.pout[i].clear();
"""),
        ("""}

void compute_ranks(PackedContig &pc) {
""",
         """    aln::trace_flush();  // this thread's share, when it ran the worker
}

void compute_ranks(PackedContig &pc) {
"""),
        ("""            try {
                pc.graph = aln::build_graph(contig, c->cfg);
""",
         """            aln::TraceScope ts(aln::kBuild);
            try {
                pc.graph = aln::build_graph(contig, c->cfg);
"""),
        ("""            static thread_local std::vector<int32_t> inv;
            inv.assign((size_t) V, -1);
            for (long long v = 0; v < nv; v++) inv[pos(v)] = (int32_t) v;
            static thread_local std::vector<aln::i32> verts;
            verts.clear();
            const long long dpos = pos(pc.graph.dest);
            long long cur = pos(src);
            for (long long k = 0; k < V; k++) {
                if (cur < 0 || cur >= V || inv[cur] < 0)
                    throw std::runtime_error("device nxt entry out of range");
                verts.push_back(inv[cur]);
                if (cur == dpos) break;
                long long nx = row[cur];
                if (nx <= cur)  // achieving successors strictly increase
                    throw std::runtime_error("device nxt chain not increasing");
                cur = nx;
            }
            if (verts.front() != src || verts.back() != pc.graph.dest)
                throw std::runtime_error("device path endpoints mismatch");
            ctx.results[i] = aln::finish_from_path(pc.graph, verts.data(),
                                                   (int) verts.size(), cfg);
            fast.fetch_add(1);
        } else {
            ctx.results[i] = aln::solve_from_graph(pc.graph, cfg);
            fb.fetch_add(1);
        }
        format_result(ctx, i);
        ctx.done[i] = 1;
    }, werr);
    *n_fast = fast.load();
    *n_fallback = fb.load();
    if (!werr.empty()) {
        set_err(err, errlen, werr);
        return 1;
    }
    return 0;
}

extern "C" {
""",
         """            aln::TraceScope ts(aln::kFast);
            static thread_local std::vector<int32_t> inv;
            inv.assign((size_t) V, -1);
            for (long long v = 0; v < nv; v++) inv[pos(v)] = (int32_t) v;
            static thread_local std::vector<aln::i32> verts;
            verts.clear();
            const long long dpos = pos(pc.graph.dest);
            long long cur = pos(src);
            for (long long k = 0; k < V; k++) {
                if (cur < 0 || cur >= V || inv[cur] < 0)
                    throw std::runtime_error("device nxt entry out of range");
                verts.push_back(inv[cur]);
                if (cur == dpos) break;
                long long nx = row[cur];
                if (nx <= cur)  // achieving successors strictly increase
                    throw std::runtime_error("device nxt chain not increasing");
                cur = nx;
            }
            if (verts.front() != src || verts.back() != pc.graph.dest)
                throw std::runtime_error("device path endpoints mismatch");
            ctx.results[i] = aln::finish_from_path(pc.graph, verts.data(),
                                                   (int) verts.size(), cfg);
            fast.fetch_add(1);
        } else {
            ctx.results[i] = aln::solve_from_graph(pc.graph, cfg);
            fb.fetch_add(1);
        }
        format_result(ctx, i);
        ctx.done[i] = 1;
    }, werr);
    *n_fast = fast.load();
    *n_fallback = fb.load();
    if (!werr.empty()) {
        set_err(err, errlen, werr);
        return 1;
    }
    return 0;
}

extern "C" {
"""),
        ("""            ctx.results[i] = aln::solve_from_graph(pc.graph, cfg);
            fb.fetch_add(1);
        }
        format_result(ctx, i);
        ctx.done[i] = 1;
    }, werr);
    *n_fast = fast.load();
    *n_fallback = fb.load();
    if (!werr.empty()) {
        set_err(err, errlen, werr);
        return 1;
    }
    return 0;
}

extern "C" {
""",
         """            aln::TraceScope ts(aln::kFallback);
            ctx.results[i] = aln::solve_from_graph(pc.graph, cfg);
            fb.fetch_add(1);
        }
        format_result(ctx, i);
        ctx.done[i] = 1;
    }, werr);
    *n_fast = fast.load();
    *n_fallback = fb.load();
    if (!werr.empty()) {
        set_err(err, errlen, werr);
        return 1;
    }
    return 0;
}

extern "C" {
"""),
        ("""        if (ctx.packed[i].built)
            ctx.results[i] = aln::solve_from_graph(ctx.packed[i].graph, cfg);
        else
            ctx.results[i] = aln::solve_contig(ctx.ds.contigs[i], cfg);
        format_result(ctx, i);
""",
         """        {
            aln::TraceScope ts(aln::kSolve);
            if (ctx.packed[i].built)
                ctx.results[i] = aln::solve_from_graph(ctx.packed[i].graph, cfg);
            else
                ctx.results[i] = aln::solve_contig(ctx.ds.contigs[i], cfg);
        }
        format_result(ctx, i);
"""),
        ("""        if (ctx.packed[i].built)
            ctx.results[i] = aln::solve_from_graph(ctx.packed[i].graph, cfg);
        else
            ctx.results[i] = aln::solve_contig(ctx.ds.contigs[i], cfg);
""",
         """        {
            aln::TraceScope ts(aln::kSolve);
            if (ctx.packed[i].built)
                ctx.results[i] = aln::solve_from_graph(ctx.packed[i].graph, cfg);
            else
                ctx.results[i] = aln::solve_contig(ctx.ds.contigs[i], cfg);
        }
"""),
        ("""}

int aln_prepare_results(void *h) {
""",
         """}

// the counter table (solver.h): on != 0 switches it on, 0 off
void aln_trace(int on) { aln::trace_flag.store(on != 0); }

// the table's sums since the last read, slot by slot, into ns[] and n[]
// (aln_trace_slots() entries each); resets it
void aln_trace_read(long long *ns, long long *n) { aln::trace_take(ns, n); }

int aln_trace_slots(void) { return aln::kTraceSlots; }

const char *aln_trace_name(int slot) {
    return slot >= 0 && slot < aln::kTraceSlots ? aln::trace_names[slot]
                                                : nullptr;
}

int aln_prepare_results(void *h) {
"""),
    ),
    "io.cc": (
        (r"""    auto prof_t0 = std::chrono::steady_clock::now();
    auto prof = [&](const char *tag) {
        if (!getenv("ALN_READ_PROF")) return;
        auto now = std::chrono::steady_clock::now();
        fprintf(stderr, "read_paf %s %.2f ms\n", tag,
                std::chrono::duration<double, std::milli>(now - prof_t0).count());
        prof_t0 = now;
    };
""",
         ""),
        ('    prof("slurp");\n',
         ""),
        ('    prof("pass0_scan");\n',
         ""),
        ("""
    prof("pass1_intern_concat");
""",
         ""),
        ("""    }
    // sharded parse: only groups owned by this rank get their records
""",
         """        if (trace_on()) trace_count(kScan, (long long) (sink->scan_s * 1e9));
    }
    // sharded parse: only groups owned by this rank get their records
"""),
        ('        SolveProfScope ps(6);\n',
         '        TraceScope ps(kParse);\n'),
        ('    prof("pass23_parse_group");\n',
         ""),
        ('    static const char *sfx[] = {".aln.paf", ".aln.alt.paf", ".aln.all.paf"};\n',
         """    TraceScope ts(kFlush);
    static const char *sfx[] = {".aln.paf", ".aln.alt.paf", ".aln.all.paf"};
"""),
        ('    std::lock_guard<std::mutex> lk(td_mu());\n',
         """    // timed when the table is on at the call, so that a caller that
    // switches it off right after still counts its teardown
    bool timed = trace_on();
    std::lock_guard<std::mutex> lk(td_mu());
"""),
        ('    td_reg().emplace_back(std::move(fn));\n',
         """    td_reg().emplace_back([fn = std::move(fn), timed] {
        long long t0 = timed ? trace_clock_ns() : 0;
        fn();
        if (timed) trace_count(kTeardown, trace_clock_ns() - t0);
    });
"""),
    ),
    "solver.cc": (
        (r"""// env-gated build sub-phase attribution (ALN_BUILD_PROF): prints the
// sort / cut-vertex / edge split of one build — deterministic
// wall-clock scopes, same rationale as ALN_SOLVE_PROF (this
// hypervisor starves sampling profilers)
static void build_prof(const char *what, std::chrono::steady_clock::time_point t0) {
    static int on = -1;
    if (on < 0) on = getenv("ALN_BUILD_PROF") != nullptr;
    if (!on) return;
    fprintf(stderr, "build_prof %s %.1f ms\n", what,
            std::chrono::duration<double>(
                std::chrono::steady_clock::now() - t0).count() * 1e3);
""",
         """// ALN_DEBUG_WALKS=1 prints each solve's walks to stderr; read once a
// process
static bool debug_walks() {
    static const bool on = std::getenv("ALN_DEBUG_WALKS") != nullptr;
    return on;
"""),
        ('    auto bt0 = std::chrono::steady_clock::now();\n',
         ""),
        ("""    build_prof("sort", bt0);
    bt0 = std::chrono::steady_clock::now();
""",
         ""),
        ("""    build_prof("record_vertices", bt0);
    bt0 = std::chrono::steady_clock::now();
""",
         ""),
        ("""    build_prof("cut_vertices", bt0);
    bt0 = std::chrono::steady_clock::now();
""",
         ""),
        ('    build_prof("edges", bt0);\n',
         ""),
        ('        auto wpt = std::chrono::steady_clock::now();\n',
         ""),
        ("""        build_prof("wp_csr", wpt);
        wpt = std::chrono::steady_clock::now();
""",
         ""),
        ("""        build_prof("wp_kahn", wpt);
        wpt = std::chrono::steady_clock::now();
""",
         ""),
        ('        build_prof("wp_dp", wpt);\n',
         ""),
        ('    auto trt = std::chrono::steady_clock::now();\n',
         ""),
        ("""    build_prof("tr_not_alt", trt);
    trt = std::chrono::steady_clock::now();
""",
         ""),
        ("""    build_prof("tr_upgrade", trt);
    trt = std::chrono::steady_clock::now();
    if (std::getenv("ALN_DEBUG_WALKS")) {
""",
         '    if (debug_walks()) {\n'),
        ("""    build_prof("tr_rows", trt);
    trt = std::chrono::steady_clock::now();
""",
         ""),
        ('    build_prof("tr_alt_flag", trt);\n',
         ""),
        ("""// env-gated solve sub-phase attribution (ALN_SOLVE_PROF): global
// relaxed-atomic nanosecond counters, printed by aln_run_stats2.
// Zero cost when disabled (one cached getenv per thread).
std::atomic<long long> solve_prof_ns[8];
const char *const solve_prof_names[8] = {
    "build", "topo+floor", "walk_dp", "fast_rows", "lazy_enum", "select",
    "parse_records", "format"};
bool solve_prof_on() {
    static thread_local int e = -1;
    if (e < 0) e = getenv("ALN_SOLVE_PROF") != nullptr;
    return e == 1;
}
""",
         """const char *const trace_names[kTraceSlots] = {
    "solve_build", "topo", "walk_dp", "fast_rows", "lazy_enum", "select",
    "parse", "format", "scan", "build", "fast", "fallback", "flush", "solve",
    "teardown"};
std::atomic<bool> trace_flag{false};
"""),
        ("""struct ProfScope {
    int slot;
    bool on;
    std::chrono::steady_clock::time_point t0;
    explicit ProfScope(int s)
        : slot(s), on(solve_prof_on()),
          t0(on ? std::chrono::steady_clock::now()
                : std::chrono::steady_clock::time_point{}) {}
    ~ProfScope() {
        if (on)
            solve_prof_ns[slot].fetch_add(
                std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count(),
                std::memory_order_relaxed);
""",
         """std::atomic<long long> trace_ns[kTraceSlots], trace_n[kTraceSlots];
// one thread's sums; a worker thread's reach the table when it ends
struct TraceLocal {
    long long ns[kTraceSlots] = {}, n[kTraceSlots] = {};
    bool any = false;
    ~TraceLocal() { flush(); }
    void flush() {
        if (!any) return;
        for (int k = 0; k < kTraceSlots; k++) {
            if (!n[k]) continue;
            trace_ns[k].fetch_add(ns[k], std::memory_order_relaxed);
            trace_n[k].fetch_add(n[k], std::memory_order_relaxed);
            ns[k] = n[k] = 0;
        }
        any = false;
"""),
        ("""}  // namespace

ContigResult solve_contig(std::vector<Record> &records, const Config &cfg) {
""",
         """thread_local TraceLocal trace_local;
}  // namespace

ContigResult solve_contig(std::vector<Record> &records, const Config &cfg) {
"""),
        ("""
ContigResult solve_contig(std::vector<Record> &records, const Config &cfg) {
""",
         """void trace_add(int slot, long long ns) {
    trace_local.ns[slot] += ns;
    trace_local.n[slot]++;
    trace_local.any = true;
}
void trace_count(int slot, long long ns) {
    trace_ns[slot].fetch_add(ns, std::memory_order_relaxed);
    trace_n[slot].fetch_add(1, std::memory_order_relaxed);
}
void trace_flush() { trace_local.flush(); }
void trace_take(long long *ns, long long *n) {
    trace_flush();
    for (int k = 0; k < kTraceSlots; k++) {
        ns[k] = trace_ns[k].exchange(0, std::memory_order_relaxed);
        n[k] = trace_n[k].exchange(0, std::memory_order_relaxed);
    }
}

ContigResult solve_contig(std::vector<Record> &records, const Config &cfg) {
"""),
        ('        ProfScope ps(0);\n',
         '        TraceScope ps(kSolveBuild);\n'),
        ('        ProfScope ps(1);\n',
         '        TraceScope ps(kTopo);\n'),
        ('        ProfScope ps(2);\n',
         '        TraceScope ps(kWalkDp);\n'),
        ("""        ProfScope ps(3);
        auto fpt = std::chrono::steady_clock::now();
""",
         '        TraceScope ps(kFastRows);\n'),
        ("""        build_prof("fp_reset", fpt);
        fpt = std::chrono::steady_clock::now();
""",
         ""),
        ("""        build_prof("fp_recover", fpt);
        fpt = std::chrono::steady_clock::now();
""",
         ""),
        ('        build_prof("fp_to_rows", fpt);\n',
         ""),
        ('        ProfScope ps(4);\n',
         '        TraceScope ps(kLazyEnum);\n'),
        ('    ProfScope ps_sel(5);\n',
         '    TraceScope ps_sel(kSelect);\n'),
        ('    if (std::getenv("ALN_DEBUG_WALKS")) {\n',
         '    if (debug_walks()) {\n'),
    ),
    "solver.h": (
        ("""// env-gated solve sub-phase attribution (ALN_SOLVE_PROF=1): global
// nanosecond counters accumulated by solve_contig/solve_from_graph,
// printed + reset by aln_run_stats2
""",
         """// The host plane's counter table: per slot, the nanoseconds summed over
// every timed scope and the number of scopes.  aln_trace switches it on
// and off, aln_trace_read reads and resets it (export.cc).  While it is
// off a scope reads no clock and adds nothing.  A scope adds to its
// thread's own sums; trace_flush moves them into the shared table, which
// each worker thread does once, when it ends, and run_pool and
// aln_trace_read do for the calling thread.  The serial scan and a
// teardown, once a call each, add to the table directly.
"""),
        ("""extern std::atomic<long long> solve_prof_ns[8];
extern const char *const solve_prof_names[8];
bool solve_prof_on();
// RAII accumulator for one slot (no-op when ALN_SOLVE_PROF unset)
struct SolveProfScope {
""",
         """enum TraceSlot {
    // sub-slots of a solve (solve_contig / solve_from_graph, wherever it
    // runs): graph build, topo order and anomaly floor, walk DP, the
    // unique-walk rows, lazy enumeration, selection
    kSolveBuild, kTopo, kWalkDp, kFastRows, kLazyEnum, kSelect,
    kParse,     // record and cs parse (parse workers)
    kFormat,    // one contig's output rows formatted
    kScan,      // read_paf's serial scan, wall time
    kBuild,     // the exporter's graph build with ranks (parse workers)
    kFast,      // a device-gated contig: path chase and rows
    kFallback,  // a contig the device gated out, solved on the host
    kFlush,     // flush_three, wall time
    kSolve,     // the exporter's host solve of one contig
    kTeardown,  // one background teardown, wall time, counted at its end
    kTraceSlots
};
extern const char *const trace_names[kTraceSlots];
extern std::atomic<bool> trace_flag;
inline bool trace_on() { return trace_flag.load(std::memory_order_relaxed); }
inline long long trace_clock_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}
void trace_add(int slot, long long ns);    // to this thread's sums
void trace_count(int slot, long long ns);  // to the table
void trace_flush();                        // this thread's sums to the table
// flushes this thread, then reads the table into ns[], n[] and resets it
void trace_take(long long *ns, long long *n);
// one timed scope of ``slot``, added to this thread's sums
struct TraceScope {
"""),
        ("""    bool on;
    std::chrono::steady_clock::time_point t0;
    explicit SolveProfScope(int s)
        : slot(s), on(solve_prof_on()),
          t0(on ? std::chrono::steady_clock::now()
                : std::chrono::steady_clock::time_point{}) {}
    ~SolveProfScope() {
        if (on)
            solve_prof_ns[slot].fetch_add(
                std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count(),
                std::memory_order_relaxed);
""",
         """    long long t0;
    explicit TraceScope(int s)
        : slot(trace_on() ? s : -1), t0(slot < 0 ? 0 : trace_clock_ns()) {}
    ~TraceScope() {
        if (slot >= 0) trace_add(slot, trace_clock_ns() - t0);
"""),
    ),
}


def test_native_copy_sources_match():
    """The copied C++ sources are the JAX package's, byte for byte, apart
    from the edits listed in NATIVE_SOURCE_EDITS."""
    jsrc = REPO / "alignasm_tpu" / "native" / "src"
    tsrc = REPO / "alignasm_tpu_torch" / "native" / "src"
    names = sorted(p.name for p in jsrc.iterdir() if p.suffix in (".cc", ".h"))
    assert names == sorted(p.name for p in tsrc.iterdir())
    assert set(NATIVE_SOURCE_EDITS) <= set(names)
    for n in names:
        text = (jsrc / n).read_bytes().decode()
        for old, new in NATIVE_SOURCE_EDITS.get(n, ()):
            assert text.count(old) == 1, (n, old)
            text = text.replace(old, new)
        assert (tsrc / n).read_bytes().decode() == text, n


# The port's copies of the JAX package's JAX-free Python modules: each is
# the original with "alignasm_tpu." read as "alignasm_tpu_torch.", apart
# from the additions and edits listed below.
COPIES = (
    "config.py", "engine/__init__.py", "engine/device.py", "engine/dial.py",
    "engine/exact.py", "engine/graph.py", "engine/introsort.py",
    "engine/kshortest.py", "engine/pqvec.py", "engine/singlepiece.py",
    "io/__init__.py", "io/cs.py", "io/paf.py", "model/__init__.py",
    "model/distance.py", "model/records.py", "testing/__init__.py",
    "testing/realism_stats.py",
)
# native/__init__.py: the library builds into alignasm_tpu_torch/build/
# under a hash of its sources and flags instead of next to the sources,
# and binds the counter table of NATIVE_SOURCE_EDITS.
NATIVE_EDITS = (
    ("""The shared library compiles on first use (g++ -O2, ~seconds) and is
cached next to the sources; rebuilds when any source is newer.
""", """The port's own copy of ``alignasm_tpu/native`` (sources and bindings),
so the port imports nothing of the JAX package.  The shared library
compiles on first use (g++ -O3, ~seconds) into ``alignasm_tpu_torch/build/``,
named by a hash of the sources and flags, so a changed source builds
anew; it is never built next to the sources.  It is loaded with the
default ``RTLD_LOCAL``, so it shares no symbols with the JAX package's
library in the same process.
"""),
    ("import ctypes\n", "import ctypes\nimport hashlib\n"),
    ('_LIB = _DIR / "libalignasm.so"\n', '_BUILD = _DIR.parent / "build"\n'),
    ('"heap.cc"]\n', '"heap.cc"]\n_FLAGS = ["-std=c++20", "-O3", "-g", '
                     '"-fPIC", "-shared"]\n'),
    ("""def _needs_build() -> bool:
    if not _LIB.exists():
        return True
    lib_m = _LIB.stat().st_mtime
    return any((_SRC / s).stat().st_mtime > lib_m for s in _SOURCES) or any(
        p.stat().st_mtime > lib_m for p in _SRC.glob("*.h")
    )
""", """def library_path() -> pathlib.Path:
    \"\"\"The library's path: a hash of the sources, headers and flags.\"\"\"
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in [_SRC / s for s in _SOURCES] + sorted(_SRC.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / f"libalignasm_{h.hexdigest()[:16]}.so"
"""),
    ("""        if force or _needs_build():
""", """        lib_path = library_path()
        if force or not lib_path.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
"""),
    ("(multihost ranks,", "(test workers,"),
    ("""            # process) either dlopens the complete old library or the
            # complete new one, never a half-written file
            tmp = _LIB.with_suffix(f".so.tmp.{os.getpid()}")
            base = ["g++", "-std=c++20", "-O3", "-g", "-fPIC", "-shared",
                    "-o", str(tmp)] + [str(_SRC / s) for s in _SOURCES] + ["-pthread"]
""", """            # process) either dlopens a complete library or builds its
            # own, never a half-written file
            tmp = lib_path.with_suffix(f".so.tmp.{os.getpid()}")
            base = ["g++", *_FLAGS, "-o", str(tmp)] \\
                + [str(_SRC / s) for s in _SOURCES] + ["-pthread"]
"""),
    ("os.replace(tmp, _LIB)", "os.replace(tmp, lib_path)"),
    ("    return _LIB\n", "    return lib_path\n"),
    ("""        build()
        lib = ctypes.CDLL(str(_LIB))
""", """        lib = ctypes.CDLL(str(build()))
"""),
    # the counter table's bindings: native.trace and native.trace_read
    ('        _lib = lib\n',
     """        lib.aln_trace.argtypes = [ctypes.c_int]
        lib.aln_trace.restype = None
        lib.aln_trace_slots.argtypes = []
        lib.aln_trace_slots.restype = ctypes.c_int
        lib.aln_trace_name.argtypes = [ctypes.c_int]
        lib.aln_trace_name.restype = ctypes.c_char_p
        lib.aln_trace_read.argtypes = [llp, llp]
        lib.aln_trace_read.restype = None
        _lib = lib
"""),
    ("""

class GraphExporter:
""",
     '''

def trace(on: bool) -> None:
    """Switch the host plane's counter table on or off (it starts off).
    While it is off the C++ plane reads no clock for it."""
    _ensure_lib().aln_trace(1 if on else 0)


def trace_read() -> dict:
    """The counter table since the last read, then reset: ``{slot:
    (seconds, count)}`` for every slot of ``src/solver.h``'s
    ``TraceSlot``, (0.0, 0) where a slot counted nothing.  Seconds are
    summed over threads, except the wall-time slots ``scan``, ``flush``
    and ``teardown``."""
    lib = _ensure_lib()
    k = lib.aln_trace_slots()
    ns = (ctypes.c_longlong * k)()
    n = (ctypes.c_longlong * k)()
    lib.aln_trace_read(ns, n)
    return {lib.aln_trace_name(i).decode(): (ns[i] / 1e9, n[i])
            for i in range(k)}


class GraphExporter:
'''),
)


def _prefixed(rel):
    """The JAX package's module ``rel`` with the port's import prefix."""
    text = (REPO / "alignasm_tpu" / rel).read_text()
    return text.replace("alignasm_tpu.", "alignasm_tpu_torch.")


def _copy(rel):
    return (REPO / "alignasm_tpu_torch" / rel).read_text()


def test_every_copied_module_is_held_to_its_original():
    port = REPO / "alignasm_tpu_torch"
    found = {str(p.relative_to(port)) for d in ("engine", "io", "model",
                                                "testing", "native")
             for p in (port / d).glob("*.py")} | {"config.py"}
    assert found == set(COPIES) | {"testing/synth.py", "native/__init__.py"}


@pytest.mark.parametrize("rel", COPIES)
def test_python_copy_matches_original_text(rel):
    """A copied module is its original, import prefixes apart."""
    assert _copy(rel) == _prefixed(rel)


def test_synth_copy_text_adds_only_chain_contig():
    """The generator's copy is the original plus ``_chain_contig``."""
    import ast

    orig, copy = _prefixed("testing/synth.py"), _copy("testing/synth.py")
    assert copy.startswith(orig)
    added = ast.parse(copy[len(orig):]).body
    assert [(type(n), n.name) for n in added] == [(ast.FunctionDef,
                                                   "_chain_contig")]


def test_native_bindings_copy_differs_only_in_its_build():
    """The native bindings' copy is the original with the listed edits to
    where and how the library is built and the counter table's bindings,
    and nothing else."""
    text = _prefixed("native/__init__.py")
    for old, new in NATIVE_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert _copy("native/__init__.py") == text


@pytest.mark.parametrize("seed", [1, 7, 9])
def test_synth_copy_matches(seed):
    """The port's copy of the synthetic corpus generator writes the same
    text as the JAX package's, and _chain_contig equals the test's."""
    import sys

    kw = dict(n_contigs=12, seed=seed, max_records_per_contig=60)
    assert synth.generate_paf(**kw) == jsynth.generate_paf(**kw)
    assert synth.config_karyotype(30) == jsynth.config_karyotype(30)
    sys.path.insert(0, str(REPO / "tests"))
    from test_scale import _chain_contig

    assert synth._chain_contig(40, seed=seed) == _chain_contig(40, seed=seed)


def test_config_copy_matches():
    assert dataclasses.asdict(DEFAULT_CONFIG) == dataclasses.asdict(JCFG)


def test_new_wrappers_take_only_cuda_tensors():
    from alignasm_tpu_torch.ops import cuda_dense_sp, cuda_relax32, cuda_sweep

    m = torch.full((2, 8, 8), INF32, dtype=torch.int32)
    d = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_sweep.sweep_dense_batch(m, m, d, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_sweep.sweep_dense_slabs(torch.zeros((2, 9, 8), dtype=torch.int32), 4)
    e = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_relax32.relax32(e, e, e, e, e.bool(), d, d, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_dense_sp.dense_sp(m, m, m, m, m, d.view(2, 1, 1).expand(2, 1, 8)
                               .contiguous(), 4)
    with pytest.raises(ValueError, match="CUDA tensor"):  # a branch count
        cuda_sweep.check_jacobi(torch.zeros(1, dtype=torch.int32))
    assert cuda_sweep.sweep_dense_batch.launches == 0
    assert cuda_relax32.relax32.launches == 0
    assert cuda_dense_sp.dense_sp.launches == 0


def test_python_plane_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="is_available"):
            solve_dataset_torch(read_paf(DATA / "synth_small.paf"),
                                DEFAULT_CONFIG)
