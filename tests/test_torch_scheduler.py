"""The port's end-to-end device path (alignasm_tpu_torch.runtime.scheduler)
on the CPU, native plane: output files byte-equal to the committed
goldens, to the native engine and to the JAX package's device engine,
with the scan (V <= 256) and the blocked solve (256 < V <= 16384);
``device_routing="never"``, the stats keys, the contig-count check and
the CLI's messages against the JAX package's; the degrade-to-native
contract; the guards of what the slice does not cover; and nothing of
JAX or the JAX package in the port's import graph.
"""

import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from alignasm_tpu import native
from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.testing.synth import generate_paf
from alignasm_tpu_torch import cli
from alignasm_tpu_torch import native as tnative
from alignasm_tpu_torch.runtime import scheduler
from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
CFG = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
SUFFIXES = ("", ".alt", ".all")
# Stats keys of the JAX engine that the port does not write: the data mesh
# is the JAX engine's over the 8 CPU devices that tests/conftest.py gives
# it.
JAX_ONLY = {"data_mesh_devices"}


def _outputs(prefix):
    return [Path(f"{prefix}.aln{s}.paf").read_bytes() for s in SUFFIXES]


def _port(paf, prefix, cfg=CFG):
    solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                        write_prefix=str(prefix), device="cpu")
    return _outputs(prefix), solve_dataset_torch.last_stats


def _native(paf, prefix, cfg=CFG):
    native.run(str(paf), out_prefix=str(prefix), config=cfg)
    return _outputs(prefix)


@pytest.mark.parametrize("name", ["synth50", "synth_hard"])
def test_port_matches_goldens(tmp_path, name):
    got, stats = _port(DATA / f"{name}.paf", tmp_path / name)
    assert got == _outputs(DATA / name)
    assert stats["device"] > 0 and "device_error" not in stats, stats
    assert stats["wire16_buckets"] >= 1


def test_in_memory_results_match_exact_engine():
    """Without write_prefix the per-contig results come back in memory,
    equal to the Python exact engine's (the port's copy, and field for
    field the JAX package's)."""
    from alignasm_tpu.engine.exact import solve_dataset as jax_solve
    from alignasm_tpu.io.paf import read_paf as jax_read
    from alignasm_tpu_torch.config import DEFAULT_CONFIG as TCFG
    from alignasm_tpu_torch.engine.exact import solve_dataset
    from alignasm_tpu_torch.io.paf import read_paf

    paf = DATA / "synth_hard.paf"
    got = solve_dataset_torch(None, CFG, src_paths=(str(paf), None),
                              device="cpu")
    assert solve_dataset_torch.last_stats["device"] > 0
    assert got == solve_dataset(read_paf(paf), TCFG)
    # a dataclass repr names its fields, not its module
    assert repr(got) == repr(jax_solve(jax_read(paf), DEFAULT_CONFIG))


def test_cli_matches_goldens(tmp_path):
    paf = tmp_path / "synth_hard.paf"
    paf.write_bytes((DATA / "synth_hard.paf").read_bytes())
    assert cli.run([str(paf)], device="cpu") == 0
    assert _outputs(tmp_path / "synth_hard") == _outputs(DATA / "synth_hard")


@pytest.mark.parametrize("dense_cells,merge_cells", [
    (2**26, 0), (64 * 64 * 4, 0), (2**26, 2**23), (64 * 64 * 4, 2**23),
])
def test_dense_buckets_partition_by_pow2_v(dense_cells, merge_cells):
    """Every contig lands in exactly one bucket of a power-of-two V (at
    least 8) that holds it, in ascending V, and no bucket exceeds the
    cell cap unless one contig alone does.  Without merging, V is the
    smallest such power of two."""
    rng = np.random.default_rng(3)
    n_v = rng.integers(1, 257, 500)
    order = np.argsort(n_v, kind="stable")
    buckets = scheduler._dense_buckets(order, n_v, dense_cells=dense_cells,
                                       merge_cells=merge_cells)
    seen = np.concatenate([idxs for _V, idxs in buckets])
    assert sorted(seen.tolist()) == list(range(500))
    for V, idxs in buckets:
        assert V >= 8 and V & (V - 1) == 0
        assert (n_v[idxs] <= V).all()
        assert merge_cells or V == 8 or (n_v[idxs] > V // 2).all()
        assert len(idxs) * V * V <= max(dense_cells, V * V)
    vs = [V for V, _ in buckets]
    assert vs == sorted(vs)


def test_dense_buckets_merge_small_groups_up():
    """A group whose padding up to the next V stays under merge_cells
    joins that V's bucket; a larger one keeps its own."""
    n_v = np.array([5] * 10 + [12] * 1000 + [30] * 1000)
    order = np.arange(len(n_v))
    vs = [V for V, _ in scheduler._dense_buckets(order, n_v,
                                                 merge_cells=10_000)]
    assert vs == [16, 32]  # 10 * (256 - 64) cells merge; 1010 * 768 do not
    vs = [V for V, _ in scheduler._dense_buckets(order, n_v, merge_cells=0)]
    assert vs == [8, 16, 32]


def _matches_native_and_jax_engine(tmp_path, paf, cfg):
    """The port's files byte-equal to native.run's and to the JAX device
    engine's with the same config, and its device/fallback/native_direct
    counts equal the JAX engine's.  Returns the port's stats."""
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    got, stats = _port(paf, tmp_path / "port", cfg)
    assert got == _native(paf, tmp_path / "native", cfg)
    assert stats["device"] > 0 and "device_error" not in stats, stats
    solve_dataset_tpu(None, cfg, src_paths=(str(paf), None),
                      write_prefix=str(tmp_path / "jax"))
    assert got == _outputs(tmp_path / "jax")
    jstats = solve_dataset_tpu.last_stats
    for key in ("device", "fallback", "native_direct", "device_routed_frac"):
        assert stats[key] == jstats[key], (key, stats, jstats)
    assert set(jstats) - JAX_ONLY <= set(stats), set(jstats) - set(stats)
    return stats


@pytest.mark.parametrize("device_max_v", [256, 8192])
def test_long_contigs_match_native_and_jax_engine(tmp_path, device_max_v):
    """60 long contigs: at device_max_v=256 a V = 256 bucket on the ragged
    wire, contigs over 256 vertices solved natively; at the default 8192
    all in one V = 512 blocked bucket (the merge pads the others up)."""
    paf = tmp_path / "long.paf"
    paf.write_text(generate_paf(n_contigs=60, seed=9,
                                max_records_per_contig=180))
    cfg = dataclasses.replace(CFG, device_max_v=device_max_v)
    stats = _matches_native_and_jax_engine(tmp_path, paf, cfg)
    if device_max_v == 256:
        assert 256 in stats["bucket_vs"] and stats["native_direct"] > 0, stats
    else:
        assert 512 in stats["bucket_vs"] and stats["native_direct"] == 0, stats


def _chain_corpus(*specs):
    """Chain contigs of tests/test_scale.py, one per (segments, seed)."""
    sys.path.insert(0, str(Path(__file__).parent))
    from test_scale import _chain_contig

    return "".join(_chain_contig(n, seed=s).replace("bigctg", f"bigctg{k}")
                   for k, (n, s) in enumerate(specs))


def test_chain_contigs_match_native_and_jax_engine(tmp_path):
    """Two chain contigs of 600 and 1200 segments (over 512 records each,
    so oversize for the native plane's small-contig path): one blocked
    bucket, every contig on the device."""
    paf = tmp_path / "chains.paf"
    paf.write_text(_chain_corpus((600, 11), (1200, 23)))
    stats = _matches_native_and_jax_engine(tmp_path, paf, CFG)
    assert max(stats["bucket_vs"]) > 256 and stats["native_direct"] == 0, stats
    assert stats["device"] + stats["fallback"] == 2, stats


def test_v16384_bucket_matches_native_and_jax_engine(tmp_path):
    """device_max_v=16384, the ceiling: a chain contig of 6000 segments
    (7,859 records, 8,193-16,384 vertices) makes one V = 16384 blocked
    bucket at B = 1 and is counted ``device`` 1, as by the JAX engine;
    the files equal native.run's and the JAX engine's."""
    paf = tmp_path / "v16384.paf"
    paf.write_text(_chain_corpus((6000, 7)))
    cfg = dataclasses.replace(CFG, device_max_v=16384)
    stats = _matches_native_and_jax_engine(tmp_path, paf, cfg)
    assert stats["bucket_vs"] == [16384] and stats["device"] == 1, stats


@pytest.mark.parametrize("realB,V,padB", [
    (1, 8192, 1), (3, 4096, 4), (3, 64, 8), (1, 256, 8), (9, 512, 16),
])
def test_pad_batch(realB, V, padB):
    """A power of two, at least 8 only for V <= 256: a lone big contig
    costs one slab, not eight."""
    assert scheduler._pad_batch(realB, V) == padB


@pytest.mark.parametrize("device_max_v,cap", [
    (256, 256), (8192, 8192), (40000, 32767),
])
def test_device_cap_bounds_int16_rows(device_max_v, cap):
    """The vertex cap is device_max_v bounded by the int16 rows' 32767,
    as the JAX scheduler's."""
    from alignasm_tpu.runtime.scheduler import _device_cap

    cfg = dataclasses.replace(CFG, device_max_v=device_max_v)
    assert scheduler._device_cap(cfg) == cap == _device_cap(cfg)


def _degrades(tmp_path, monkeypatch, obj, name, text=None):
    """Make ``obj.name`` (a host-plane step) raise, run the port on
    ``text`` (a small corpus by default), and check that the failure is
    recorded with a warning while every contig is still solved natively:
    the files stay byte-equal to native.run."""
    paf = tmp_path / "degrade.paf"
    paf.write_text(text or generate_paf(n_contigs=8, seed=5))

    def boom(*a, **k):
        raise RuntimeError("simulated host-plane failure")

    monkeypatch.setattr(obj, name, boom)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, stats = _port(paf, tmp_path / "port")
    assert any(issubclass(w.category, RuntimeWarning) for w in caught)
    assert "simulated host-plane failure" in stats.get("device_error", ""), stats
    assert stats["device"] == 0 and stats["native_direct"] > 0
    assert got == _native(paf, tmp_path / "native")


def test_device_failure_degrades_to_native_solve(tmp_path, monkeypatch):
    """A failing wire export degrades every contig to the native solve."""
    _degrades(tmp_path, monkeypatch, scheduler, "export_wire")


@pytest.mark.parametrize("finish", ["finish_bulk8", "finish_bulk16"])
def test_finish_failure_degrades_to_native_solve(tmp_path, monkeypatch,
                                                 finish):
    """A failing C++ finish degrades its contigs to the native solve: the
    uint8 rows' finish on small contigs, the int16 rows' on a chain
    contig in a V = 1024 blocked bucket."""
    text = _chain_corpus((600, 11)) if finish == "finish_bulk16" else None
    _degrades(tmp_path, monkeypatch, tnative.GraphExporter, finish, text)


class _FakeLib:
    @staticmethod
    def aln_cuda_error_string(rc):
        return b"out of memory"


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_kernel_failure_raises(tmp_path, monkeypatch, failure):
    """A kernel that cannot be built or launched raises out of the
    engine: no contig moves to the native solve in its place."""
    from alignasm_tpu_torch.ops import _build

    if failure == "build":  # no nvcc anywhere
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
        monkeypatch.setattr(_build, "_lib", None)
        kernel, needle = (lambda: _build.load_library()), "nvcc not found"
    else:
        monkeypatch.setattr(_build, "_lib", _FakeLib)
        kernel = lambda: _build.check(2, "topo_scan_nxt8")  # noqa: E731
        needle = "CUDA launch failed .2: out of memory"

    def solve(*a, **k):
        kernel()

    monkeypatch.setattr(scheduler, "solve_bucket", solve)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        with pytest.raises(RuntimeError, match=needle):
            _port(DATA / "synth50.paf", tmp_path / "x")
    assert not list(tmp_path.glob("x.aln*"))  # nothing was written


@pytest.mark.parametrize("change,src_paths,needle", [
    (dict(device_max_v=32768), True, "16384"),
])
def test_uncovered_configurations_raise(tmp_path, change, src_paths, needle):
    cfg = dataclasses.replace(CFG, **change)
    paths = (str(DATA / "synth_small.paf"), None) if src_paths else None
    with pytest.raises(NotImplementedError, match=needle):
        solve_dataset_torch(None, cfg, src_paths=paths,
                            write_prefix=str(tmp_path / "x"), device="cpu")


def test_cuda_request_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        solve_dataset_torch(None, CFG, src_paths=(str(DATA / "synth50.paf"), None),
                            write_prefix=str(tmp_path / "x"), device="cuda")
    assert not list(tmp_path.iterdir())  # nothing ran, nothing was written


def test_port_never_imports_jax(tmp_path):
    """Importing every module of the port (the device bench, its bounds and
    the entry points by name too) and running both its planes, a resumed run
    and the batched relaxation of ``graft_entry.entry`` on the CPU loads no
    JAX module and nothing of the JAX package (``alignasm_tpu`` or
    ``alignasm_tpu.*``)."""
    paf = tmp_path / "s.paf"
    paf.write_bytes((DATA / "synth50.paf").read_bytes())
    journal = tmp_path / "s.journal"
    code = (
        "import importlib, io, pkgutil, sys\n"
        "import alignasm_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'alignasm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from alignasm_tpu_torch import cli, graft_entry\n"
        "from alignasm_tpu_torch.runtime import devbench, roofline\n"
        "from alignasm_tpu_torch.testing import realism_stats\n"
        "fn, args = graft_entry.entry(device='cpu')\n"
        "assert set(fn(*args)) >= {'d_s', 'cnt_min'}\n"
        "assert roofline.mem_peak('cpu') is None\n"
        "assert devbench.main(['--no-such-flag']) == 2\n"
        "from alignasm_tpu_torch.config import DEFAULT_CONFIG\n"
        "from alignasm_tpu_torch.io.paf import read_paf\n"
        "from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch\n"
        f"assert cli.run([{str(paf)!r}], device='cpu') == 0\n"
        f"assert cli.run([{str(paf)!r}, '--resume', {str(journal)!r}],\n"
        "               device='cpu') == 0\n"
        f"assert cli.run([{str(paf)!r}, '--engine', 'native', '--resume',\n"
        f"                {str(journal)!r} + '.native']) == 0\n"
        f"solve_dataset_torch(read_paf({str(paf)!r}), DEFAULT_CONFIG,\n"
        "                    device='cpu')\n"
        "assert solve_dataset_torch.last_stats['host_plane'] == 'python'\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'alignasm_tpu')\n"
        "             or m.startswith(('jax.', 'alignasm_tpu.')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _outputs(tmp_path / "s") == _outputs(DATA / "synth50")


NEVER = dataclasses.replace(CFG, device_routing="never")


@pytest.mark.parametrize("name", ["synth50", "synth_hard"])
def test_never_routing_writes_native_files(tmp_path, name):
    """``device_routing="never"`` with output files runs the fused
    native pipeline: the goldens, the JAX engine's files, and the JAX
    engine's stats keys, ``cost_model`` among them."""
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    paf = DATA / f"{name}.paf"
    got, stats = _port(paf, tmp_path / "port", NEVER)
    assert got == _outputs(DATA / name)
    solve_dataset_tpu(None, NEVER, src_paths=(str(paf), None),
                      write_prefix=str(tmp_path / "jax"))
    assert got == _outputs(tmp_path / "jax")
    jstats = solve_dataset_tpu.last_stats
    assert set(stats) == set(jstats)
    assert set(stats["cost_model"]) == set(jstats["cost_model"])
    assert stats["routed"] == jstats["routed"] == "fused-native"
    for key in ("device", "device_routed_frac", "n_contigs", "n_records"):
        assert stats[key] == jstats[key], key


def test_never_routing_in_memory_matches_jax_engine():
    """Without output files every contig solves on the exporter's native
    plane: results equal to the JAX engine's, its stats keys
    (``cost_model`` among them), nothing on the device."""
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    paths = (str(DATA / "synth_hard.paf"), None)
    got = solve_dataset_torch(None, NEVER, src_paths=paths, device="cpu")
    stats = solve_dataset_torch.last_stats
    want = solve_dataset_tpu(None, NEVER, src_paths=paths)
    jstats = solve_dataset_tpu.last_stats
    assert repr(got) == repr(want)  # a dataclass repr names no module
    assert set(stats) == set(jstats)
    assert stats["routed"] == "native-plane" and stats["device"] == 0
    for key in ("native_direct", "singleton", "oversize", "n_contigs"):
        assert stats[key] == jstats[key], key


@pytest.mark.parametrize("write", [True, False])
def test_never_routing_native_error_degrades_to_python_plane(
        tmp_path, monkeypatch, write):
    """A NativeError under "never" degrades to the Python plane when a
    dataset was given (a RuntimeWarning, the reason in the stats), and
    raises without one."""
    from alignasm_tpu_torch.io.paf import read_paf

    def boom(*a, **k):
        raise tnative.NativeError("simulated native failure")

    monkeypatch.setattr(tnative, "run", boom)
    monkeypatch.setattr(tnative, "GraphExporter", boom)
    paf = DATA / "synth50.paf"
    prefix = str(tmp_path / "x") if write else None
    with pytest.warns(RuntimeWarning, match="native host plane unavailable"):
        got = solve_dataset_torch(read_paf(paf), NEVER,
                                  src_paths=(str(paf), None),
                                  write_prefix=prefix, device="cpu")
    stats = solve_dataset_torch.last_stats
    assert stats["host_plane"] == "python" and stats["device"] > 0
    assert "simulated native failure" in stats["native_error"]
    assert len(got[0]) == 50
    with pytest.raises(tnative.NativeError):
        solve_dataset_torch(None, NEVER, src_paths=(str(paf), None),
                            write_prefix=prefix, device="cpu")


@pytest.mark.parametrize("routing", ["always", "never"])
def test_contig_count_mismatch_raises_as_in_jax(routing):
    """A dataset that does not hold the file's contigs raises the JAX
    scheduler's AssertionError in both packages."""
    from alignasm_tpu.io.paf import read_paf as jax_read
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu
    from alignasm_tpu_torch.io.paf import read_paf

    cfg = dataclasses.replace(CFG, device_routing=routing)
    paths = (str(DATA / "synth50.paf"), None)
    small = DATA / "synth_small.paf"
    with pytest.raises(AssertionError, match="contig count mismatch"):
        solve_dataset_torch(read_paf(small), cfg, src_paths=paths,
                            device="cpu")
    with pytest.raises(AssertionError, match="contig count mismatch"):
        solve_dataset_tpu(jax_read(small), cfg, src_paths=paths)


def test_always_stats_keys_contain_jax_engine_keys(tmp_path):
    """With "always" the native plane writes every stats key the JAX
    engine writes: ``cost_model``, ``device_routed_frac``,
    ``written_natively`` and one ``bucket_phases`` entry (V, contigs,
    sync_s, finish_s) per finished bucket among them."""
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    paf = DATA / "synth_hard.paf"
    _got, stats = _port(paf, tmp_path / "port")
    solve_dataset_tpu(None, CFG, src_paths=(str(paf), None),
                      write_prefix=str(tmp_path / "jax"))
    jstats = solve_dataset_tpu.last_stats
    assert set(jstats) - JAX_ONLY <= set(stats), set(jstats) - set(stats)
    assert set(stats["cost_model"]) == set(jstats["cost_model"])
    assert stats["written_natively"] is True
    assert stats["device_routed_frac"] == jstats["device_routed_frac"] > 0
    phases = stats["bucket_phases"]
    assert [p[0] for p in phases] == stats["bucket_vs"]
    assert sum(p[1] for p in phases) == stats["device"] + stats["fallback"]


def _cli_err(capsys, run, argv):
    assert run(argv) == 1
    return capsys.readouterr().err


@pytest.mark.parametrize("argv", [["in.txt"], ["in.paf", "-a", "alt.txt"]])
def test_cli_wrong_paf_message_matches_jax(capsys, monkeypatch, tmp_path,
                                           argv):
    """"Wrong PAF file" names the absolute path, the PAF checked before
    the alt, as the JAX CLI prints it."""
    from alignasm_tpu import cli as jax_cli

    monkeypatch.chdir(tmp_path)
    got = _cli_err(capsys, lambda a: cli.run(a, device="cpu"), argv)
    assert got == _cli_err(capsys, jax_cli.run, argv)
    bad = argv[-1]
    assert got == f"Wrong PAF file : {tmp_path / bad}\n"


def test_cli_degrade_prints_file_read_complete(tmp_path, monkeypatch, capsys):
    """On a NativeError the CLI reads the PAF, says "File read complete"
    as the JAX CLI does, and writes the goldens."""
    def boom(*a, **k):
        raise tnative.NativeError("simulated native failure")

    paf = tmp_path / "synth50.paf"
    paf.write_bytes((DATA / "synth50.paf").read_bytes())
    # the cuda engine's "auto" routing reaches the native plane through
    # the exporter or, when its cost model predicts no win, native.run
    monkeypatch.setattr(tnative, "GraphExporter", boom)
    monkeypatch.setattr(tnative, "run", boom)
    assert cli.run([str(paf)], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "File read complete" and out[1] == "Write output PAF file"
    assert _outputs(tmp_path / "synth50") == _outputs(DATA / "synth50")
