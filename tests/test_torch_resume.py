"""Resume and the command line of the port on the CPU.

``alignasm_tpu_torch/runtime/checkpoint.py`` (a copy of the JAX
package's, held to it here) resumes a half-filled journal with each
engine, ``cuda`` through ``solve_missing_torch_native`` (the native
plane) or the Python plane, and writes the same bytes as the port's and
the JAX package's ``native.run`` and the committed goldens; the guards of
the journal; and ``alignasm_tpu_torch/cli.py``'s flags against the JAX
command line's.

Module-level imports are the port's only, so the ``gpu`` test runs on a
machine without JAX (``python -m pytest tests/test_torch_resume.py
--noconftest -q -m gpu``).  Outputs are compared byte for byte.
"""

import dataclasses
import json
import os
import pickle
from pathlib import Path

import pytest
import torch

from alignasm_tpu_torch import cli, native
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.io.paf import read_paf, write_outputs
from alignasm_tpu_torch.runtime import checkpoint
from alignasm_tpu_torch.runtime.checkpoint import (
    Journal, contig_digest, solve_dataset_resumable,
)
from alignasm_tpu_torch.runtime.scheduler import (
    solve_dataset_torch, solve_missing_torch_native,
)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
SUFFIXES = ("", ".alt", ".all")
ENV = "ALIGNASM_TORCH_COSTMODEL"
# tests/test_routing.py's near-free transport: every bucket launches
LAUNCH_ALL = {"finish_vs_solve": 0.2, "dispatch_rtt_s": 1e-7,
              "h2d_bytes_per_s": 1e12, "d2h_bytes_per_s": 1e12,
              "device_s_per_contig": 1e-9, "device_s_per_step": 1e-9,
              "solve_s_per_record": 1e-3}


def _outputs(prefix):
    return [Path(f"{prefix}.aln{s}.paf").read_bytes() for s in SUFFIXES]


def _write(dataset, results, prefix):
    for s, outs, counts in zip(SUFFIXES, results, (False, False, True)):
        with open(f"{prefix}.aln{s}.paf", "w") as fh:
            write_outputs(dataset, outs, fh, name_suffix_counts=counts)


def _journal_len(path) -> int:
    j = Journal(str(path))
    j.close()
    return len(j)


def _calibrate_with(tmp_path, monkeypatch, cal):
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(cal))
    monkeypatch.setenv(ENV, str(path))


def _half_journal(paf, journal, cfg=DEFAULT_CONFIG):
    """A journal holding the even-indexed contigs of ``paf``, solved by
    the native engine (a full native resume into a scratch journal, of
    which the even entries are kept).  Returns the parsed dataset."""
    dataset = read_paf(str(paf))
    full = str(journal) + ".full"
    solve_dataset_resumable(dataset, cfg, full, engine="native",
                            src_paths=(str(paf), None))
    src, dst = Journal(full), Journal(str(journal))
    try:
        for c in dataset.contigs[::2]:
            key = contig_digest(c, cfg)
            dst.put(key, src.get(key))
    finally:
        src.close()
        dst.close()
    os.remove(full)
    return read_paf(str(paf))


# --- (e) resume -----------------------------------------------------------

@pytest.mark.parametrize("engine,cal,paths", [
    ("exact", None, True), ("native", None, True), ("cuda", {}, True),
    ("cuda", LAUNCH_ALL, True), ("cuda", None, False),
], ids=["exact", "native", "cuda-auto-no-win", "cuda-launch-all",
        "cuda-python-plane"])
def test_resume_half_journal_writes_goldens(tmp_path, monkeypatch, engine,
                                            cal, paths):
    """A journal holding half of synth50's contigs: the other half is
    solved by ``engine`` and the three files equal the port's and the JAX
    package's ``native.run`` and the goldens.  The cuda engine with a
    source file goes through ``solve_missing_torch_native`` (on the
    device under the launch-everything model), without one through the
    Python plane."""
    from alignasm_tpu import native as jnative
    from alignasm_tpu.config import DEFAULT_CONFIG as JCFG

    if cal is not None:
        _calibrate_with(tmp_path, monkeypatch, cal)
    paf = DATA / "synth50.paf"
    journal = tmp_path / "j.journal"
    dataset = _half_journal(paf, journal)
    solve_dataset_torch.last_stats = None
    *results, stats = solve_dataset_resumable(
        dataset, DEFAULT_CONFIG, str(journal), engine=engine,
        src_paths=(str(paf), None) if paths else None, device="cpu")
    assert stats["resumed"] == 25 and stats["solved"] == 25, stats
    _write(dataset, results, tmp_path / "port")
    native.run(str(paf), out_prefix=str(tmp_path / "pnative"),
               config=DEFAULT_CONFIG)
    jnative.run(str(paf), out_prefix=str(tmp_path / "jnative"), config=JCFG)
    got = _outputs(tmp_path / "port")
    assert got == _outputs(tmp_path / "pnative") == \
        _outputs(tmp_path / "jnative") == _outputs(DATA / "synth50")
    tstats = solve_dataset_torch.last_stats
    if engine != "cuda":
        assert tstats is None
    elif paths:
        assert stats["host_plane"] == "native"
        assert tstats["routing"] == "auto" and "cost_model" in tstats
        if cal:
            assert tstats["device"] > 0 and "buckets_gated" not in tstats
        else:
            assert tstats["device"] == 0
            assert tstats["native_direct"] == 25
    else:
        assert tstats["host_plane"] == "python" and tstats["device"] > 0
    assert _journal_len(journal) == 50


@pytest.mark.parametrize("cal", [{}, LAUNCH_ALL], ids=["no-win",
                                                       "launch-all"])
def test_failed_native_solve_of_the_missing_is_solved_again(
        tmp_path, monkeypatch, cal):
    """When the native solve of the non-device members fails (on the
    overlap thread beside the device, or alone when nothing goes to the
    device), ``solve_missing_torch_native`` solves them again before any
    of them reaches the journal: the files are the goldens.  The contigs
    over 24 vertices are kept off the device, so both solves have work."""
    _calibrate_with(tmp_path, monkeypatch, cal)
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_max_v=24)
    real = native.GraphExporter.solve_subset
    calls = []

    def first_fails(self, idx, *args, **kwargs):
        calls.append(len(idx))
        if len(calls) == 1:
            raise native.NativeError("injected")
        return real(self, idx, *args, **kwargs)

    paf = DATA / "synth50.paf"
    journal = tmp_path / "j.journal"
    dataset = _half_journal(paf, journal, cfg)
    monkeypatch.setattr(native.GraphExporter, "solve_subset", first_fails)
    *results, _stats = solve_dataset_resumable(
        dataset, cfg, str(journal), engine="cuda",
        src_paths=(str(paf), None), device="cpu")
    stats = solve_dataset_torch.last_stats
    assert "injected" in stats["overlap_error"]
    assert len(calls) == 2 and calls[1] >= calls[0] > 0
    assert (stats["device"] > 0) == bool(cal)
    _write(dataset, results, tmp_path / "port")
    assert _outputs(tmp_path / "port") == _outputs(DATA / "synth50")
    assert _journal_len(journal) == 50


def test_expected_n_mismatch_raises_before_any_journal_write(tmp_path):
    """A source file that does not describe the dataset raises before a
    single result is stored, in the resume path and in
    ``solve_missing_torch_native`` itself."""
    small = read_paf(str(DATA / "synth_small.paf"))
    journal = tmp_path / "j.journal"
    with pytest.raises(RuntimeError, match="src_paths does not match"):
        solve_dataset_resumable(small, DEFAULT_CONFIG, str(journal),
                                engine="cuda",
                                src_paths=(str(DATA / "synth50.paf"), None),
                                device="cpu")
    assert journal.stat().st_size == 0

    calls = []
    with pytest.raises(RuntimeError, match="expects 7"):
        solve_missing_torch_native(
            DEFAULT_CONFIG, (str(DATA / "synth50.paf"), None), [0, 1],
            put_chunk=lambda *a: calls.append(a), expected_n=7,
            device="cpu")
    assert calls == []


def test_truncated_journal_tail_is_cut(tmp_path):
    """A crash mid-write leaves a torn record at the journal's tail; the
    next open cuts it, so later entries stay reachable, and the resumed
    run writes the goldens."""
    paf = DATA / "synth50.paf"
    journal = tmp_path / "j.journal"
    dataset = _half_journal(paf, journal)
    good = journal.stat().st_size
    with open(journal, "ab") as fh:
        fh.write(pickle.dumps(("torn", [1, 2, 3]))[:-5])
    assert _journal_len(journal) == 25 and journal.stat().st_size == good
    *results, stats = solve_dataset_resumable(
        dataset, DEFAULT_CONFIG, str(journal), engine="native",
        src_paths=(str(paf), None))
    assert stats["resumed"] == 25
    _write(dataset, results, tmp_path / "port")
    assert _outputs(tmp_path / "port") == _outputs(DATA / "synth50")
    assert _journal_len(journal) == 50


def test_checkpoint_copy_differs_only_in_its_listed_edits():
    """The copy is the JAX package's module with the port's import
    prefix, a docstring paragraph, ``device`` and the cuda engine."""
    orig = (REPO / "alignasm_tpu" / "runtime" / "checkpoint.py").read_text()
    text = orig.replace("alignasm_tpu.", "alignasm_tpu_torch.")
    edits = (
        ('"""Per-contig checkpoint/resume.\n',
         '"""Per-contig checkpoint/resume.\n\n'
         + checkpoint.__doc__.split("\n\n")[1] + "\n"),
        ("from alignasm_tpu import native",
         "from alignasm_tpu_torch import native"),
        ("chunk: int = 512, threads: int = 0):",
         "chunk: int = 512, threads: int = 0,\n"
         "                            device=\"cuda\"):"),
        ("      * ``tpu``    — the batched device engine solves the missing "
         "subset\n        in chunks.",
         "      * ``cuda``   — the batched device engine solves the missing "
         "subset\n        in chunks, on ``device``."),
        ('engine == "tpu" and src_paths', 'engine == "cuda" and src_paths'),
        ("50k-contig tpu run", "50k-contig cuda run"),
        ("import solve_missing_tpu_native",
         "import (\n                solve_missing_torch_native,\n"
         "            )"),
        ("tstats = solve_missing_tpu_native(",
         "tstats = solve_missing_torch_native("),
        ("expected_n=n,\n", "expected_n=n,\n                    "
                            "device=device,\n"),
        ('elif engine == "tpu":', 'elif engine == "cuda":'),
        ("import solve_dataset_tpu", "import solve_dataset_torch"),
        ("solve_dataset_tpu(sub, cfg)",
         "solve_dataset_torch(sub, cfg, device=device)"),
    )
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert (REPO / "alignasm_tpu_torch" / "runtime"
            / "checkpoint.py").read_text() == text


# --- (f) the command line -------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--engine", "cuda"], ["--engine", "native"], ["--engine", "exact"],
    ["--engine", "native", "-t", "2"], ["--engine", "exact", "-t", "2"],
    ["--engine", "exact", "--progress"], ["--resume", "J"],
    ["--engine", "native", "--resume", "J"],
    ["--engine", "exact", "--resume", "J", "-t", "2"],
    ["--engine", "exact", "--profile", "P"],
], ids=lambda f: "_".join(x.strip("-") for x in f))
def test_cli_flags_write_goldens(tmp_path, capsys, flags):
    """Each engine and flag of the JAX command line writes synth50's
    goldens; ``--resume`` leaves a journal of every contig, ``--profile``
    a trace, ``--progress`` the exact engine's bar."""
    paf = tmp_path / "synth50.paf"
    paf.write_bytes((DATA / "synth50.paf").read_bytes())
    flags = [str(tmp_path / "j.journal") if f == "J"
             else str(tmp_path / "prof") if f == "P" else f for f in flags]
    assert cli.run([str(paf), *flags], device="cpu") == 0
    assert _outputs(tmp_path / "synth50") == _outputs(DATA / "synth50")
    out, err = capsys.readouterr()
    assert "contigs" in out.splitlines()[-1]
    if "--resume" in flags:
        assert "resume: {'resumed': 0, 'solved': 50" in out
        assert _journal_len(tmp_path / "j.journal") == 50
    if "--profile" in flags:
        trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
        assert trace["traceEvents"]
    if "--progress" in flags:
        assert "(50/50 contigs)" in err


@pytest.mark.parametrize("cal", [{}, LAUNCH_ALL], ids=["no-win",
                                                       "launch-all"])
def test_cli_cuda_engine_routes_by_the_cost_model(tmp_path, monkeypatch,
                                                  capsys, cal):
    """The cuda engine runs ``DEFAULT_CONFIG``'s ``"auto"``: the fused
    native plane under a model with no win, the device pipeline under the
    launch-everything model; the goldens either way."""
    _calibrate_with(tmp_path, monkeypatch, cal)
    paf = tmp_path / "synth_hard.paf"
    paf.write_bytes((DATA / "synth_hard.paf").read_bytes())
    assert cli.run([str(paf), "--progress"], device="cpu") == 0
    assert _outputs(tmp_path / "synth_hard") == _outputs(DATA / "synth_hard")
    stats = solve_dataset_torch.last_stats
    assert stats["routing"] == "auto"
    assert f"device engine stats: {stats}" in capsys.readouterr().out
    if cal:
        assert stats["device"] > 0 and "routed" not in stats
    else:
        assert stats["routed"] == "fused-native" and stats["device"] == 0


def test_cli_resume_skips_journaled_contigs(tmp_path, capsys):
    """A second run with the same journal resumes every contig."""
    paf = tmp_path / "synth50.paf"
    paf.write_bytes((DATA / "synth50.paf").read_bytes())
    journal = str(tmp_path / "j.journal")
    _half_journal(paf, journal)
    assert cli.run([str(paf), "--resume", journal], device="cpu") == 0
    assert "resume: {'resumed': 25, 'solved': 25" in capsys.readouterr().out
    assert _outputs(tmp_path / "synth50") == _outputs(DATA / "synth50")


def _cli_err(capsys, run, argv):
    assert run(argv) == 1
    return capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["in.txt", "--engine", "native"], ["in.paf", "-a", "alt.txt", "-t", "2"],
    ["in.txt", "--resume", "j"],
])
def test_cli_wrong_paf_message_matches_jax_with_every_flag(capsys, monkeypatch,
                                                           tmp_path, argv):
    from alignasm_tpu import cli as jax_cli

    monkeypatch.chdir(tmp_path)
    got = _cli_err(capsys, lambda a: cli.run(a, device="cpu"), argv)
    assert got == _cli_err(capsys, jax_cli.run, argv)
    assert got.startswith("Wrong PAF file : ")


def test_cli_native_error_message_matches_jax(capsys, tmp_path):
    """The native engine on a file it cannot read prints the JAX command
    line's message under the port's name and exits 1."""
    from alignasm_tpu import cli as jax_cli

    missing = str(tmp_path / "missing.paf")
    got = _cli_err(capsys, lambda a: cli.run(a, device="cpu"),
                   [missing, "--engine", "native"])
    want = _cli_err(capsys, jax_cli.run, [missing, "--engine", "native"])
    assert want.startswith("alignasm_tpu: ")
    assert got == "alignasm_tpu_torch: " + want[len("alignasm_tpu: "):]


def test_cli_defaults_match_jax():
    """The flags, their defaults and choices are the JAX command line's,
    with ``cuda`` in place of ``tpu`` as the default engine."""
    from alignasm_tpu import cli as jax_cli

    def actions(parser):
        return {a.dest: (a.option_strings, a.choices, a.default)
                for a in parser._actions}

    mine, theirs = actions(cli.build_arg_parser()), actions(
        jax_cli.build_arg_parser())
    assert set(mine) == set(theirs)
    for dest, (opts, choices, default) in theirs.items():
        if dest == "engine":
            assert mine[dest][1] == ["cuda", "native", "exact"]
            assert mine[dest][2] == "cuda"
        else:
            assert mine[dest] == (opts, choices, default), dest


# --- (g) on the card ------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_resume_on_the_card(tmp_path, monkeypatch, cuda_device):
    """The cuda engine resumes a half-filled journal on the card under
    the launch-everything model: the missing contigs go through the scan,
    and the files equal native.run's."""
    from alignasm_tpu_torch.ops import launch_counts, reset_launch_counts
    from alignasm_tpu_torch.testing.synth import generate_paf

    _calibrate_with(tmp_path, monkeypatch, LAUNCH_ALL)
    paf = tmp_path / "r.paf"
    paf.write_text(generate_paf(n_contigs=64, seed=17))
    journal = tmp_path / "j.journal"
    dataset = _half_journal(paf, journal)
    reset_launch_counts()
    *results, stats = solve_dataset_resumable(
        dataset, DEFAULT_CONFIG, str(journal), engine="cuda",
        src_paths=(str(paf), None), device=cuda_device)
    counts = launch_counts()
    assert stats["resumed"] == 32 and stats["solved"] == 32
    tstats = solve_dataset_torch.last_stats
    assert tstats["device"] > 0 and "device_error" not in tstats
    assert counts["topo_scan"] >= 1, counts
    _write(dataset, results, tmp_path / "port")
    native.run(str(paf), out_prefix=str(tmp_path / "native"),
               config=DEFAULT_CONFIG)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")
