"""Whole runs of each cell on the CPU at a small size (the plain PyTorch
versions in place of the kernels): the result line, the pipes, and the
faults that ``correct`` has to catch."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from alignasm_tpu_torch import native
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.runtime import scheduler
from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch
from benchmark import control, run
from benchmark.corpus import generate
from benchmark.reference import solve
from benchmark.reference.config import DEFAULT_CONFIG as REF_CFG
from benchmark.sink import SUFFIXES, PipeSink
from benchmark.tests._small import (
    alt_traffic, config, cpu_run, small_traffic,
)

CELLS = ["karyotype-small", "chromscale-chains"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_correct_with_the_keys(workload, trace, tmp_path):
    result, lines = cpu_run(workload, tmp_path, trace=bool(trace))
    assert result["correct"], lines
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert ("breakdown" in result) == bool(trace)
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = run.load_cell(workload)
    want = spec["per_layer" if trace else "end_to_end"]
    if trace:  # the device metrics need a card's trace
        want = [m for m in want if m["source"] != "device_trace"]
        assert {"busy_s", "window_s"} <= set(result["device"])
    assert {m["name"] for m in want} <= set(result["metrics"])
    assert [ln.split(":")[0] for ln in lines] == \
        [f"check {k}" for k in result["checks"]]


def test_pipes_carry_the_bytes_files_would(tmp_path):
    text = generate(small_traffic("karyotype-small"), 3,
                    config("karyotype-small"))
    paf = tmp_path / "in.paf"
    paf.write_text(text)
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                        write_prefix=str(tmp_path / "file"), device="cpu")
    (tmp_path / "pipes").mkdir()
    sink = PipeSink(str(tmp_path / "pipes"))
    try:
        for _ in range(2):
            solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                                write_prefix=sink.prefix, device="cpu")
            sink.collect(timeout=120)
            for k, sfx in enumerate(SUFFIXES):
                want = (tmp_path / f"file{sfx}").read_text()
                assert sink.last_text(k) == want
            assert sink.last_text(0)
    finally:
        sink.close()
    assert not any(os.path.exists(p) for p in sink.paths)


def _unchanged(monkeypatch):
    """The solve returns its output buffer as it found it."""
    orig = scheduler.solve_bucket
    monkeypatch.setattr(scheduler, "solve_bucket",
                        lambda *a, **k: torch.zeros_like(orig(*a, **k)))


def _half_batch(monkeypatch):
    """Half of each bucket left out of the device route."""
    orig = scheduler._launch_buckets
    monkeypatch.setattr(scheduler, "_launch_buckets", lambda b, *a: orig(
        [(V, idxs[:max(1, len(idxs) // 2)]) for V, idxs in b], *a))


def _answer_altered(monkeypatch):
    """One contig's fast flag flipped where the solve produces it."""
    orig = scheduler.solve_bucket

    def solve_bucket(kind, args, padB, V):
        rows = orig(kind, args, padB, V).clone()
        rows[0, V] = 1 - rows[0, V]
        return rows
    monkeypatch.setattr(scheduler, "solve_bucket", solve_bucket)


def _byte_altered(monkeypatch, tmp_path):
    """One byte of ``.aln.paf`` altered where the plane writes it."""
    orig = native.GraphExporter.write_results

    def write_results(self, prefix, threads=0):
        orig(self, str(tmp_path / "w"), threads)
        for k, sfx in enumerate(SUFFIXES):
            data = bytearray((tmp_path / f"w{sfx}").read_bytes())
            if k == 0:
                data[len(data) // 2] ^= 1
            with open(prefix + sfx, "wb") as fh:
                fh.write(data)
    monkeypatch.setattr(native.GraphExporter, "write_results", write_results)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "answer_altered", "byte_altered"])
def test_a_broken_timed_path_is_not_correct(fault, workload, monkeypatch,
                                            tmp_path):
    if fault == "byte_altered":
        _byte_altered(monkeypatch, tmp_path)
    else:
        {"unchanged": _unchanged, "half_batch": _half_batch,
         "answer_altered": _answer_altered}[fault](monkeypatch)
    result, lines = cpu_run(workload, tmp_path)
    assert not result["correct"], lines


@pytest.mark.parametrize("trace", [0, 1])
def test_an_alt_traffic_runs_correct(trace, tmp_path):
    """karyotype-small's traffic with an alt PAF: the timed call passes it,
    the reference merges it, and the cache keeps it apart from the plain
    corpus of the same cell and seed."""
    plain, _ = cpu_run("karyotype-small", tmp_path)
    result, lines = cpu_run("karyotype-small", tmp_path, trace=bool(trace),
                            traffic=alt_traffic("karyotype-small"))
    assert plain["correct"] and result["correct"], lines
    assert result["attempted"] > 0
    where = sorted((tmp_path / "cache" / "karyotype-small").glob("*/*"))
    assert len(where) == 2
    assert [(w / "corpus.alt.paf").exists() for w in where].count(True) == 1


def test_the_alt_dropped_is_not_correct(monkeypatch, tmp_path):
    """The timed call made without the alt PAF misses the merged records."""
    orig = scheduler._solve_dataset_torch

    def without_alt(dataset, cfg, src_paths, *a, **k):
        assert src_paths[1] is not None
        return orig(dataset, cfg, (src_paths[0], None), *a, **k)
    monkeypatch.setattr(scheduler, "_solve_dataset_torch", without_alt)
    result, lines = cpu_run("karyotype-small", tmp_path,
                            traffic=alt_traffic("karyotype-small"))
    assert result["checks"]["files_bad"]["value"] > 0, lines
    assert not result["correct"], lines


def test_the_control_is_not_correct():
    """The reference with its path sums rounded to an 8-bit significand
    (bfloat16), in the program's place, fails the row comparison."""
    text = generate(dict(small_traffic("karyotype-small"), contigs=150),
                    2**31 + 1, config("karyotype-small"))
    cfg = dataclasses.replace(REF_CFG, device_routing="always")
    ref = solve.compute(text, cfg, 2)
    low = solve.compute(text, cfg, 2, sig_bits=8)
    numbers = control.control_numbers(ref, low)
    assert numbers["rows_bad"] > 0
    assert control.control_numbers(ref, ref)["rows_bad"] == 0
    assert np.count_nonzero(ref["eligible"]) > 0
