"""What the benchmark loads: nothing of JAX or the JAX package in a run,
nothing of the program in the reference, and no result without the
program or without a card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN_CPU = """
import pathlib, sys, tempfile
from benchmark import run
from benchmark.tests._small import cpu_run
for cell in ("karyotype-small", "chromscale-chains"):
    result, _ = cpu_run(cell, pathlib.Path(tempfile.mkdtemp()))
print({m.split(".", 1)[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "alignasm_tpu"})
print(run.forbidden_modules())
"""

REFERENCE = """
import json, sys
from benchmark.corpus import generate
from benchmark.reference import solve
from benchmark.reference.config import DEFAULT_CONFIG
deployment = json.load(open("benchmark/configs/karyotype10k.json"))
text = generate(dict(family="assembly", contigs=10, max_records_per_contig=24,
                     mean_segment=2000, sv_gap=[50, 100000], shape_seed=3),
                4, deployment)
solve.compute(text, DEFAULT_CONFIG, 1)
print(sorted({m.split(".", 1)[0] for m in sys.modules}
             & {"alignasm_tpu_torch", "alignasm_tpu", "jax", "torch"}))
"""


def _py(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax_and_no_jax_package():
    """Top-level names compared whole: alignasm_tpu_torch is the program,
    alignasm_tpu the JAX package."""
    p = _py(RUN_CPU)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.splitlines()[-2:] == ["set()", "[]"]


def test_the_reference_loads_nothing_of_the_program():
    p = _py(REFERENCE)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.splitlines()[-1] == "[]"


def _bench_cmd(cwd):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return subprocess.run(
        spec["command"] + ["--workload", "karyotype-small", "--seed",
                           str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_result_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _bench_cmd(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present: the run would measure")
    p = _bench_cmd(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
