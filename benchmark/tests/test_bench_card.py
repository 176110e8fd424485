"""The cells on the card at a small size: run ``python -m pytest
benchmark/tests -m gpu`` on a machine with one."""

import pytest

from benchmark import run
from benchmark.tests._small import alt_traffic, small_traffic


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["karyotype-small", "chromscale-chains"])
def test_a_cell_runs_correct_on_the_card(workload, tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    result, lines = run.run_cell(workload, 2**31 + 17, 2.0, True,
                                 cache=tmp_path / "cache",
                                 traffic=small_traffic(workload), workers=2,
                                 log=lambda _m: None)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0


@pytest.mark.gpu
def test_an_alt_traffic_runs_correct_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    result, lines = run.run_cell("karyotype-small", 2**31 + 19, 2.0, False,
                                 cache=tmp_path / "cache",
                                 traffic=alt_traffic("karyotype-small"),
                                 workers=2, log=lambda _m: None)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
