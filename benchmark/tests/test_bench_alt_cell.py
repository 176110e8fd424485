"""The cell ``karyotype-alt`` (the alt-PAF deployment, ``-a alt.paf -b 0.5``)
on the CPU at a small size: its files, a correct run, its two per-layer
readers, and the roofline's work counted with the merged records."""

import json

import numpy as np
import pytest

from alignasm_tpu_torch import native
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from benchmark import roofline, run
from benchmark.tests._small import ALT, cpu_run

CELL = "karyotype-alt"
READERS = {"pack_alt_merge_ms": "native_alt_merge_s",
           "pack_alt_build_ms": "native_alt_build_s"}


def _file(rel):
    return json.loads((run.ROOT / rel).read_text())


def test_the_cell_loads_with_karyotype10k_and_the_upstream_baseline():
    spec = run.load_cell(CELL)
    assert spec["cell"]["traffic"] == "small-alt"
    assert spec["cell"]["chips"] == 1
    plain, cfg = _file("benchmark/configs/karyotype10k.json"), spec["config"]
    for key in ("reference_genome", "contigs", "precision", "reduced"):
        assert cfg[key] == plain[key], key
    assert cfg["reduced"] == []
    assert cfg["settings"] == dict(plain["settings"], alt_baseline=0.5)
    assert DEFAULT_CONFIG.alt_baseline == 0.5
    metrics = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["layer"] == "native host plane"


def test_the_traffic_is_small_with_the_alt_block():
    small = _file("benchmark/traffic/small.json")
    alt = run.load_cell(CELL)["traffic"]
    assert alt["derivation"].startswith(small["derivation"] + "; ")
    assert "github.com/ACCtools/alignasm" in alt["derivation"]
    drop = lambda d: {k: v for k, v in d.items() if k != "derivation"}  # noqa: E731
    assert drop(alt) == dict(drop(small), alt=ALT)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_run_is_correct_and_reads_the_alt_stages(trace, tmp_path):
    result, lines = cpu_run(CELL, tmp_path, trace=bool(trace))
    assert result["correct"], lines
    assert result["attempted"] > 0
    assert any((tmp_path / "cache" / CELL).rglob("corpus.alt.paf"))
    if trace:
        for name in READERS:
            assert result["metrics"][name]["value"] > 0, name
            assert result["metrics"][name]["unit"] == "ms"
    else:
        assert set(result["metrics"]) == {"contigs_per_s", "setup_s"}


def _readings(stats):
    return run.Readings(stats, None, len(stats), 1e-6)


def test_the_readers_give_none_without_the_slots():
    """A program without the two slots gives no value and no exception; a
    pass with no alt PAF reads 0.0, as the other counters' readers do."""
    plain = {"pack_s": 0.1, "native_scan_s": 0.01, "native_scan_n": 1}
    for name, key in READERS.items():
        read = run.metric_reader(name)
        assert read(_readings([plain] * 3)) is None
        assert read(_readings([dict(plain, **{key: 0.0})] * 3)) == 0.0
        assert read(_readings([{key: 0.002}, {key: 0.004}, plain])) == \
            pytest.approx(3.0)


def test_the_other_cells_read_no_alt_stage(tmp_path):
    result, lines = cpu_run("karyotype-small", tmp_path, trace=True)
    assert result["correct"], lines
    for name in READERS:
        assert result["metrics"][name]["value"] == 0.0, name


def test_the_roofline_counts_the_merged_alt_vertices(monkeypatch, tmp_path):
    """``kernel_roofline_pct``'s work comes from the reference's DAGs with
    the alt records merged: the vertices and edges the port's exporter
    builds with the alt PAF, more than without it."""
    seen = []
    orig = roofline.pass_work

    def capture(n_v, n_e, eligible):
        seen.append((np.asarray(n_v), np.asarray(n_e),
                     np.asarray(eligible)))
        return orig(n_v, n_e, eligible)

    monkeypatch.setattr(roofline, "pass_work", capture)
    result, lines = cpu_run(CELL, tmp_path, trace=True)
    assert result["correct"], lines
    (n_v, n_e, elig), = seen
    paf = next((tmp_path / "cache" / CELL).rglob("corpus.paf"))
    cfg = run.load_cell(CELL)["config"]["settings"]
    metas = []
    for alt in (paf.with_name("corpus.alt.paf"), None):
        with native.GraphExporter(str(paf), alt_path=alt and str(alt),
                                  alt_baseline=0.5,
                                  max_records=cfg["device_max_v"]) as exp:
            metas.append(exp.meta_bulk())
    with_alt, plain = metas
    assert with_alt[elig, 2].tolist() == n_v[elig].tolist()
    assert with_alt[elig, 3].tolist() == n_e[elig].tolist()
    assert with_alt[:, 1].sum() > plain[:, 1].sum()
    assert roofline.pass_work(n_v, n_e, elig) > roofline.pass_work(
        plain[:, 2], plain[:, 3], elig)
