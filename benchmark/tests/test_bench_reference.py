"""The plain reference held to the port on small corpora (the tests may
import the port; the reference may not)."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from alignasm_tpu_torch import native
from alignasm_tpu_torch.config import DEFAULT_CONFIG as PORT_CFG
from alignasm_tpu_torch.engine.exact import solve_dataset
from alignasm_tpu_torch.io.paf import merge_alt_paf, read_paf, write_outputs
from alignasm_tpu_torch.ops.dense import (
    densify_wire_ragged, solve_slab_topo_nxt16,
)
from alignasm_tpu_torch.runtime.scheduler import _eligible_mask, _next_pow2
from benchmark import run
from benchmark.corpus import generate, generate_alt
from benchmark.reference import dag, solve
from benchmark.reference.config import DEFAULT_CONFIG
from benchmark.sink import SUFFIXES
from benchmark.tests._small import alt_traffic, config

# gaps up to 3 Mb, past sv_baseline, so that the gap anomalies are held
# too; shorter records than a cell's, so the port's engine keeps up
DEPLOYMENT = dict(run.load_cell("chromscale-chains")["config"], contigs=40)
CORPORA = {
    "assembly": (dict(family="assembly", contigs=40,
                      max_records_per_contig=40, mean_segment=2000,
                      sv_gap=[50, 3_000_000], shape_seed=5), DEPLOYMENT),
    "chains": (dict(family="chains", segments=[40, 90, 200], span_share=0.01,
                    sv_gap=[50, 3_000_000], shape_seed=5), DEPLOYMENT),
    # karyotype-small's traffic at 50 contigs with an alt PAF
    "assembly-alt": (alt_traffic("karyotype-small"),
                     config("karyotype-small")),
}
SETTINGS = dict(device_routing="always", device_max_v=16384)


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpus(request, tmp_path_factory):
    """(main path, alt path or None, reference) of one corpus."""
    traffic, deployment = CORPORA[request.param]
    text = generate(traffic, 2**31 + 21, deployment)
    where = tmp_path_factory.mktemp(request.param)
    (where / "in.paf").write_text(text)
    alt, alt_text = None, None
    if "alt" in traffic:
        alt_text = generate_alt(traffic, 2**31 + 21, deployment, text)
        alt = where / "in.alt.paf"
        alt.write_text(alt_text)
    cfg = dataclasses.replace(DEFAULT_CONFIG, **SETTINGS)
    return where / "in.paf", alt, solve.compute(text, cfg, 2,
                                                alt_text=alt_text)


def _ref_files(ref):
    return ["".join(ln + "\n" for name in ref["names"]
                    for ln in ref["lines"][name][k]) for k in range(3)]


def test_lines_equal_the_port_exact_engine(corpus):
    path, alt, ref = corpus
    ds = read_paf(path)
    if alt is not None:
        merge_alt_paf(ds, alt, PORT_CFG.alt_baseline)
    outs = solve_dataset(ds, PORT_CFG)
    want = []
    for k, res in enumerate(outs):
        fh = io.StringIO()
        write_outputs(ds, res, fh, name_suffix_counts=k == 2)
        want.append(fh.getvalue())
    assert _ref_files(ref) == want


@pytest.mark.parametrize("corpus", ["assembly-alt"], indirect=True)
def test_alt_lines_equal_the_native_plane_byte_for_byte(corpus, tmp_path):
    path, alt, ref = corpus
    native.run(str(path), alt_path=str(alt),
               alt_baseline=PORT_CFG.alt_baseline,
               out_prefix=str(tmp_path / "out"), config=PORT_CFG)
    got = [(tmp_path / f"out{sfx}").read_text() for sfx in SUFFIXES]
    assert got == _ref_files(ref)


@pytest.mark.parametrize("corpus", ["assembly-alt"], indirect=True)
def test_alt_records_join_paths(corpus):
    """Some contig's lines differ from the reference without the alt PAF,
    and the merged records reach the record and vertex counts."""
    path, _alt, ref = corpus
    text = path.read_text()
    cfg = dataclasses.replace(DEFAULT_CONFIG, **SETTINGS)
    plain = solve.compute(text, cfg, 2)
    assert ref["names"] == plain["names"]
    changed = [n for n in ref["names"]
               if ref["lines"][n][0] != plain["lines"][n][0]]
    assert changed
    assert int(ref["n_records"].sum()) > int(plain["n_records"].sum())
    assert (ref["n_v"] >= plain["n_v"]).all()


def test_envelope_and_sizes_equal_the_native_exporter(corpus):
    path, alt, ref = corpus
    cfg = dataclasses.replace(PORT_CFG, **SETTINGS)
    with native.GraphExporter(str(path), alt_path=alt and str(alt),
                              alt_baseline=cfg.alt_baseline, config=cfg,
                              max_records=cfg.device_max_v) as exp:
        meta = exp.meta_bulk()
    assert meta[:, 1].tolist() == ref["n_records"].tolist()
    built = meta[:, 0] == 1
    assert meta[built, 2].tolist() == ref["n_v"][built].tolist()
    assert meta[built, 3].tolist() == ref["n_e"][built].tolist()
    assert _eligible_mask(meta, cfg).tolist() == ref["eligible"].tolist()
    assert ref["eligible"].any()


def test_gate_rows_equal_the_port_plain_scan(corpus):
    """Each eligible contig's row against the plain scan of its exported
    wire, in a bucket padded past its size."""
    path, alt, ref = corpus
    cfg = dataclasses.replace(PORT_CFG, **SETTINGS)
    with native.GraphExporter(str(path), alt_path=alt and str(alt),
                              alt_baseline=cfg.alt_baseline, config=cfg,
                              max_records=cfg.device_max_v) as exp:
        meta = exp.meta_bulk()
        for i in np.flatnonzero(ref["eligible"]):
            V = _next_pow2(int(meta[i, 2]) + 1)
            wire, ok, _cap = exp.export_wire_ragged(
                np.array([i]), V, meta[[i], 3], 1)
            assert ok.all()
            slabs = densify_wire_ragged(torch.from_numpy(wire), 1, V)
            got = solve_slab_topo_nxt16(slabs)[0].numpy()
            assert dag.rows_match(got, solve.row_of(ref, int(i)),
                                  int(ref["dest"][i])), i


def test_rounded_sums_change_rows():
    """The control's rounding reaches the rows: at an 8-bit significand
    some of a small corpus's rows differ from the exact ones."""
    text = generate(dict(CORPORA["assembly"][0], contigs=100), 7, DEPLOYMENT)
    cfg = dataclasses.replace(DEFAULT_CONFIG, **SETTINGS)
    exact = solve.compute(text, cfg, 2)
    low = solve.compute(text, cfg, 2, sig_bits=8)
    assert exact["eligible"].tolist() == low["eligible"].tolist()
    assert not np.array_equal(exact["rows"], low["rows"])
