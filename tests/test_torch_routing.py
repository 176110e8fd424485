"""The port's device routing on the CPU: its copy of the cost model
(``alignasm_tpu_torch/runtime/costmodel.py``) with its own override
``$ALIGNASM_TORCH_COSTMODEL`` and artifact, ``device_routing="auto"``
held to the JAX engine's routing under one shared calibration file, the
per-bucket gate, and the calibration (``runtime/devbench.py``) at a
small size on the plain PyTorch versions.

Module-level imports are the port's only, so the ``gpu`` test runs on a
machine without JAX (``python -m pytest tests/test_torch_routing.py
--noconftest -q -m gpu``); the comparisons with the JAX package import it
inside the test.  Outputs are compared byte for byte.
"""

import ast
import dataclasses
import datetime
import json
import os
from pathlib import Path

import pytest
import torch

from alignasm_tpu_torch import native
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.runtime import costmodel, devbench, scheduler
from alignasm_tpu_torch.runtime.costmodel import DeviceCostModel, load_model
from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch
from alignasm_tpu_torch.testing.synth import _chain_contig, generate_paf

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
SUFFIXES = ("", ".alt", ".all")
ENV = "ALIGNASM_TORCH_COSTMODEL"
JAX_ENV = "ALIGNASM_TPU_COSTMODEL"
# tests/test_routing.py's two calibrations: a 1000 s round trip gates every
# bucket; near-free transport and compute launch every one
GATE_ALL = {"finish_vs_solve": 0.2, "dispatch_rtt_s": 1000.0}
LAUNCH_ALL = {"finish_vs_solve": 0.2, "dispatch_rtt_s": 1e-7,
              "h2d_bytes_per_s": 1e12, "d2h_bytes_per_s": 1e12,
              "device_s_per_contig": 1e-9, "device_s_per_step": 1e-9,
              "solve_s_per_record": 1e-3}
FIELDS = [f.name for f in dataclasses.fields(DeviceCostModel)]


def _outputs(prefix):
    return [Path(f"{prefix}.aln{s}.paf").read_bytes() for s in SUFFIXES]


def _calibrate_with(tmp_path, monkeypatch, cal, jax_too=False):
    """Point the port's override (and the JAX package's with ``jax_too``)
    at one JSON file holding ``cal``."""
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(cal))
    monkeypatch.setenv(ENV, str(path))
    if jax_too:
        monkeypatch.setenv(JAX_ENV, str(path))
    return path


def _port_auto(paf, prefix):
    solve_dataset_torch(None, DEFAULT_CONFIG, src_paths=(str(paf), None),
                        write_prefix=str(prefix), device="cpu")
    return _outputs(prefix), dict(solve_dataset_torch.last_stats)


# --- (a) the copied cost-model tests (tests/test_routing.py:15-170) -------

def test_default_model_routes_nothing():
    """The JAX package's defaults (finish_vs_solve >= 1) route nothing,
    whatever the corpus."""
    m = DeviceCostModel()
    assert not m.any_possible_win()
    assert not m.bucket_profitable(
        n_contigs=10**6, V=64, wire_bytes=1, row_bytes=1,
        sum_records=10**7)


def test_calibrated_model_can_route(tmp_path, monkeypatch):
    """Where the finish is cheaper than the solve it replaces, the model
    routes buckets whose saved work exceeds the transport cost."""
    _calibrate_with(tmp_path, monkeypatch, {
        "finish_vs_solve": 0.2, "dispatch_rtt_s": 2e-5,
        "h2d_bytes_per_s": 8e9, "d2h_bytes_per_s": 8e9})
    m = load_model()
    assert m.any_possible_win()
    assert m.bucket_profitable(n_contigs=4096, V=64, wire_bytes=400_000,
                               row_bytes=270_000, sum_records=70_000)
    assert not m.bucket_profitable(n_contigs=1, V=8, wire_bytes=100,
                                   row_bytes=10, sum_records=4)


def test_model_rejects_unknown_fields(tmp_path, monkeypatch):
    _calibrate_with(tmp_path, monkeypatch,
                    {"finish_vs_solve": 0.5, "typo_field": 1})
    with pytest.raises(ValueError, match="typo_field"):
        load_model()


def test_calibration_artifact_used_when_fresh(tmp_path, monkeypatch):
    """A fresh artifact is read, with dated provenance."""
    monkeypatch.delenv(ENV, raising=False)
    today = datetime.date.today()
    art = tmp_path / "calibration.json"
    art.write_text(json.dumps({
        "finish_vs_solve": 1.11, "dispatch_rtt_s": 0.031,
        "_meta": {"date": today.isoformat(),
                  "stale_after": (today + datetime.timedelta(days=30))
                  .isoformat(),
                  "device_kind": "testkind", "method": "unit"}}))
    monkeypatch.setattr(costmodel, "CALIBRATION_PATH", str(art))
    m, prov = costmodel.load_model_info()
    assert m.finish_vs_solve == 1.11 and m.dispatch_rtt_s == 0.031
    assert prov["source"] == "artifact"
    assert prov["age_days"] == 0
    assert prov["device_kind"] == "testkind"


_FAR = (datetime.date.today() + datetime.timedelta(days=9)).isoformat()


@pytest.mark.parametrize("text,note", [
    (None, "no calibration artifact"),
    (json.dumps({"finish_vs_solve": 0.2,
                 "_meta": {"date": "2026-01-01",
                           "stale_after": "2026-02-01"}}),
     "stale since 2026-02-01"),
    (json.dumps({"finish_vs_solve": 0.2}), "stale_after"),
    ("{torn", "no calibration artifact"),
    (json.dumps({"finish_vs_solve": 0.2, "_meta": "2026-08-20"}),
     "stale_after"),
    (json.dumps({"finish_vs_solve": 0.2, "_meta": {"stale_after": 5}}),
     "unparsable"),
    (json.dumps([1, 2, 3]), "no calibration artifact"),
    (json.dumps({"finish_vs_solve": 0.2, "renamed_field": 1,
                 "_meta": {"stale_after": _FAR}}), "invalid"),
], ids=["absent", "stale", "no-shelf-life", "torn", "meta-not-dict",
        "stale-after-not-str", "root-not-object", "field-drift"])
def test_stale_or_absent_calibration_falls_back(tmp_path, monkeypatch, text,
                                                note):
    """A stale, absent, torn or drifted artifact never steers the gate:
    the defaults apply, with the reason in the provenance."""
    monkeypatch.delenv(ENV, raising=False)
    art = tmp_path / "calibration.json"
    if text is not None:
        art.write_text(text)
    monkeypatch.setattr(costmodel, "CALIBRATION_PATH", str(art))
    m, prov = costmodel.load_model_info()
    assert m == DeviceCostModel()
    assert prov["source"] == "defaults" and note in prov["note"], prov


def test_env_override_beats_artifact(tmp_path, monkeypatch):
    art = tmp_path / "calibration.json"
    art.write_text(json.dumps({"finish_vs_solve": 1.5,
                               "_meta": {"stale_after": _FAR}}))
    monkeypatch.setattr(costmodel, "CALIBRATION_PATH", str(art))
    _calibrate_with(tmp_path, monkeypatch, {"finish_vs_solve": 0.4})
    m, prov = costmodel.load_model_info()
    assert m.finish_vs_solve == 0.4
    assert prov["source"] == "env"


def test_committed_calibration_artifact_is_valid():
    """The committed artifact is the card's: it parses with only known
    fields, holds every field, is dated with a shelf life, and names the
    CUDA device and its power limit."""
    raw = json.loads(Path(costmodel.CALIBRATION_PATH).read_text())
    model, _ = costmodel._parse_model(raw, "artifact",
                                      costmodel.CALIBRATION_PATH)
    assert set(raw) == set(FIELDS) | {"_meta"}
    assert model.dispatch_rtt_s > 0
    meta = raw["_meta"]
    assert meta["date"] and meta["stale_after"]
    assert meta["device_kind"] not in ("", "cpu")
    assert meta["power_limit"].endswith(" W"), meta["power_limit"]


def test_costmodel_copy_matches_original():
    """The copy is the JAX package's module but the listed edits: every
    function and the dataclass's methods and fields are the original's,
    docstrings apart, with the override's name the port's."""
    def defs(path, env):
        text = path.read_text().replace("ALIGNASM_TPU_COSTMODEL", env)
        out = {}
        for node in ast.parse(text).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                for n in ast.walk(node):
                    body = getattr(n, "body", None)
                    if isinstance(body, list) and body and isinstance(
                            body[0], ast.Expr) and isinstance(
                            getattr(body[0], "value", None), ast.Constant):
                        n.body = body[1:]
                out[node.name] = ast.dump(node)
        return out

    orig = defs(REPO / "alignasm_tpu" / "runtime" / "costmodel.py", ENV)
    copy = defs(REPO / "alignasm_tpu_torch" / "runtime" / "costmodel.py", ENV)
    assert orig == copy


# --- (b) held against the JAX engine under one calibration file ----------

@pytest.mark.parametrize("regime", ["defaults", "gate_all", "launch_all"])
def test_auto_routing_matches_jax_engine(tmp_path, monkeypatch, regime):
    """Under one calibration file for both packages, ``"auto"`` writes
    the goldens' bytes in both and routes alike: the same ``routing``,
    ``routed``, ``device_routed_frac`` and ``cost_model`` (its calibration
    path apart); every contig gated alike under the gate-everything model;
    the same device and fallback counts under the launch-everything
    model."""
    from alignasm_tpu.config import DEFAULT_CONFIG as JCFG
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    cal = {"defaults": {}, "gate_all": GATE_ALL,
           "launch_all": LAUNCH_ALL}[regime]
    _calibrate_with(tmp_path, monkeypatch, cal, jax_too=True)
    paf = DATA / "synth50.paf"
    got, stats = _port_auto(paf, tmp_path / "port")
    solve_dataset_tpu(None, JCFG, src_paths=(str(paf), None),
                      write_prefix=str(tmp_path / "jax"))
    jstats = solve_dataset_tpu.last_stats
    assert got == _outputs(tmp_path / "jax") == _outputs(DATA / "synth50")
    for key in ("routing", "routed", "device_routed_frac"):
        assert stats.get(key) == jstats.get(key), key

    def no_path(cm):
        return {**cm, "calibration": {k: v for k, v in cm["calibration"]
                                      .items() if k != "path"}}

    assert no_path(stats["cost_model"]) == no_path(jstats["cost_model"])
    assert stats["cost_model"]["calibration"]["source"] == "env"
    assert stats["routing"] == "auto"
    if regime == "defaults":
        assert stats["routed"] == "fused-native"
        assert not stats["cost_model"]["any_possible_win"]
    elif regime == "gate_all":
        assert stats["device"] == 0 and stats["buckets_gated"] >= 1
        assert stats["contigs_gated"] == jstats["contigs_gated"] > 0
    else:
        assert "buckets_gated" not in stats and stats["device"] > 0
        for key in ("device", "fallback"):
            assert stats[key] == jstats[key], key


def _mixed_corpus(tmp_path):
    """40 small contigs (one V = 64 bucket) and a chain of 600 segments
    (V = 1024): two buckets of the port, which the merge keeps apart."""
    paf = tmp_path / "mixed.paf"
    paf.write_text(generate_paf(n_contigs=40, seed=31)
                   + _chain_contig(600, seed=11))
    return paf


def _port_buckets(paf):
    """The port's device buckets of ``paf`` and its meta, as
    ``_device_assist`` forms them."""
    import numpy as np

    cfg = DEFAULT_CONFIG
    with native.GraphExporter(
            str(paf), config=cfg,
            max_records=max(cfg.max_device_records,
                            scheduler._device_cap(cfg))) as ex:
        meta = ex.meta_bulk()
    idx = np.where(scheduler._eligible_mask(meta, cfg))[0]
    n_v = meta[:, 2]
    order = idx[np.argsort(n_v[idx], kind="stable")]
    return scheduler._dense_buckets(order, n_v), meta


def _margins(buckets, meta, model):
    """Per bucket: the native solve's predicted time less the device
    route's with a zero round trip; a bucket wins where it exceeds the
    model's round trip."""
    n_rec, n_edges = meta[:, 1], meta[:, 3]
    out = []
    for V, idxs in buckets:
        args = (len(idxs), int(V), int(n_edges[idxs].sum()) * 8 + 64,
                len(idxs) * (V + 2), int(n_rec[idxs].sum()))
        out.append(model.predict_native_s(args[4], args[0])
                   - model.predict_device_s(*args))
    return out


def test_mixed_model_gates_exactly_the_unprofitable_buckets(tmp_path,
                                                            monkeypatch):
    """A round trip between the two buckets' margins: the bucket that
    cannot pay it is gated (its contigs solve natively), the other is
    launched, exactly as ``bucket_profitable`` says; the files stay
    byte-equal to native.run's."""
    paf = _mixed_corpus(tmp_path)
    buckets, meta = _port_buckets(paf)
    assert len(buckets) == 2, [V for V, _ in buckets]
    base = {**LAUNCH_ALL, "dispatch_rtt_s": 0.0}
    margins = _margins(buckets, meta, DeviceCostModel(**base))
    assert margins[0] != margins[1] and min(margins) > 0
    cal = {**base, "dispatch_rtt_s": sum(margins) / 2}
    _calibrate_with(tmp_path, monkeypatch, cal)
    model = DeviceCostModel(**cal)
    n_rec, n_edges = meta[:, 1], meta[:, 3]
    profitable = [model.bucket_profitable(
        len(i), int(V), int(n_edges[i].sum()) * 8 + 64, len(i) * (V + 2),
        int(n_rec[i].sum())) for V, i in buckets]
    assert sorted(profitable) == [False, True]

    got, stats = _port_auto(paf, tmp_path / "port")
    native.run(str(paf), out_prefix=str(tmp_path / "native"),
               config=DEFAULT_CONFIG)
    assert got == _outputs(tmp_path / "native")
    gated = [b for b, p in zip(buckets, profitable) if not p]
    kept = [b for b, p in zip(buckets, profitable) if p]
    assert stats["buckets_gated"] == len(gated)
    assert stats["contigs_gated"] == sum(len(i) for _V, i in gated)
    assert stats["bucket_vs"] == [int(V) for V, _i in kept]
    assert stats["device"] + stats["fallback"] == sum(len(i) for _V, i in kept)


def test_auto_in_memory_results_match_exact_engine(tmp_path, monkeypatch):
    """Without output files, ``"auto"`` under a model with no win solves
    every contig on the exporter's native plane, results equal to the
    exact engine's."""
    from alignasm_tpu_torch.engine.exact import solve_dataset
    from alignasm_tpu_torch.io.paf import read_paf

    _calibrate_with(tmp_path, monkeypatch, {})
    paf = DATA / "synth_hard.paf"
    got = solve_dataset_torch(None, DEFAULT_CONFIG, src_paths=(str(paf), None),
                              device="cpu")
    stats = solve_dataset_torch.last_stats
    assert stats["routed"] == "native-plane" and stats["device"] == 0
    assert stats["cost_model"]["calibration"]["source"] == "env"
    assert got == solve_dataset(read_paf(paf), DEFAULT_CONFIG)


# --- (c) the port's own override and artifact -----------------------------

def test_jax_env_var_does_not_steer_the_port(tmp_path, monkeypatch):
    """Only ``$ALIGNASM_TORCH_COSTMODEL`` overrides the port: the JAX
    package's variable leaves it on its own artifact or the defaults, and
    its artifact lies under alignasm_tpu_torch/."""
    monkeypatch.delenv(ENV, raising=False)
    bad = tmp_path / "jax.json"
    bad.write_text(json.dumps({"finish_vs_solve": 0.01}))
    monkeypatch.setenv(JAX_ENV, str(bad))
    m, prov = costmodel.load_model_info()
    assert prov["source"] in ("artifact", "defaults")
    assert m.finish_vs_solve != 0.01
    cal = Path(costmodel.CALIBRATION_PATH).resolve()
    assert cal == REPO / "alignasm_tpu_torch" / "runtime" / "calibration.json"
    if prov["source"] == "artifact":
        assert Path(prov["path"]).resolve() == cal


def test_device_route_guard_applies_only_to_device_routes(tmp_path,
                                                          monkeypatch):
    """``device_max_v`` over 16384 raises only when the routing would
    send contigs to the device: under a model with no win, ``"auto"``
    runs the fused native plane."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_max_v=32768)
    paf = DATA / "synth_small.paf"
    _calibrate_with(tmp_path, monkeypatch, {})
    solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                        write_prefix=str(tmp_path / "a"), device="cpu")
    assert solve_dataset_torch.last_stats["routed"] == "fused-native"
    _calibrate_with(tmp_path, monkeypatch, LAUNCH_ALL)
    with pytest.raises(NotImplementedError, match="16384"):
        solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                            write_prefix=str(tmp_path / "b"), device="cpu")


# --- (d) the calibration, small, on the plain versions -------------------

SMALL = dict(n_contigs=60, scan_shape=(8, 16), bigv_v=128,
             h2d_cells=1 << 10, d2h_bytes=1 << 10)


def test_calibrate_on_cpu_writes_a_valid_artifact(tmp_path, monkeypatch):
    """``calibrate(device="cpu")`` at a small size gives every model
    field and a ``_meta`` that ``_parse_model`` accepts; ``main`` writes
    it atomically to ``--out``."""
    cal = devbench.calibrate(device="cpu", **SMALL)
    assert set(cal) == set(FIELDS) | {"_meta"}
    model, prov = costmodel._parse_model(cal, "artifact", "x")
    assert all(getattr(model, f) > 0 for f in FIELDS)
    meta = cal["_meta"]
    assert meta["device_kind"] == prov["device_kind"] == "cpu"
    assert meta["power_limit"] == "not measured"
    assert meta["n_contigs"] == SMALL["n_contigs"]
    assert meta["details"]["amdahl_contigs"] > 0
    assert costmodel._is_stale(cal) is None

    monkeypatch.setattr(devbench, "calibrate", lambda n_contigs: cal)
    out = tmp_path / "cal.json"
    assert devbench.main(["--calibrate", "--out", str(out), "60"]) == 0
    assert json.loads(out.read_text()) == cal
    assert not os.path.exists(str(out) + ".tmp")
    assert devbench.main(["--no-such-flag"]) == 2


def test_calibrate_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        devbench.calibrate(device="cuda", **SMALL)


# --- (g) on the card ------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_auto_near_free_transport_launches_every_bucket_on_the_card(
        tmp_path, monkeypatch, cuda_device):
    """``"auto"`` under the launch-everything model on the card: no bucket
    is gated, the scan and the blocked solve run, and the files are
    byte-equal to native.run's."""
    from alignasm_tpu_torch.ops import launch_counts, reset_launch_counts

    paf = _mixed_corpus(tmp_path)
    _calibrate_with(tmp_path, monkeypatch, LAUNCH_ALL)
    reset_launch_counts()
    solve_dataset_torch(None, DEFAULT_CONFIG, src_paths=(str(paf), None),
                        write_prefix=str(tmp_path / "port"),
                        device=cuda_device)
    counts = launch_counts()
    stats = solve_dataset_torch.last_stats
    native.run(str(paf), out_prefix=str(tmp_path / "native"),
               config=DEFAULT_CONFIG)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")
    assert "buckets_gated" not in stats and "device_error" not in stats
    assert stats["device"] > 0
    assert counts["topo_scan"] >= 1 and counts["blocked_dp"] >= 1, counts
