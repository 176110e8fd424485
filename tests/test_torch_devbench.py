"""The port's device bench (``alignasm_tpu_torch/runtime/devbench.py``:
the end-to-end, kernel and big-V sections and the streaming ``main``)
and its bounds (``runtime/roofline.py``) on the CPU, at small sizes,
held to the JAX package's ``alignasm_tpu/runtime/devbench.py``: the same
random buckets and wires, and rows bit-equal to the JAX functions the
sections stand for.  On the CPU every section runs the plain versions; a
CUDA request without a card raises.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignasm_tpu import native
from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.ops import dense as jdense
from alignasm_tpu.ops.relax32 import sp_batch32 as jsp_batch32
from alignasm_tpu.runtime import devbench as jdevbench
from alignasm_tpu.testing.synth import generate_paf
from alignasm_tpu_torch.ops import dense
from alignasm_tpu_torch.ops import relax32
from alignasm_tpu_torch.runtime import devbench, roofline


def _spy(monkeypatch, module, name):
    """Record every call of ``module.name``: a list of (args, result)."""
    real = getattr(module, name)
    calls = []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, spy)
    return calls


def _jax_kernel_bucket(B, V, E, seed):
    """The JAX bench's bucket, as ``alignasm_tpu/runtime/devbench.py``
    builds it inside ``bench_kernels`` (:258-281, then :419-422)."""
    rng = np.random.default_rng(seed)
    mask = np.triu(rng.random((B, V, V)) < 0.08, k=1)
    ws = rng.integers(1, 1000, (B, V, V)).astype(np.int32)
    wa = rng.integers(0, 2, (B, V, V)).astype(np.int32)
    E2 = int(mask.sum(axis=(1, 2)).max()) + 3
    wire = np.empty((B, 2, E2), np.int32)
    wire[:, 0] = V * (V + 1)
    wire[:, 1] = 0
    for b in range(B):
        us, vs = np.nonzero(mask[b])
        k = len(us)
        wire[b, 0, :k] = (us * V + vs).astype(np.int32)
        wire[b, 1, :k] = ws[b, us, vs] | (wa[b, us, vs] << jdense.ANOM_SHIFT)
        wire[b, 0, k] = V * V
        wire[b, 1, k] = V - 1
        wire[b, 0, k + 1] = V * V + 1
        wire[b, 1, k + 1] = 0
    eu = np.sort(rng.integers(0, V - 1, (B, E)), axis=1).astype(np.int32)
    ev = (eu + 1 + rng.integers(0, 4, (B, E)) % (V - 1 - eu)).astype(np.int32)
    es = rng.integers(1, 1000, (B, E)).astype(np.int32)
    ea = rng.integers(0, 2, (B, E)).astype(np.int32)
    return dict(mask=mask, ws=ws, wa=wa, wire=wire, eu=eu, ev=ev, es=es,
                ea=ea)


@pytest.mark.parametrize("B,V,E,seed", [(8, 16, 32, 0), (256, 64, 256, 0),
                                        (4, 32, 64, 7)])
def test_kernel_bucket_equals_jax_construction(B, V, E, seed):
    got = devbench._kernel_bucket(B, V, E, seed)
    want = _jax_kernel_bucket(B, V, E, seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


def test_forward_hint_is_topological():
    """The dense and sparse sections' hint puts every edge's tail before
    its head: the kernels' check (a) passes on it."""
    bk = devbench._kernel_bucket(16, 32, 64, 3)
    for order, targets, tails in (
            (devbench._forward_hint(bk["ev"], 32), bk["ev"], bk["eu"]),
            (devbench._forward_hint([np.nonzero(m)[1] for m in bk["mask"]],
                                    32),
             [np.nonzero(m)[1] for m in bk["mask"]],
             [np.nonzero(m)[0] for m in bk["mask"]])):
        assert order.shape == (16, 32) and order.dtype == np.int32
        for row, v, u in zip(order, targets, tails):
            pos = np.empty(32, np.int64)
            pos[row] = np.arange(32)
            assert sorted(row) == list(range(32))
            assert (pos[u] < pos[v]).all()


def test_bench_kernels_rows_equal_jax(monkeypatch):
    """``bench_kernels`` on the CPU: the topo rows equal the JAX
    ``dense_solve_wire_topo_nxt8``'s, the sparse rows the JAX
    ``sp_batch32``'s and the dense rows the JAX ``dense_solve_batch``'s
    (n_sweeps 4 < V: truncated Jacobi, as the JAX section), bit for bit;
    every section held to its plain version."""
    B, V, E, ns = 8, 16, 32, 4
    topo = _spy(monkeypatch, dense, "dense_solve_wire_topo_nxt8")
    dns = _spy(monkeypatch, dense, "dense_solve_batch")
    sp = _spy(monkeypatch, relax32, "sp_batch32")
    out = devbench.bench_kernels(B=B, V=V, E=E, n_sweeps=ns, device="cpu")
    bk = _jax_kernel_bucket(B, V, E, 0)

    rows = [o for a, o in topo if a[0].shape[0] == B][0]
    want = np.asarray(jdense.dense_solve_wire_topo_nxt8(jnp.asarray(bk["wire"]),
                                                        V=V))
    assert rows.dtype == torch.uint8
    np.testing.assert_array_equal(rows.numpy(), want)

    ws = np.where(bk["mask"], bk["ws"], jdense.INF32).astype(np.int32)
    wa = np.where(bk["mask"], bk["wa"], 0).astype(np.int32)
    dest = np.full(B, V - 1, np.int32)
    want = np.asarray(jdense.dense_solve_batch(ws, wa, dest, ns))
    for args, got in dns:
        np.testing.assert_array_equal(args[0].numpy(), ws)
        np.testing.assert_array_equal(got.numpy(), want)

    want = np.asarray(jsp_batch32(bk["eu"], bk["ev"], bk["es"], bk["ea"],
                                  np.ones((B, E), bool), np.zeros(B, np.int32),
                                  dest, V=V, n_sweeps=ns))
    assert sp
    for _args, got in sp:
        np.testing.assert_array_equal(got.numpy(), want)

    assert set(out) == {"topo", "dense", "sparse"}
    for name, sec in out.items():
        assert sec["plain"]["bit_equal"] is True, name
        assert sec["device_kind"] == "cpu"
        assert sec["power_limit"] == "not measured"
        assert sec["pct_of_mem_peak"] is None
        assert sec["bound_ms"] > 0 and sec["x_bound"] > 0
        assert sec["launches"] == {}
    assert out["topo"]["chained_B"] == 8 * B
    assert ("marginal_s_per_contig" in out["topo"]) != (
        "marginal_note" in out["topo"])
    assert out["dense"]["kernel"] == "sweep_dense"
    assert out["dense"]["jacobi"] is None and out["sparse"]["jacobi"] is None
    json.dumps(out)


@pytest.mark.parametrize("V,B", [(512, 2), (256, 3)])
def test_bigv_wires_equal_jax(V, B):
    np.testing.assert_array_equal(devbench._bigv_wire(V, 0),
                                  jdevbench._bigv_wire(V, 0))
    got = devbench._batched_bigv_wire(V, B, 0)
    want = jdevbench._batched_bigv_wire(V, B, 0)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_bench_bigv_rows_equal_jax(monkeypatch):
    """``bench_bigv(V=512)`` on the CPU: the blocked rows at B = 1 and at
    B = 8 equal the JAX ``dense_solve_wire_topo_nxt16_blocked_ragged``'s at
    Bk = 64 (the scheduler's), and the plain scan's."""
    V = 512
    calls = _spy(monkeypatch, dense,
                 "dense_solve_wire_topo_nxt16_blocked_ragged")
    out = devbench.bench_bigv(V=V, n_chain=1, reps=1, device="cpu")
    assert out["Bk"] == 64 and out["V"] == V
    for B in (1, 8):
        got = [o for a, o in calls if a[1] == B][0]
        want = np.asarray(jdense.dense_solve_wire_topo_nxt16_blocked_ragged(
            jnp.asarray(jdevbench._batched_bigv_wire(V, B, 0)), B=B, V=V,
            Bk=64))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)
    assert out["bit_equal"] is True and out["batched"]["bit_equal"] is True
    assert out["batched"]["B"] == 8
    assert out["blocked_pct_of_mem_peak"] is None
    assert out["bound_ms"] > 0 and out["batched"]["bound_ms"] > 0
    json.dumps(out)


def test_bench_bigv_sweep_rows_bit_equal(capsys):
    """A two-V, two-B, two-Bk sweep: every row bit-equal to the plain
    scan's rows of its V, each streamed as its own line."""
    out = devbench.bench_bigv_sweep(Vs=(256, 512), Bks=(32, 64), Bs=(1, 2),
                                    n_chain=1, reps=1, device="cpu")
    rows = out["rows"]
    assert [(r["V"], r["B"], r["Bk"]) for r in rows] == [
        (V, B, Bk) for V in (256, 512) for B in (1, 2) for Bk in (32, 64)]
    assert all(r["bit_equal"] is True for r in rows)
    assert all(r["warm_compile_s"] > 0 and r["s_per_launch"] > 0
               for r in rows)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["bigv_sweep_row"] for ln in lines] == rows


def test_bench_end_to_end_matches_jax_engine(tmp_path):
    """``bench_end_to_end(40, reps=1)`` on the CPU: the forced run's counts
    equal the JAX engine's forced run on the same corpus, both
    configurations' files equal ``native.run``'s, the JAX keys with
    ``tpu_`` read as ``cuda_``."""
    import dataclasses

    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    out = devbench.bench_end_to_end(40, reps=1, device="cpu")
    assert out["files_byte_equal_native"] is True
    assert out["reps_done"] == 1
    assert {"cuda_engine_contigs_per_s", "cuda_engine_stats",
            "cuda_engine_forced_contigs_per_s", "cuda_engine_forced_stats",
            "native_inproc_contigs_per_s", "cuda_vs_native_inproc"} <= set(out)
    assert out["cuda_engine_stats"]["routing"] == "auto"
    paf = tmp_path / "bench_tpu.paf"
    paf.write_text(generate_paf(n_contigs=40, seed=2024,
                                max_records_per_contig=24))
    forced = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    solve_dataset_tpu(None, forced, src_paths=(str(paf), None),
                      write_prefix=str(tmp_path / "jax"))
    jstats = solve_dataset_tpu.last_stats
    stats = out["cuda_engine_forced_stats"]
    assert stats["device"] > 0
    for key in ("device", "fallback", "native_direct", "singleton"):
        assert stats[key] == jstats[key], (key, stats, jstats)
    native.run(str(paf), out_prefix=str(tmp_path / "native"))
    for s in ("", ".alt", ".all"):
        assert (tmp_path / f"jax.aln{s}.paf").read_bytes() == \
            (tmp_path / f"native.aln{s}.paf").read_bytes()
    json.dumps(out)


def test_bench_end_to_end_deadline_before_first_rep():
    """A deadline already past when the warm passes end: the JAX shape,
    the warm passes' stats and no timed rep."""
    out = devbench.bench_end_to_end(12, reps=3, t_end=time.monotonic() - 1,
                                    device="cpu")
    assert out["reps_done"] == 0
    assert out["cuda_engine_contigs_per_s"] is None
    assert out["note"] == "deadline hit after warm pass; no timed rep"
    assert out["cuda_engine_forced_stats"]["device"] > 0
    assert out["files_byte_equal_native"] is True


def _fake_sections(monkeypatch, kernels=None, e2e_sleep=0.0):
    seen = {}

    def e2e(n, t_end=None):
        seen["n"], seen["t_end"] = n, t_end
        time.sleep(e2e_sleep)
        return {"cuda_engine_contigs_per_s": 1.5, "reps_done": 5}

    monkeypatch.setattr(devbench, "bench_end_to_end", e2e)
    monkeypatch.setattr(devbench, "bench_kernels",
                        kernels or (lambda: {"topo": {"bit_equal": True}}))
    monkeypatch.setattr(devbench, "bench_bigv", lambda: {"V": 8192})
    return seen


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_main_streams_one_line_per_section(monkeypatch, capsys):
    monkeypatch.delenv(devbench.DEADLINE_ENV, raising=False)
    seen = _fake_sections(monkeypatch)
    assert devbench.main(["60"]) == 0
    assert seen == {"n": 60, "t_end": None}
    e2e, kernels, bigv, trailer, merged = _lines(capsys)
    assert e2e == {"cuda_engine_contigs_per_s": 1.5, "reps_done": 5}
    assert kernels == {"kernels": {"topo": {"bit_equal": True}}}
    assert bigv == {"kernels": {"bigv": {"V": 8192}}}
    assert trailer == {"sections_skipped": []}
    assert merged == {"cuda_engine_contigs_per_s": 1.5, "reps_done": 5,
                      "kernels": {"topo": {"bit_equal": True},
                                  "bigv": {"V": 8192}},
                      "sections_skipped": []}


def test_main_failed_section_returns_1(monkeypatch, capsys):
    """A section that raises is recorded on its line, the later sections
    still run, and main returns 1."""
    monkeypatch.delenv(devbench.DEADLINE_ENV, raising=False)

    def broken():
        raise RuntimeError("kernel launch failed")

    _fake_sections(monkeypatch, kernels=broken)
    assert devbench.main([]) == 1
    e2e, kernels, bigv, trailer, merged = _lines(capsys)
    assert kernels == {"kernels_error":
                       "RuntimeError('kernel launch failed')"}
    assert bigv == {"kernels": {"bigv": {"V": 8192}}}
    assert merged["kernels_error"] == kernels["kernels_error"]
    assert trailer == {"sections_skipped": []}


def test_main_honors_the_deadline(monkeypatch, capsys):
    monkeypatch.setenv(devbench.DEADLINE_ENV, "0.2")
    t0 = time.monotonic()
    seen = _fake_sections(monkeypatch, e2e_sleep=0.3)
    assert devbench.main(["100"]) == 0
    assert t0 < seen["t_end"] < t0 + 0.2  # 0.6 of the window
    e2e, trailer, merged = _lines(capsys)
    assert trailer == {"sections_skipped": ["kernels", "bigv"],
                       "deadline_s": 0.2}
    assert merged["sections_skipped"] == ["kernels", "bigv"]
    assert "kernels" not in merged


@pytest.mark.parametrize("argv", [["--no-such-flag"], ["12", "13"], ["x"],
                                  ["--bigv-sweep", "3"]])
def test_main_unknown_arguments_return_2(monkeypatch, argv):
    _fake_sections(monkeypatch)
    assert devbench.main(argv) == 2


def test_main_bigv_sweep(monkeypatch, capsys):
    monkeypatch.setattr(devbench, "bench_bigv_sweep",
                        lambda: {"rows": [{"V": 2048}]})
    assert devbench.main(["--bigv-sweep"]) == 0
    assert _lines(capsys) == [{"rows": [{"V": 2048}]}]


def test_devbench_deep_merge():
    """Mirror of tests/test_runtime.py:test_devbench_deep_merge on the
    port's helper: nested dicts merge, scalars overwrite, unrelated keys
    survive."""
    d = {"kernels": {"topo": {"a": 1}}, "x": 1}
    devbench._deep_merge(d, {"kernels": {"bigv": {"b": 2}}, "y": 3})
    devbench._deep_merge(d, {"kernels": {"topo": {"a": 9, "c": 4}}, "x": 2})
    assert d == {"kernels": {"topo": {"a": 9, "c": 4}, "bigv": {"b": 2}},
                 "x": 2, "y": 3}


@pytest.mark.parametrize("call", [
    lambda: devbench.bench_end_to_end(10, reps=1),
    lambda: devbench.bench_kernels(B=2, V=16, E=8, n_sweeps=4),
    lambda: devbench.bench_bigv(V=256),
    lambda: devbench.bench_bigv_sweep(Vs=(256,), Bs=(1,), Bks=(64,)),
], ids=["end_to_end", "kernels", "bigv", "bigv_sweep"])
def test_cuda_request_without_a_card_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12), ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None)])
def test_mem_peak_by_card_name(kind, peak):
    assert roofline.mem_peak(kind) == peak


def test_bound_sums_each_kernels_larger_time():
    """A path's bound is the sum of each kernel's larger time; bytes bound
    a densify, operations may bound a solve."""
    slabs = torch.full((2, 9, 8), dense.INF32, dtype=torch.int32)
    slabs[:, 8, 0] = 7
    rows = torch.zeros((2, 10), dtype=torch.uint8)
    assert roofline.dp_cells(slabs) == 2 * 8 * 7 // 2
    assert roofline.dp_bytes(slabs, rows) == 4 * (56 + 4) + 20
    nb, nops = roofline.scan_work(slabs, rows)
    assert nops == 56 * roofline.SCAN_OPS
    by_b, by_o = roofline.bound_ms(nb, nops)
    assert by_b == pytest.approx(1e3 * nb / roofline.MEM_BYTES_PER_S)
    assert by_o == pytest.approx(1e3 * nops / roofline.OPS_PER_S)
    got = roofline.bound((10**9, 0), (0, 10**12))
    assert got["bound_ms"] == pytest.approx(
        1e3 * (1e9 / roofline.MEM_BYTES_PER_S + 1e12 / roofline.OPS_PER_S))
    assert got["bound_by"] == "operations"
    assert roofline.bound((10**9, 0))["bound_by"] == "bytes"
