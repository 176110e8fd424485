"""The port's densify and reverse-topo scan (alignasm_tpu_torch/ops) against
the JAX package's functions on the same inputs.

Inputs are exporter wires from synthetic corpora and random topo-ordered
DAG wires made with numpy from a seed; both frameworks get the same
arrays.  Everything is integer, so the tolerance is bit-equality.  The
CUDA kernels are compared with their plain versions in
tests/test_torch_kernels.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from alignasm_tpu import native
from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.ops import dense as jdense
from alignasm_tpu.testing.synth import generate_hard_paf, generate_paf
from alignasm_tpu_torch.ops import dense as tdense
from alignasm_tpu_torch.ops.wire import ragged_to_device, wire16_to_device
from tests.test_torch_kernels import (
    _inf_sum_slabs, _ragged_to_wire16, _rand_wire,
)


def _np(t):
    return t.cpu().numpy()


def _jax_rows_ragged(wire, B, V):
    return np.asarray(jdense.dense_solve_wire_topo_nxt8_ragged(wire, B=B, V=V))


def _torch_rows_ragged(wire, B, V):
    return _np(tdense.dense_solve_wire_topo_nxt8_ragged(
        ragged_to_device(wire, "cpu"), B, V))


def test_constants_match_jax():
    assert tdense.INF32 == int(jdense.INF32)
    assert tdense.COUNT_SAT == int(jdense.COUNT_SAT)
    assert tdense.ANOM_SHIFT == jdense.ANOM_SHIFT


@functools.lru_cache(maxsize=None)
def _corpus(name):
    if name == "hard":
        return generate_hard_paf(n_contigs=10, seed=17)
    return generate_paf(n_contigs=40, seed=9, max_records_per_contig=180)


def _exporter_bucket(tmp_path, text, lo, hi):
    """Contig indices whose vertex count lies in (lo, hi], the bucket's V,
    and an open exporter over ``text``."""
    p = tmp_path / "w.paf"
    p.write_text(text)
    exp = native.GraphExporter(str(p), config=DEFAULT_CONFIG)
    meta = exp.meta_bulk()
    n_v = meta[:, 2]
    idx = np.where((meta[:, 0] == 1) & (meta[:, 1] >= 2) & (n_v > lo)
                   & (n_v <= hi) & (meta[:, 6] < 2**27))[0]
    assert len(idx) >= 3
    V = max(8, 1 << int(n_v[idx].max() - 1).bit_length())
    return exp, idx, meta[idx, 3], V


@pytest.mark.parametrize("corpus,lo,hi", [
    ("hard", 0, 128),    # generate_hard_paf: the 16-bit wire
    ("long", 64, 128),   # long contigs, V = 128: both wires
    ("long", 128, 256),  # long contigs, V = 256: the ragged wire
])
def test_densify_and_rows_match_jax_on_exporter_wires(tmp_path, corpus, lo, hi):
    """Plain densify of both wires and both entry points' rows equal the
    JAX functions' on exporter wires, with padding rows (padB > B) and a
    contig the exporter rejects (an edge count that lies)."""
    exp, idx, n_edges, V = _exporter_bucket(tmp_path, _corpus(corpus), lo, hi)
    try:
        padB = (1 << (len(idx) - 1).bit_length()) * 2  # force padding rows
        bad = n_edges.copy()
        bad[1] += 1
        for edges in (n_edges, bad):
            rag, ok, _cap = exp.export_wire_ragged(idx, V, edges, padB)
            assert ok.all() == (edges is n_edges)
            want = np.asarray(jdense._densify_wire_ragged(rag, padB, V))
            got = _np(tdense.densify_wire_ragged(
                ragged_to_device(rag, "cpu"), padB, V))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(_torch_rows_ragged(rag, padB, V),
                                          _jax_rows_ragged(rag, padB, V))
            w16 = exp.export_wire16(idx, V, edges, padB)
            if V > 128:
                assert w16 is None
                continue
            assert w16 is not None
            np.testing.assert_array_equal(w16[5], ok)
            deltas, vidx, table, n_real, seeds, _ok = w16
            args = wire16_to_device(w16, "cpu")
            want16 = np.asarray(jdense._densify_wire16(
                deltas, vidx, table, seeds, n_real, padB, V))
            np.testing.assert_array_equal(
                _np(tdense.densify_wire16(*args, padB, V)), want16)
            np.testing.assert_array_equal(want16, want)
            rows = _np(tdense.dense_solve_wire16_topo_nxt8(*args, B=padB, V=V))
            want_rows = np.asarray(jdense.dense_solve_wire16_topo_nxt8(
                deltas, vidx, table, seeds, n_real, B=padB, V=V))
            np.testing.assert_array_equal(rows, want_rows)
    finally:
        exp.close()


def _scan_vectors_match_jax(slabs, V):
    (s, a, fa, ct, cm, nxt), dest, src = jax.jit(jax.vmap(
        lambda x: jdense._topo_scan(x, V)))(slabs)
    got, gdest, gsrc = tdense.topo_scan(torch.from_numpy(slabs))
    for g, want in zip(got, (s, a, fa, ct, cm, nxt)):
        np.testing.assert_array_equal(_np(g), np.asarray(want))
    np.testing.assert_array_equal(_np(gdest), np.asarray(dest))
    np.testing.assert_array_equal(_np(gsrc), np.asarray(src))


def test_topo_scan_vectors_match_jax():
    """All six DP vectors of the plain scan, not just the shipped row."""
    V, B = 64, 4
    w = _rand_wire(B, V, 0.1, 5, nv=50)
    _scan_vectors_match_jax(
        np.array(jdense._densify_wire_ragged(w, B, V)), V)


def test_topo_scan_vectors_match_jax_where_a_sum_is_exactly_inf32():
    """The six vectors where an edge into a reachable column sums to INF32
    exactly: the int32 literalness of ``_topo_scan``'s ``ach``."""
    _scan_vectors_match_jax(_inf_sum_slabs(5, 16), 16)


@pytest.mark.parametrize("V,density,seed,nv", [
    (64, 0.0005, 0, None),   # mostly unreachable
    (64, 0.05, 1, 40),       # padding past nv (dest mid-slab)
    (64, 0.9, 2, None),      # near-complete DAG: deep tie sets, saturation
    (128, 0.0005, 3, 70),
    (128, 0.05, 4, None),
    (128, 0.9, 5, 100),
    (256, 0.0005, 6, None),
    (256, 0.05, 7, 150),
    (256, 0.9, 8, None),
])
def test_entry_points_match_jax_on_random_dags(V, density, seed, nv):
    B = 3
    w = _rand_wire(B, V, density, seed, nv)
    want = _jax_rows_ragged(w, B, V)
    np.testing.assert_array_equal(_torch_rows_ragged(w, B, V), want)
    if V <= 128:
        w16 = _ragged_to_wire16(w, B, V)
        rows = tdense.dense_solve_wire16_topo_nxt8(
            *wire16_to_device(w16, "cpu"), B=B, V=V)
        np.testing.assert_array_equal(_np(rows), want)


def test_entry_point_matches_pallas_twin():
    """The Pallas kernel the CUDA scan replaces (interpret mode), B=16, V=64."""
    from alignasm_tpu.ops.pallas_topo import dense_solve_wire_topo_nxt8_pallas
    from tests.test_pallas_topo import _random_wire

    B, V = 16, 64
    wire = _random_wire(B, V, 2 * V, 0)  # (B, 2, W), per-contig cells
    want = np.asarray(
        dense_solve_wire_topo_nxt8_pallas(wire, V=V, interpret=True))
    M = V * (V + 1)
    cells = wire[:, 0].astype(np.int64)
    glob = np.where(cells < M, cells + np.arange(B)[:, None] * M, B * M)
    rag = np.stack([glob.reshape(-1), wire[:, 1].reshape(-1)]).astype(np.int32)
    np.testing.assert_array_equal(_torch_rows_ragged(rag, B, V), want)
