"""The port's blocked tropical solve (alignasm_tpu_torch/ops/dense.py:
blocked_dp and dense_solve_wire_topo_nxt16_blocked_ragged) against the JAX
package's on the same inputs, on the CPU.

Inputs are random topo-ordered DAG wires made with numpy from a seed (the
grid of tests/test_dense.py::test_blocked_matches_scan) and exporter wires
of real big-V buckets; both frameworks get the same arrays.  Everything
is integer, so the tolerance is bit-equality.  The CUDA kernel is compared
with the plain version in tests/test_torch_kernels.py.
"""

import functools
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from alignasm_tpu import native
from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.ops import dense as jdense
from alignasm_tpu.testing.synth import generate_paf
from alignasm_tpu_torch.ops import cuda_blocked
from alignasm_tpu_torch.ops import dense as tdense
from alignasm_tpu_torch.ops.wire import ragged_to_device
from alignasm_tpu_torch.runtime import scheduler
from tests.test_torch_kernels import _rand_wire


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("V,Bk,density,seed,nv", [
    (256, 64, 0.08, 42, 200),   # test_dense.py::test_blocked_dp_vectors_match_scan
    (512, 32, 0.05, 7, 300),    # dest mid-slab, below later blocks
    (128, 32, 0.0005, 3, None),  # mostly unreachable
    (256, 128, 0.9, 10, None),  # near-complete: deep tie sets, saturation
])
def test_blocked_dp_vectors_match_jax(V, Bk, density, seed, nv):
    """All six vectors of the plain blocked solve, counts included (both
    saturate at 2), not just the shipped row."""
    B = 2
    slabs = np.array(jdense._densify_wire_ragged(
        _rand_wire(B, V, density, seed, nv), B, V))
    want, wdest, wsrc = jax.jit(jax.vmap(
        lambda x: jdense._blocked_dp(x, V, Bk)))(slabs)
    got, gdest, gsrc = tdense.blocked_dp(torch.from_numpy(slabs), Bk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(_np(gdest), np.asarray(wdest))
    np.testing.assert_array_equal(_np(gsrc), np.asarray(wsrc))


def _jax_rows(wire, B, V, Bk):
    """The JAX package's two int16 row forms: blocked and scan."""
    blocked = np.asarray(jdense.dense_solve_wire_topo_nxt16_blocked_ragged(
        wire, B=B, V=V, Bk=Bk))
    scan = np.asarray(jdense.dense_solve_wire_topo_nxt16_ragged(wire, B=B, V=V))
    return blocked, scan


def _port_rows(wire, B, V, Bk):
    return _np(tdense.dense_solve_wire_topo_nxt16_blocked_ragged(
        ragged_to_device(wire, "cpu"), B, V, Bk))


@pytest.mark.parametrize("V,Bk,density,seed,nv", [
    (256, 128, 0.05, 0, None),   # sparse
    (256, 128, 0.3, 1, None),    # dense
    (256, 128, 0.05, 3, 150),    # padding past nv (dest mid-slab)
    (256, 64, 0.0005, 4, None),  # mostly unreachable
    (128, 64, 0.002, 11, 70),    # tiny + padding
    (256, 128, 0.9, 10, None),   # near-complete DAG (deep tie sets)
    (512, 64, 0.08, 9, None),    # the single-contig Bk
    (512, 32, 0.08, 9, None),    # the batched Bk
    (256, 32, 0.3, 2, None),     # batched Bk, dense
])
def test_entry_point_matches_jax_on_random_dags(V, Bk, density, seed, nv):
    """The entry point's int16 rows equal both JAX forms'."""
    B = 2
    w = _rand_wire(B, V, density, seed, nv)
    blocked, scan = _jax_rows(w, B, V, Bk)
    got = _port_rows(w, B, V, Bk)
    np.testing.assert_array_equal(got, blocked)
    np.testing.assert_array_equal(got, scan)


def _chain_text(n_segments, seed):
    sys.path.insert(0, str(Path(__file__).parent))
    from test_scale import _chain_contig

    return _chain_contig(n_segments, seed=seed)


@pytest.mark.parametrize("corpus,lo,hi", [
    ("long", 256, 512),   # generate_paf long contigs: a V = 512 bucket
    ("chain600", 512, 1024),
    ("chain1200", 1024, 2048),
])
def test_rows_match_jax_on_exporter_wires(tmp_path, corpus, lo, hi):
    """Exporter wires of real big-V buckets, with the scheduler's padded
    batch and Bk rule, plus padding rows for the multi-contig bucket."""
    text = (generate_paf(n_contigs=40, seed=9, max_records_per_contig=180)
            if corpus == "long" else
            _chain_text(*{"chain600": (600, 11), "chain1200": (1200, 23)}[corpus]))
    paf = tmp_path / "w.paf"
    paf.write_text(text)
    with native.GraphExporter(str(paf), config=DEFAULT_CONFIG,
                              max_records=8192) as exp:
        meta = exp.meta_bulk()
        n_v = meta[:, 2]
        idx = np.where((meta[:, 0] == 1) & (meta[:, 1] >= 2) & (n_v > lo)
                       & (n_v <= hi) & (meta[:, 6] < 2**27))[0]
        assert len(idx) >= 1
        V = hi
        padB = scheduler._pad_batch(len(idx), V)
        if len(idx) > 1:
            padB *= 2  # padding rows
        wire, ok, _cap = exp.export_wire_ragged(idx, V, meta[idx, 3], padB)
        assert ok.all()
    Bk = scheduler.BLOCKED_BK
    blocked, scan = _jax_rows(wire, padB, V, Bk)
    got = _port_rows(wire, padB, V, Bk)
    np.testing.assert_array_equal(got, blocked)
    np.testing.assert_array_equal(got, scan)
    assert got[: len(idx), V].any()  # some contig takes the fast finish


# Random DAG slabs at the blocked solve's sizes: (V, density, seed, nv).
_DAGS = {
    "v512_dest_mid": (512, 0.05, 3, 300),
    "v512_unreachable": (512, 0.0005, 4, None),
    "v512_near_complete": (512, 0.9, 10, None),
    "v1024_sparse": (1024, 0.02, 1, None),
    "v1024_dest_mid": (1024, 0.05, 5, 700),
}
_jax_scan16 = jax.jit(jax.vmap(jdense.solve_slab_topo_nxt16,
                               in_axes=(0, None)), static_argnums=1)
_jax_blocked16 = jax.jit(jax.vmap(jdense.solve_slab_topo_nxt16_blocked,
                                  in_axes=(0, None, None)),
                         static_argnums=(1, 2))


@functools.lru_cache(maxsize=None)
def _slabs_and_scan_rows(name):
    """(slabs, the JAX scan's int16 rows, the plain scan's) of one input:
    a random DAG of _DAGS, or "exporter", the first two contigs of a real
    V = 512 bucket (generate_paf long contigs) on the exporter's wire."""
    if name == "exporter":
        V = 512
        text = generate_paf(n_contigs=40, seed=9, max_records_per_contig=180)
        with tempfile.TemporaryDirectory() as tmp:
            paf = Path(tmp) / "w.paf"
            paf.write_text(text)
            with native.GraphExporter(str(paf), config=DEFAULT_CONFIG,
                                      max_records=8192) as exp:
                meta = exp.meta_bulk()
                n_v = meta[:, 2]
                idx = np.where((meta[:, 0] == 1) & (meta[:, 1] >= 2)
                               & (n_v > 256) & (n_v <= V)
                               & (meta[:, 6] < 2**27))[0][:2]
                assert len(idx) == 2
                wire, ok, _cap = exp.export_wire_ragged(idx, V, meta[idx, 3],
                                                        2)
                assert ok.all()
        B = 2
    else:
        V, density, seed, nv = _DAGS[name]
        B = 2
        wire = _rand_wire(B, V, density, seed, nv)
    slabs = np.array(jdense._densify_wire_ragged(wire, B, V))
    want = np.asarray(_jax_scan16(slabs, V))
    plain = _np(tdense.solve_slab_topo_nxt16(torch.from_numpy(slabs)))
    return slabs, want, plain


@pytest.mark.parametrize("name,Bk", [
    (name, Bk) for name in (*_DAGS, "exporter")
    for Bk in (*cuda_blocked.BLOCK_SIZES, 256)
    # the plain closure holds a (B, Bk, Bk, Bk) int32 tensor, 67 MB a
    # contig at Bk = 256: that size runs at V = 512 only
    if Bk < 256 or name.startswith("v512") or name == "exporter"
])
def test_blocked_rows_equal_scan_rows_at_every_block_size(name, Bk):
    """At every block size the blocked kernel takes, and at 256 (the
    plain version takes any Bk; its count sums reach 4 * Bk = 1,024
    there), the plain blocked rows, the new plain scan rows
    (solve_slab_topo_nxt16, the function the kernel computes) and both JAX
    forms (solve_slab_topo_nxt16 and solve_slab_topo_nxt16_blocked) are
    one and the same int16 row."""
    slabs, want, plain = _slabs_and_scan_rows(name)
    V = slabs.shape[2]
    np.testing.assert_array_equal(plain, want)
    got = _np(tdense.solve_slab_topo_nxt16_blocked(torch.from_numpy(slabs),
                                                   Bk))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(_jax_blocked16(slabs, V, Bk)),
                                  want)
