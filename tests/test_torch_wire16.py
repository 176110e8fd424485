"""The 16-bit wire densify kernel's design (csrc/densify.cu), emulated in
numpy, against the plain ``densify_wire16`` and JAX ``_densify_wire16``.

The emulation follows the kernel step by step: the 64-bit scan of the u16
deltas and its int32 positions, the wrap test on the total, each tile's
first entry and first seed as the scan launch marks them, the tiles
filled with INF32 and then their entries (the last of a run of equal
cells) and sorted seeds on top, and the fix-up launch: the per-entry
scatter of the wrap branch, then the seeds (unsorted ones in stream
order).  Inputs: exporter wires of the synth corpora (a rejected
contig's filler, padding seeds, n_real below the stream's length) and
random wires (``tests/test_torch_kernels.py:_wire16_case``) with
unsorted and repeated seeds, repeated cells, out-of-range value indices
and a delta stream whose int32 positions wrap.  Everything is integer:
the tolerance is 0.  JAX takes part where no position or seed is
negative (a JAX scatter reads a negative index from the end).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from alignasm_tpu.ops import dense as jdense
from alignasm_tpu_torch.ops import dense as tdense
from alignasm_tpu_torch.ops.wire import wire16_to_device
from tests.test_torch_dense import _corpus, _exporter_bucket
from tests.test_torch_kernels import _wire16_case

INF32 = tdense.INF32
TILE = 32768  # csrc/densify.cu kTile


def _mark(first, keys, ntiles):
    """The scan launch's boundaries: first[k] = the first item whose tile
    key is at least k (mark() item by item), n past the last key."""
    n = len(keys)
    if n == 0:
        first[:] = 0
    for i in range(n):
        prev = keys[i - 1] if i else -1
        first[max(prev + 1, 0):keys[i] + 1] = i
        if i == n - 1:
            first[max(keys[i] + 1, 0):] = n


def _keys(cells, ntiles, tile):
    """tile_of(): -1 below the slabs, the tile, or ntiles past them."""
    cells = np.asarray(cells, np.int64)
    return np.where(cells < 0, -1, np.minimum(cells // tile, ntiles))


def _last_of_runs(cells):
    """Items whose next item does not repeat their cell."""
    last = np.ones(len(cells), bool)
    last[:-1] = cells[:-1] != cells[1:]
    return last


def emulate_wire16(w16, B, V, tile=TILE):
    """The slabs as csrc/densify.cu writes them, and whether the wrap
    branch ran."""
    deltas, vidx, table, n_real, seeds, _ok = w16
    cells = B * V * (V + 1)
    n = max(0, min(int(n_real), len(deltas)))
    p64 = np.cumsum(deltas[:n].astype(np.int64))
    wrap = n > 0 and int(p64[-1]) > 2**31 - 1
    pos = (p64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    vi = np.minimum(vidx[:n].astype(np.int64), len(table) - 1)
    val = table[vi]
    sidx, sval = seeds[0].astype(np.int64), seeds[1]
    S = len(sidx)
    unsorted = bool((sidx[:-1] > sidx[1:]).any())
    ntiles = -(-cells // tile)
    flat = np.empty(cells, np.int32)
    tstart = np.empty(ntiles + 1, np.int64)
    sstart = np.empty(ntiles + 1, np.int64)
    if not wrap:
        _mark(tstart, _keys(pos, ntiles, tile), ntiles)
        if not unsorted:
            _mark(sstart, _keys(sidx, ntiles, tile), ntiles)
    last = _last_of_runs(pos)
    slast = _last_of_runs(sidx)
    for k in range(ntiles):  # the tiles
        c0, c1 = k * tile, min((k + 1) * tile, cells)
        t = np.full(c1 - c0, INF32, np.int32)
        if not wrap:
            i = np.arange(tstart[k], tstart[k + 1])
            i = i[(pos[i] >= c0) & (pos[i] < c1) & last[i]]
            t[pos[i] - c0] = val[i]  # at most one item a cell
            if not unsorted:
                s = np.arange(sstart[k], sstart[k + 1])
                s = s[(sidx[s] >= c0) & (sidx[s] < c1) & slast[s]]
                t[sidx[s] - c0] = sval[s]
        flat[c0:c1] = t
    if wrap:  # the fix-up: the wrap branch's scatter
        i = np.nonzero((pos >= 0) & (pos < cells) & last)[0]
        flat[pos[i]] = val[i]
    if wrap or unsorted:  # the fix-up's last CTA: the seeds
        if not unsorted:
            s = np.nonzero((sidx >= 0) & (sidx < cells) & slast)[0]
            flat[sidx[s]] = sval[s]
        else:
            for s in range(S):  # one thread, in stream order
                if 0 <= sidx[s] < cells:
                    flat[sidx[s]] = sval[s]
    return flat.reshape(B, V + 1, V), wrap


def _plain(w16, B, V):
    return tdense.densify_wire16(*wire16_to_device(w16, "cpu"), B, V).numpy()


def _jax(w16, B, V):
    deltas, vidx, table, n_real, seeds, _ok = w16
    return np.asarray(jdense._densify_wire16(
        *map(jnp.asarray, (deltas, vidx, table, seeds)), n_real, B, V))


@pytest.mark.parametrize("tile", [TILE, 64])
@pytest.mark.parametrize("corpus,lo,hi", [("hard", 0, 128),
                                          ("long", 64, 128)])
def test_emulation_matches_plain_and_jax_on_exporter_wires(tmp_path, corpus,
                                                           lo, hi, tile):
    """Exporter wires with padding contigs (their seeds) and one rejected
    contig (its zero-delta filler repeats a cell with the same value):
    the tile design equals the plain version and the JAX function, at the
    kernel's tile and at a small one (many boundaries a contig)."""
    exp, idx, n_edges, V = _exporter_bucket(tmp_path, _corpus(corpus), lo, hi)
    try:
        padB = (1 << (len(idx) - 1).bit_length()) * 2
        bad = n_edges.copy()
        bad[1] += 1
        for edges in (n_edges, bad):
            w16 = exp.export_wire16(idx, V, edges, padB)
            assert w16[5].all() == (edges is n_edges)
            assert w16[3] < len(w16[0])
            got, wrap = emulate_wire16(w16, padB, V, tile)
            assert not wrap
            np.testing.assert_array_equal(got, _plain(w16, padB, V))
            np.testing.assert_array_equal(got, _jax(w16, padB, V))
    finally:
        exp.close()


CASES = {
    "plain": dict(pad=3),
    "filler": dict(filler=True, pad=2),
    "unsorted": dict(pad=5, unsorted=True),
    "bad-vidx": dict(pad=1, bad_vidx=True),
    "dup": dict(pad=4, dup=True),
    "dup-unsorted": dict(pad=4, dup=True, unsorted=True),
    "wrap": dict(pad=2, wrap=True),
    "wrap-unsorted": dict(pad=2, wrap=True, unsorted=True, filler=True),
}


@pytest.mark.parametrize("tile", [TILE, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_matches_plain_on_random_wires(case, tile):
    """Random wires with unsorted and repeated seeds, repeated cells of
    other values (the last in stream order stays), value indices past the
    table and a wrapping delta stream (the per-entry branch, which drops
    the cells past the slabs and the negative ones): the tile design
    equals the plain version, and JAX where no index is negative."""
    B, V = 6, 8
    w16, padB = _wire16_case(B, V, 3, **CASES[case])
    got, wrap = emulate_wire16(w16, padB, V, tile)
    assert wrap == ("wrap" in case)
    np.testing.assert_array_equal(got, _plain(w16, padB, V))
    if not wrap:
        np.testing.assert_array_equal(got, _jax(w16, padB, V))
    if case == "dup":  # sorted: the seed's last pair stays
        assert got.reshape(-1)[B * V * (V + 1) + V * V] == 9
    if wrap:  # the entries past 2^32 landed in the first padding slab
        assert (got[B, 0, [3, 5]] != INF32).all()
