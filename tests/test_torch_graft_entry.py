"""The port's entry points (``alignasm_tpu_torch/graft_entry.py``) on the
CPU, held to the repository's ``__graft_entry__.py``: the same packed
bucket, the batched int64 relaxation bit-equal to the jitted JAX
function on every key, and the multi-device dry run over eight CPU mesh
entries; a CUDA request without a card raises.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from alignasm_tpu_torch import graft_entry


def test_example_bucket_matches_jax():
    batch, V, E, n_sweeps, packed = graft_entry._example_bucket(device="cpu")
    jbatch, jV, jE, jn, jpacked = jentry._example_bucket()
    assert (V, E, n_sweeps, len(packed)) == (jV, jE, jn, len(jpacked))
    assert len(batch) == len(jbatch) == 10
    for got, want in zip(batch, jbatch):
        assert got.device.type == "cpu"
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_entry_matches_jitted_jax_entry():
    """``fn(*args)`` of ``entry(device="cpu")`` equals
    ``jax.jit(__graft_entry__.entry()[0])`` on every key: dtype and
    values."""
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    jfn, jargs = jentry.entry()
    want = jax.jit(jfn)(*jargs)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, k)


def test_dryrun_multichip_over_eight_cpu_entries(capsys):
    graft_entry.dryrun_multichip(8, device=("cpu",) * 8)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: engine path over 8 devices" in out
    assert "mesh 8" in out and "edge-sharded contigs 1" in out


def test_dryrun_multichip_mesh_must_match_its_size():
    with pytest.raises(ValueError, match="a mesh of 4 devices"):
        graft_entry.dryrun_multichip(4, device=("cpu",) * 2)


def test_dryrun_multichip_needs_as_many_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("call", [
    lambda: graft_entry.entry(),
    lambda: graft_entry._example_bucket(),
    lambda: graft_entry.dryrun_multichip(2),
    lambda: graft_entry.dryrun_multichip(2, device=("cuda:0",) * 2),
], ids=["entry", "example_bucket", "dryrun", "dryrun_mesh"])
def test_cuda_request_without_a_card_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()
