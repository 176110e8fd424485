"""Entry points of the port, the counterparts of the repository's
``__graft_entry__.py``:

* ``entry(device="cuda")`` returns ``(fn, args)``: the batched int64
  relaxation of a bucket (distance-to-sink, anomaly floor, level DP, walk
  counts; ``ops/relax.py:solve_graph_batch``, csrc/relax64.cu on the card)
  and a real packed bucket of synthetic contigs as tensors on ``device``;
  ``fn(*args)`` runs it.
* ``dryrun_multichip(n_devices, device="cuda")`` runs the Python plane
  over a mesh of ``n_devices`` entries through both axes, the contig
  batches on the data axis and one big contig on the edge-sharded graph
  axis, and checks the result against the exact engine.

``device="cuda"`` without a card raises; ``device="cpu"`` (or a mesh of
CPU entries) runs the plain versions, as the tests do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _example_bucket(n_contigs=8, seed=123, device="cuda"):
    """Pack a real synthetic bucket (records -> DAGs -> edge arrays), as
    tensors on ``device``: (batch, V, E, n_sweeps, packed)."""
    import os
    import tempfile

    from alignasm_tpu_torch.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.engine.device import pack_graph
    from alignasm_tpu_torch.engine.graph import build_graph
    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.ops.wire import as_device
    from alignasm_tpu_torch.testing.synth import generate_paf

    dev = as_device(device)
    fd, path = tempfile.mkstemp(suffix=".paf")
    os.close(fd)
    try:
        with open(path, "w") as fh:
            fh.write(generate_paf(n_contigs=n_contigs, seed=seed,
                                  max_records_per_contig=12))
        ds = read_paf(path)
    finally:
        os.unlink(path)

    packed = [
        pack_graph(build_graph(c, DEFAULT_CONFIG))
        for c in ds.contigs if len(c) > 1
    ]
    B = len(packed)
    V = 1 << max(3, (max(pg.g.n_vertices for pg in packed) - 1).bit_length())
    E = 1 << max(3, (max(len(pg.eu) for pg in packed) - 1).bit_length())
    n_sweeps = max(pg.g.n for pg in packed) + 2

    def pad(arrs, dtype, fill=0):
        out = np.full((B, E), fill, dtype)
        for b, a in enumerate(arrs):
            out[b, : len(a)] = a
        return out

    batch = (
        pad([pg.eu for pg in packed], np.int32),
        pad([pg.ev for pg in packed], np.int32),
        pad([pg.es for pg in packed], np.int64),
        pad([pg.ea for pg in packed], np.int32),
        pad([pg.enz for pg in packed], np.int32),
        pad([pg.etot for pg in packed], np.int32),
        pad([pg.erank for pg in packed], np.int64),
        pad([np.ones(len(pg.eu), bool) for pg in packed], bool, False),
        np.asarray([pg.g.src for pg in packed], np.int32),
        np.asarray([pg.g.dest for pg in packed], np.int32),
    )
    return tuple(torch.from_numpy(a).to(dev) for a in batch), V, E, \
        n_sweeps, packed


def entry(device="cuda"):
    """Returns (fn, example_args): the batched int64 relaxation and a
    packed bucket on ``device``."""
    from alignasm_tpu_torch.ops.relax import solve_graph_batch

    batch, V, _E, n_sweeps, _ = _example_bucket(device=device)
    fn = functools.partial(solve_graph_batch, V=V, n_sweeps=n_sweeps)
    return fn, batch


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The Python plane over a mesh of ``n_devices`` entries: "cuda" is
    the first ``n_devices`` visible cards (fewer raise), a sequence such
    as ``("cuda:0",) * 2`` or ``("cpu",) * 8`` names the entries itself.
    A dataset of small contigs (the data axis) and one big contig routed
    to the graph axis go through ``solve_dataset_torch``; the result must
    equal the exact engine's."""
    import dataclasses
    import os
    import tempfile

    from alignasm_tpu_torch.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.engine.exact import solve_dataset
    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.ops.wire import as_device
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch
    from alignasm_tpu_torch.testing.synth import generate_paf

    if device == "cuda":
        as_device(device)  # raises without a card
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {have}")
        mesh = tuple(f"cuda:{i}" for i in range(n_devices))
    else:
        mesh = tuple(device)
        if len(mesh) != n_devices:
            raise ValueError(f"a mesh of {n_devices} devices expected, got "
                             f"{device!r}")

    fd, path = tempfile.mkstemp(suffix=".paf")
    os.close(fd)
    try:
        small = generate_paf(n_contigs=n_devices * 2, seed=123,
                             max_records_per_contig=12)
        big = generate_paf(n_contigs=1, seed=6, max_records_per_contig=60,
                           mean_segment=250)  # seed 6 -> 77 records
        big = "\n".join(
            "\t".join(["bigctg"] + line.split("\t")[1:])
            for line in big.splitlines() if line
        ) + "\n"
        with open(path, "w") as fh:
            fh.write(small)
            fh.write(big)
        ds = read_paf(path)
        ds2 = read_paf(path)
    finally:
        os.unlink(path)

    n_big = len(ds.contigs[-1])
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        max_device_records=max(16, n_big - 1),
        graph_shard_min_records=min(n_big, 48),
    )
    got = solve_dataset_torch(ds, cfg, device=mesh)
    stats = solve_dataset_torch.last_stats
    # checks that raise under python -O too
    if stats.get("graph_sharded", 0) < 1:
        raise AssertionError(f"big contig ({n_big} records) did not route to "
                             f"the graph axis: {stats}")
    if got != solve_dataset(ds2, cfg):
        raise AssertionError("multichip result diverges from exact")
    print(f"dryrun_multichip OK: engine path over {n_devices} devices — "
          f"data axis (device {stats['device']}, dense_buckets "
          f"{stats['dense_buckets']}, mesh {stats.get('data_mesh_devices')}) "
          f"+ graph axis (edge-sharded contigs {stats['graph_sharded']}, "
          f"{n_big} records), outputs equal to the exact engine")
