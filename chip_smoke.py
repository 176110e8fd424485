#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main path on one CUDA device.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   kernels of alignasm_tpu_torch/csrc with nvcc (one nvcc per source, in
   parallel).
2. Kernel vs plain: runs each kernel and its plain PyTorch version on
   the same CUDA tensors and requires bit-equal results (every value is
   an integer or an exactly rounded f32 key).  Native plane: exports
   every device bucket of the three corpora; the densify kernels on
   every bucket (the 16-bit one must write its slabs from tiles, not its
   scatter branch, and a bare torch.full of the same slab buffer is
   timed beside it: the card's write floor), the scan on V <= 256, the blocked solve on V > 256 at
   every block size it takes (Bk = 32, 64, 128: the A/B behind the
   scheduler's Bk, printed as a per-Bk line), its rows also held to the
   plain scan's int16 rows (also on chain16k's lone V = 16384 bucket at
   ``device_max_v=16384``: one chain contig of 6,000 segments,
   ``CHAIN16K``), and the sweep solve's slab entry
   (``n_sweeps = V``, its default hint) on long2000's widest V <= 256
   slab bucket, and on its V = 512 slab buckets (the workspace pass, a
   library size: printed, not summed into the kernels line).  Python
   plane: packs long2000 as ``solve_dataset_torch(dataset, ...)`` does;
   the sweep solve on every dense bucket and the int32 sparse relaxation
   on every int32 bucket, each with the bucket's topological hint
   (``scheduler.topo_hint``; no contig may take a kernel's Jacobi
   branch), and the dense shortest-path kernel (a library entry, no
   engine path calls it) on the dense buckets' contigs with no contig
   in its Jacobi branch, its s / a rows held to the sweep solve's d_s /
   d_a, then on the same contigs each given a cycle (every one in the
   branch), held to the plain version.  The top-K walk kernel
   (``topk``, a library entry) on long2000's packed contigs grouped by V
   (8-512, 256 a batch, K = 16, ``n_sweeps`` the batch's largest vertex
   count), on synth_hard's contigs as tests/test_topk.py picks them and
   on a seeded batch with cycles and self-loops (INF + x keys selected),
   bit-equal to ``topk_walks_batch_plain`` (the torch.topk composition),
   its sweeps counted (long2000's must sum to the literal loop's 217,110;
   the V = 512 batch's time over its slowest contig's sweeps is printed
   as the µs a sweep); every long2000 and synth_hard contig's
   ``out[src]`` held to the Eppstein engine's first 16 walks.  Each
   sweep-solve and relaxation bucket runs once more with its hint
   reversed, so that check (a) sends
   its contigs to the kernel's Jacobi branch, held to the same plain
   rows.  The int64 relaxation kernel (``relax64``) on every int64
   bucket of querysparse2000 (long2000 made query-sparse,
   ``query_sparse``: every contig's path sums may pass int32, so the
   Python plane makes eight int64 buckets of V 64-256; every contig a
   chain, no Jacobi-branch contig) with each bucket's hint and reversed
   (every contig in the branch), and on a seeded V = 512 bucket whose
   path sums pass 2^31 with the identity hint (DAGs whose longest path
   is under 3/4 of their rows: check (c) sends each to the kernel's
   Jacobi branch, the count held to the host's), against
   ``solve_graph_batch_plain`` on the same CUDA tensors.  Times both
   with CUDA events after a warm-up.
3. End to end, each path with the launch counts set to 0 just before it
   and read just after: the native plane, ``solve_dataset_torch(None,
   cfg, src_paths=...)`` at the default ``device_max_v`` (8192) on the
   three corpora, and on chain16k at ``device_max_v=16384``, the three
   output files byte-compared with the port's ``native.run`` on the same
   input, the engine's counts held to the JAX device engine's; then the
   Python plane, ``solve_dataset_torch(
   read_paf(long2000), cfg)`` on the card, its files byte-compared with
   ``native.run``'s and its counts held to the JAX Python plane's (and
   no Jacobi-branch contig); then the Python plane on querysparse2000 the
   same way (every bucket int64: ``relax64`` once a bucket, no
   Jacobi-branch contig; none of its contigs is device-eligible on the
   native plane, so it runs no native phase).  Every kernel of a path
   must have launched in its run (the Python plane's counts are the two
   runs' sums).
4. Profile: the native plane once more on each corpus under
   torch.profiler: the device's busy time and share, and the scan's and
   the blocked solve's kernel time.
5. Routing (``device_routing="auto"``, ``DEFAULT_CONFIG``): runs
   ``python -m alignasm_tpu_torch.runtime.devbench --calibrate`` into a
   temporary file (N and its seconds printed, every field beside the
   card's name and power limit, parsed by the port's ``_parse_model``),
   then routes long2000 and karyotype10k under that calibration, under
   near-free transport (no bucket gated, the device and fallback counts of
   phase 3's "always" run) and under a 1000 s round trip (every bucket
   gated, nothing launched), each run's routing stats and launches
   printed and its files byte-compared with ``native.run``'s; then resumes
   long2000 on the card: a journal pre-filled with the even-indexed
   contigs through the native engine, then ``cli.run([long2000,
   "--resume", journal])`` under near-free transport solves the odd ones
   through ``solve_missing_torch_native`` (``device`` > 0), files
   byte-equal to ``native.run``'s.  The near-free runs' and the resumed
   run's launches go into the kernels line beside phase 3's.
6. Mesh (the multi-device engine, parallel/mesh.py) over every visible
   card, or ``("cuda:0", "cuda:0")`` on one card: the fixed-width densify
   kernel (``densify_wire``) against its plain version on every V <= 256
   bucket of karyotype10k and long2000 exported with ``export_wire`` (the
   data axis's wire), its slabs' scan rows bit-equal too; the edge-sharded
   relaxation (``shard_relax``) on the shards of the giant corpus's giant
   contig (bigv plus a 20,000-segment chain contig, ``GIANT``: 32,122
   vertices, a longest path of 26,061 edges, 32,768 sweeps), its checked
   pass (the default route) and its forced rounds (``route="rounds"``,
   their sweep count at the fixpoint exit printed) each against one run of
   the literal plain rounds.  Then, with the launch counts set to 0 just before and read
   just after: the native plane over the mesh on karyotype10k and long2000 (files
   byte-equal to ``native.run``, counts held to the JAX engine's under an
   8-device mesh, ``MESH_NATIVE``), the Python plane over it on long2000
   (``MESH_PYTHON``), and the giant corpus through the native plane's
   graph axis (``graph_shard_min_records`` the giant contig's record
   count from the exporter's meta: ``graph_sharded == 1``, files
   byte-equal to ``native.run``, ``shard_relax.rounds`` printed); then the three native-plane runs once
   more under torch.profiler (wall, device busy; the Python plane's run
   is profiled itself).  Last, two ranks of the port's
   multihost (``python -m alignasm_tpu_torch.parallel.multihost
   --local-procs 2 --device-runtime``, a gloo group over localhost) on
   long2000, files byte-equal to ``native.run``.
7. Bench: ``python -m alignasm_tpu_torch.runtime.devbench 2000`` and
   ``... --bigv-sweep``, each in its own process (runtime/devbench.py:
   end_to_end, the topo / dense / sparse kernel sections and bigv, then
   the V x B x Bk sweep of the blocked solve); both must exit 0 with every
   section's line, no ``*_error``, no skipped section, every ``bit_equal``
   true, each section's kernels launched in it (its ``launches``), the
   end-to-end files byte-equal to ``native.run``'s and its forced run's
   ``device`` count above 0.  Prints each section's headline numbers
   beside the card's name and power limit (contigs/s auto / forced /
   native, topo's marginal and chained µs a contig, bigv's ms and ×bound,
   the best Bk per (V, B)).  Then, with the launch counts set to 0 just
   before and read just after, ``graft_entry.entry()`` on the card held to
   ``entry(device="cpu")`` on every key, and ``graft_entry.
   dryrun_multichip`` over the mesh of phase 6.

``python3 chip_smoke.py --mesh`` runs phase 1 and phase 6 alone, over
every visible card, with ``native.run``'s files written first and no
multihost run; its kernels line holds the two mesh kernels.  It is the
check of a machine with several cards: the peer copies of
``shard_relax`` and the data axis over separate cards run only there.

Then one JSON line of per-kernel results (``launches`` counted in phase
3, or phase 6 for ``densify_wire`` and ``shard_relax``, phase 7's in
``launches_bench``, null for the
library entries: ``dense_sp``, ``topk`` and the sweep solve's slab
entry, ``sweep_dense_slabs``; ``ms``/``plain_ms`` the kernel's and its
plain version's times summed over every bucket it ran on in phase 2, for
the blocked solve at the block size the scheduler picks; ``bound_ms``
the least time the card could take for the same work
(``alignasm_tpu_torch/runtime/roofline.py``, which the bench sections
share), from the bytes
each input the function needs and each output moves once (for the scan
and the blocked solve: the strict upper triangle, dest's column below
the diagonal, the trailer row's dest and src, and the rows) and the
operations of one pass over this run's edges, or over the cells the scan
and the blocked solve need (the same cells); ``library_ms``
null: no single PyTorch call
computes any of these functions), the card line again and, as the last
line, ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line.  Imports no JAX and nothing of the JAX package, and
fails if any phase loaded one of their modules.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent

# The JAX device engine's counts on these corpora with
# device_routing="always" and the default device_max_v (8192), and the
# port's number of buckets on the 16-bit wire.
CORPORA = {
    "karyotype10k": dict(device=9587, fallback=18, wire16_buckets=1),
    "long2000": dict(device=1952, fallback=34, native_direct=0,
                     wire16_buckets=1),
    "bigv": dict(device=4, fallback=0, native_direct=0, wire16_buckets=0),
    # at device_max_v=16384 (CHAIN16K)
    "chain16k": dict(device=1, fallback=0, native_direct=0,
                     wire16_buckets=0),
}
# The JAX Python plane's counts on long2000 (solve_dataset_tpu(read_paf(
# long2000), cfg) on the CPU, batch_size 256).
# No contig may take a sweep kernel's Jacobi branch there.
PYTHON_PLANE = dict(device=1952, fallback=34, singleton=14, oversize=0,
                    dense_buckets=6, int32_buckets=2, jacobi=0)
# The JAX Python plane's counts on querysparse2000 (solve_dataset_tpu(
# read_paf(querysparse2000), cfg) on the CPU, batch_size 256): every
# packed contig fails fits32, so every bucket is int64, and the port's
# int64 buckets there: (V, B) each, and their valid edges.
QUERYSPARSE = dict(device=1986, fallback=0, singleton=14, oversize=0,
                   dense_buckets=0, int32_buckets=0, jacobi=0)
QUERYSPARSE_BUCKETS = ([(64, 256), (128, 256), (128, 256), (256, 256),
                        (256, 256), (256, 256), (256, 256), (256, 194)],
                       246_112)
# bigv: four chain contigs of tests/test_scale.py, (segments, seed) each,
# of 970 to 7,226 vertices.
BIGV = ((600, 11), (1200, 23), (2500, 35), (4500, 47))
# chain16k: one chain contig of tests/test_scale.py, (segments, seed), of
# 8,193-16,384 vertices: at device_max_v=16384 a lone V = 16384 bucket.
CHAIN16K = (6000, 7)
# The giant corpus of phase 6: bigv's four contigs and one chain contig of
# (segments, seed), over max_device_records and the device's vertex cap:
# only the graph axis takes it to the device.
GIANT = (20000, 59)
# The JAX device engine's counts on the data axis: solve_dataset_tpu(None,
# cfg, src_paths=...) with device_routing="always" under an 8-device CPU
# mesh (tests/conftest.py's), and the JAX Python plane's on long2000 there.
MESH_NATIVE = {
    "karyotype10k": dict(device=9587, fallback=18, native_direct=0,
                         singleton=395),
    "long2000": dict(device=1952, fallback=34, native_direct=0,
                     singleton=14),
}
MESH_PYTHON = dict(device=1952, fallback=34, singleton=14, oversize=0,
                   dense_buckets=6, int32_buckets=2, jacobi=0)
# name: (source, replaced TPU kernel, the path that runs it)
KERNELS = {
    "densify_wire16": ("alignasm_tpu_torch/csrc/densify.cu",
                       "alignasm_tpu/ops/dense.py:532", "native"),
    "densify_ragged": ("alignasm_tpu_torch/csrc/densify.cu",
                       "alignasm_tpu/ops/dense.py:491", "native"),
    "topo_scan": ("alignasm_tpu_torch/csrc/topo_scan.cu",
                  "alignasm_tpu/ops/pallas_topo.py:38", "native"),
    "blocked_dp": ("alignasm_tpu_torch/csrc/blocked_dp.cu",
                   "alignasm_tpu/ops/dense.py:277", "native"),
    "sweep_dense": ("alignasm_tpu_torch/csrc/sweep_dense.cu",
                    "alignasm_tpu/ops/dense.py:701", "python"),
    "sweep_dense_slabs": ("alignasm_tpu_torch/csrc/sweep_dense.cu",
                          "alignasm_tpu/ops/dense.py:701", "library"),
    "relax32": ("alignasm_tpu_torch/csrc/relax32.cu",
                "alignasm_tpu/ops/relax32.py:37", "python"),
    "relax64": ("alignasm_tpu_torch/csrc/relax64.cu",
                "alignasm_tpu/ops/relax.py:73", "python"),
    "dense_sp": ("alignasm_tpu_torch/csrc/dense_sp.cu",
                 "alignasm_tpu/ops/pallas_relax.py:160", "library"),
    "densify_wire": ("alignasm_tpu_torch/csrc/densify.cu",
                     "alignasm_tpu/ops/dense.py:52", "mesh"),
    "shard_relax": ("alignasm_tpu_torch/csrc/shard_relax.cu",
                    "alignasm_tpu/parallel/mesh.py:40", "mesh"),
    "topk": ("alignasm_tpu_torch/csrc/topk.cu",
             "alignasm_tpu/ops/topk.py:35", "library"),
}
# The card's rates, the operation counts and the bounds: in
# alignasm_tpu_torch/runtime/roofline.py, shared with runtime/devbench.py.
# The top-K walk kernel's batches: contigs a batch, keys a vertex, and the
# largest V (csrc/topk.cu holds V <= 512 at K <= 49 in shared memory).
# Its bound counts one reverse-topological pass: K adds and K compares a
# valid edge.  long2000's contigs stop at their fixed points after
# TOPK_LONG2000_SWEEPS sweeps in all, the literal loop's count.
TOPK_B, TOPK_K, TOPK_MAX_V = 256, 16, 512
TOPK_LONG2000_SWEEPS = 217_110
# The sweep solve's largest V of its register pass (csrc/sweep_dense.cu
# kRegV); above it the workspace pass runs.
MAX_PASS_V = 256


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def config():
    from alignasm_tpu_torch.config import DEFAULT_CONFIG

    return dataclasses.replace(DEFAULT_CONFIG, device_routing="always")


def write_corpora(tmp: pathlib.Path) -> dict:
    from alignasm_tpu_torch.testing.synth import (
        _chain_contig, config_karyotype, generate_paf,
    )

    texts = {
        "karyotype10k": config_karyotype(10_000),
        "long2000": generate_paf(n_contigs=2000, seed=9,
                                 max_records_per_contig=180),
        "bigv": "".join(_chain_contig(n, seed=s).replace("bigctg", f"bigctg{k}")
                        for k, (n, s) in enumerate(BIGV)),
    }
    paths = {}
    for name, text in texts.items():
        paths[name] = tmp / f"{name}.paf"
        paths[name].write_text(text)
    return paths


def write_chain16k(tmp: pathlib.Path) -> pathlib.Path:
    from alignasm_tpu_torch.testing.synth import _chain_contig

    path = tmp / "chain16k.paf"
    path.write_text(_chain_contig(CHAIN16K[0], seed=CHAIN16K[1]))
    return path


def write_querysparse(long2000: pathlib.Path) -> pathlib.Path:
    """querysparse2000: long2000 made query-sparse (``query_sparse``);
    the Python plane solves it in int64 buckets only, and no contig is
    device-eligible on the native plane, so it stays out of that plane's
    phases."""
    path = long2000.with_name("querysparse2000.paf")
    path.write_text(query_sparse(long2000.read_text()))
    return path


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def buckets_of(paf, cfg, device):
    """Yield (V, realB, padB, kind, args) for every device bucket of
    ``paf``, exported as the scheduler exports them."""
    import numpy as np

    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.runtime import scheduler as tsched

    with native.GraphExporter(
            str(paf), config=cfg,
            max_records=max(cfg.max_device_records,
                            tsched._device_cap(cfg))) as exp:
        meta = exp.meta_bulk()
        idx = np.where(tsched._eligible_mask(meta, cfg))[0]
        n_v, n_edges = meta[:, 2], meta[:, 3]
        order = idx[n_v[idx].argsort(kind="stable")]
        for V, idxs in tsched._dense_buckets(order, n_v):
            padB = tsched._pad_batch(len(idxs), V)
            kind, wire, _ok, _nb = tsched.export_wire(
                exp, V, idxs, n_edges[idxs], padB)
            args = tsched.wire_to_device(kind, wire, device)
            yield int(V), len(idxs), padB, kind, args


def record(results, name, err, ms, plain, nbytes, nops):
    """Add one call's readings to ``name``'s line: its error, kernel and
    plain times, and its bound from the bytes it moves once and the
    operations its inputs need.  Returns the call's bound as text."""
    from alignasm_tpu_torch.runtime.roofline import bound_ms

    r = results[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain
    by_bytes, by_ops = bound_ms(nbytes, nops)
    r["bound_ms"] += max(by_bytes, by_ops)
    r["bytes_ms"] += by_bytes
    r["ops_ms"] += by_ops
    return f"bound {by_bytes:.4f} ms by bytes, {by_ops:.4f} by operations"


def check_scan(name, V, padB, slabs, results):
    """The scan kernel against its plain version on one V <= 256 bucket."""
    from alignasm_tpu_torch.ops import cuda_topo, dense
    from alignasm_tpu_torch.runtime.roofline import scan_work

    rows = cuda_topo.topo_scan_nxt8(slabs)
    rows_p = dense.solve_slab_topo_nxt8(slabs)
    err = int((rows.int() - rows_p.int()).abs().max())
    if err:
        fail(f"{name} V={V} B={padB}: scan kernel disagrees with plain "
             f"(max_abs_err {err})")
    ms = cuda_ms(lambda: cuda_topo.topo_scan_nxt8(slabs), 20)
    plain = cuda_ms(lambda: dense.solve_slab_topo_nxt8(slabs), 3)
    bound = record(results, "topo_scan", err, ms, plain,
                   *scan_work(slabs, rows))
    return (f"topo_scan {1000 * ms / padB:.4f} us/contig (plain "
            f"{1000 * plain / padB:.4f}; {ms:.4f} vs {plain:.4f} ms/bucket; "
            f"{bound})")


def check_blocked(name, V, padB, slabs, results, by_bk):
    """The blocked kernel against its plain version on one V > 256
    bucket, at every block size it takes, and its rows against the plain
    scan's; the scheduler's size is recorded, every size's time goes to
    ``by_bk``."""
    import torch

    from alignasm_tpu_torch.ops import cuda_blocked, dense
    from alignasm_tpu_torch.runtime import scheduler as tsched
    from alignasm_tpu_torch.runtime.roofline import blocked_work

    scan_rows = dense.solve_slab_topo_nxt16(slabs)
    parts = []
    for Bk in cuda_blocked.BLOCK_SIZES:
        rows = cuda_blocked.blocked_dp_nxt16(slabs, Bk)
        rows_p = dense.solve_slab_topo_nxt16_blocked(slabs, Bk)
        err = int((rows.int() - rows_p.int()).abs().max())
        if err:
            fail(f"{name} V={V} B={padB} Bk={Bk}: blocked kernel disagrees "
                 f"with plain (max_abs_err {err})")
        if not torch.equal(rows, scan_rows):
            fail(f"{name} V={V} B={padB} Bk={Bk}: blocked kernel disagrees "
                 f"with the plain scan's rows")
        ms = cuda_ms(lambda: cuda_blocked.blocked_dp_nxt16(slabs, Bk), 10)
        plain = cuda_ms(
            lambda: dense.solve_slab_topo_nxt16_blocked(slabs, Bk), 1)
        by_bk.setdefault(Bk, []).append((name, V, padB, ms))
        picked = Bk == tsched.BLOCKED_BK
        bound = ""
        if picked:
            bound = "; " + record(results, "blocked_dp", err, ms, plain,
                                  *blocked_work(slabs, rows))
        parts.append(
            f"blocked_dp Bk={Bk}{' (scheduler)' if picked else ''} "
            f"{1000 * ms / padB:.1f} us/contig (plain "
            f"{1000 * plain / padB:.1f}; {ms:.4f} vs {plain:.4f} ms/bucket"
            f"{bound})")
    return "; ".join(parts)


def jacobi_count():
    """A zeroed Jacobi-branch count for a sweep kernel's ``jacobi``."""
    import torch

    return torch.zeros(1, dtype=torch.int32, device="cuda")


def check_jacobi_branch(what, kernel, reversed_order, n_want, want):
    """The Jacobi branch of a sweep kernel at a main-path shape: ``kernel(
    order, jacobi)`` with the reversed hint must send ``n_want`` contigs to
    the branch and still equal the plain rows ``want``.  Returns the
    branch's time."""
    import torch

    jacobi = jacobi_count()
    got = kernel(reversed_order, jacobi)
    if int(jacobi) != n_want:
        fail(f"{what}: {int(jacobi)} contigs took the Jacobi branch under "
             f"the reversed hint, expected {n_want}")
    if not torch.equal(got, want):
        fail(f"{what}: the Jacobi branch disagrees with plain (reversed "
             f"hint)")
    return cuda_ms(lambda: kernel(reversed_order, None), 3)


def reversed_misses(slabs):
    """Contigs of a slab bucket that check (a) fails under the reversed
    identity hint (position V-1-v): those with an edge (u, v), v >= u,
    other than an edge into dest while dest's row holds no edge."""
    import torch

    from alignasm_tpu_torch.ops import dense

    B, _, V = slabs.shape
    edge = slabs[:, :V] != dense.INF32
    col = torch.arange(V, device=slabs.device)
    dest = slabs[:, V, 0].long()
    on = (dest >= 0) & (dest < V)
    row_empty = ~edge[torch.arange(B, device=slabs.device),
                      dest.clamp(0, V - 1)].any(1)
    exempt = (col[None, None, :] == dest[:, None, None]) \
        & (row_empty | ~on)[:, None, None]
    up = col[None, :] >= col[:, None]
    return int((edge & up[None] & ~exempt).any(2).any(1).sum())


def check_slab_sweep(name, V, padB, slabs, results):
    """The sweep solve's slab entry (``dense_solve_slabs``, a library
    entry) against its plain version on one bucket, n_sweeps = V, with its
    default hint (the identity: the exporter's slabs are in Kahn order; no
    contig may take the Jacobi branch) and with the identity reversed (the
    Jacobi branch).  A V <= 256 bucket (the register pass) goes into the
    kernels line; a larger one (the workspace pass, a library size) is
    printed only."""
    import torch

    from alignasm_tpu_torch.ops import cuda_sweep, dense
    from alignasm_tpu_torch.runtime.roofline import path_work

    jacobi = jacobi_count()
    rows = cuda_sweep.sweep_dense_slabs(slabs, V, jacobi=jacobi)
    rows_p = dense.solve_slabs(slabs, V)
    err = int((rows.long() - rows_p.long()).abs().max())
    what = f"{name} V={V} B={padB} slab entry"
    if err:
        fail(f"{what}: sweep kernel disagrees with plain (max_abs_err {err})")
    if int(jacobi):
        fail(f"{what}: {int(jacobi)} contigs took the Jacobi branch")
    flip = torch.arange(V - 1, -1, -1, dtype=torch.int32,
                        device=slabs.device).expand(padB, V).contiguous()
    n_rev = reversed_misses(slabs)
    jac_ms = check_jacobi_branch(
        what, lambda o, j: cuda_sweep.sweep_dense_slabs(slabs, V, o, j),
        flip, n_rev, rows_p)
    ms = cuda_ms(lambda: cuda_sweep.sweep_dense_slabs(slabs, V), 20)
    branch = (f"Jacobi branch {jac_ms:.4f} ms (reversed hint, {n_rev} "
              f"contigs)")
    if V > MAX_PASS_V:
        return (f"sweep_dense_slabs workspace pass {ms:.4f} ms, {branch}; "
                f"bit-equal, jacobi 0")
    plain = cuda_ms(lambda: dense.solve_slabs(slabs, V), 1)
    edges = int((slabs[:, :V] != dense.INF32).sum())
    bound = record(results, "sweep_dense_slabs", err, ms, plain,
                   *path_work((slabs,), rows, edges))
    return (f"sweep_dense_slabs {ms:.4f} ms (plain {plain:.4f}; {bound}; "
            f"jacobi 0; {branch})")


def check_wire16_tiles(name, V, padB, args, slabs):
    """The 16-bit densify kernel on an exporter wire takes its tiles, not
    its scatter branch; returns the time of a bare fill of the same slab
    buffer (torch.full), the card's write floor beside the kernel."""
    import torch

    from alignasm_tpu_torch.ops import cuda_densify, dense

    count = jacobi_count()
    again = cuda_densify.densify_wire16(*args, padB, V, count)
    if int(count) or not torch.equal(again, slabs):
        fail(f"{name} V={V} B={padB}: densify_wire16 took its scatter "
             f"branch ({int(count)}) or changed between calls")
    fill = cuda_ms(lambda: torch.full((slabs.numel(),), dense.INF32,
                                      dtype=torch.int32, device=slabs.device),
                   20)
    return f"scatter branch 0; bare fill of the slabs {fill:.4f} ms"


def phase_kernels(paths, cfg, device, results):
    """Each kernel against its plain version on every bucket."""
    import torch

    from alignasm_tpu_torch.ops import cuda_densify, dense
    from alignasm_tpu_torch.runtime import scheduler as tsched
    from alignasm_tpu_torch.runtime.roofline import densify_work

    by_bk = {}
    for name, paf in paths.items():
        for V, realB, padB, kind, args in buckets_of(paf, cfg, device):
            if kind == "wire16":
                kname = "densify_wire16"
                k_fn = lambda: cuda_densify.densify_wire16(*args, padB, V)  # noqa: E731
                p_fn = lambda: dense.densify_wire16(*args, padB, V)  # noqa: E731
            else:
                kname = "densify_ragged"
                k_fn = lambda: cuda_densify.densify_ragged(*args, padB, V)  # noqa: E731
                p_fn = lambda: dense.densify_wire_ragged(*args, padB, V)  # noqa: E731
            slabs, slabs_p = k_fn(), p_fn()
            torch.cuda.synchronize()
            err_d = int((slabs.long() - slabs_p.long()).abs().max())
            del slabs_p
            if err_d:
                fail(f"{name} V={V} B={padB}: {kname} kernel disagrees with "
                     f"plain (max_abs_err {err_d})")
            d_ms, d_plain = cuda_ms(k_fn, 20), cuda_ms(p_fn, 5)
            wire_in = [a for a in args if isinstance(a, torch.Tensor)]
            d_bound = record(results, kname, err_d, d_ms, d_plain,
                             *densify_work(wire_in, slabs))
            if kind == "wire16":
                d_plain = f"{d_plain:.4f}; {d_bound}; " + check_wire16_tiles(
                    name, V, padB, args, slabs)
            else:
                d_plain = f"{d_plain:.4f}"
            if V <= tsched.MAX_V:
                solve = check_scan(name, V, padB, slabs, results)
            else:
                solve = check_blocked(name, V, padB, slabs, results, by_bk)
            if name == "long2000" and kind == "ragged":
                solve += "; " + check_slab_sweep(name, V, padB, slabs,
                                                 results)
            print(f"kernels {name} V={V} B={realB} padB={padB} wire={kind}: "
                  f"bit-equal; {kname} {d_ms:.4f} ms/bucket "
                  f"(plain {d_plain}); {solve}", flush=True)
    for Bk, runs in by_bk.items():
        print(f"blocked_dp A/B Bk={Bk}: {sum(r[3] for r in runs):.4f} ms "
              f"over {len(runs)} buckets (" + ", ".join(
                  f"{n} V={V} padB={B} {ms:.4f}" for n, V, B, ms in runs)
              + ")", flush=True)


def check_dense_sp(bucket, sweep_rows, device, results):
    """The dense shortest-path kernel against its plain version on the
    contigs of one dense bucket that ``pack_dense`` accepts, with no
    contig in its Jacobi branch; its s / a rows must equal the sweep
    solve's d_s / d_a (the same lex-min (sum, anom) after the same Jacobi
    sweeps).  Then the same contigs each with a cycle, every one in the
    branch, held to the plain version.  Returns the line's text."""
    import numpy as np
    import torch

    from alignasm_tpu_torch.ops import cuda_dense_sp, dense_sp
    from alignasm_tpu_torch.runtime.roofline import DENSE_SP_OPS, nbytes_of

    V, ns = bucket["V"], bucket["n_sweeps"]
    rows, mats, dests = [], [], []
    for b, (_i, pg) in enumerate(bucket["chunk"]):
        m = dense_sp.pack_dense(pg, V)
        if m is not None:
            rows.append(b)
            mats.append(m)
            dests.append(np.full((1, V), pg.g.dest, np.int32))
    if not rows:
        return "dense_sp: no contig"
    ts = [torch.from_numpy(np.stack([m[k] for m in mats])).to(device)
          for k in range(5)]
    dest = torch.from_numpy(np.stack(dests)).to(device)
    what = f"long2000 python V={V}: dense_sp"
    want = dense_sp.dense_sp_plain(*ts, dest, ns)
    err = check_dense_sp_call(what, ts, dest, ns, want, 0)
    idx = torch.tensor(rows, device=device)
    for k, j in (("s", 0), ("a", 1)):
        if not torch.equal(want[k][:, 0], sweep_rows[idx, j]):
            fail(f"{what} {k} differs from the sweep solve's")
    ms = cuda_ms(lambda: cuda_dense_sp.dense_sp(*ts, dest, ns), 10)
    plain = cuda_ms(lambda: dense_sp.dense_sp_plain(*ts, dest, ns), 1)
    edges = int((ts[0] < dense_sp.INF32).sum())
    bound = record(results, "dense_sp", err, ms, plain,
                   nbytes_of(*ts, dest) + 6 * dest.numel() * 4,
                   edges * DENSE_SP_OPS)
    # every contig with a cycle (each first edge (u, v) also as (v, u)):
    # check (a) sends it to the Jacobi branch
    cyc = [t.clone() for t in ts]
    for b in range(len(rows)):
        u, v = (int(x) for x in torch.nonzero(ts[0][b] < dense_sp.INF32)[0])
        for t in cyc:
            t[b, v, u] = t[b, u, v]
    want = dense_sp.dense_sp_plain(*cyc, dest, ns)
    check_dense_sp_call(f"{what} (cycles)", cyc, dest, ns, want, len(rows))
    jac = cuda_ms(lambda: cuda_dense_sp.dense_sp(*cyc, dest, ns), 3)
    return (f"dense_sp {ms:.4f} ms on {len(rows)} contigs (plain {plain:.4f}; "
            f"{bound}; {edges} edges; jacobi 0; Jacobi branch {jac:.4f} ms, "
            f"every contig with a cycle), s / a = sweep's")


def check_dense_sp_call(what, ts, dest, ns, want, n_want):
    """One dense_sp kernel call held to the plain rows ``want``, with
    ``n_want`` contigs in its Jacobi branch.  Returns max_abs_err (0)."""
    import torch

    from alignasm_tpu_torch.ops import cuda_dense_sp, dense_sp

    jacobi = jacobi_count()
    got = cuda_dense_sp.dense_sp(*ts, dest, ns, jacobi)
    err = max(int((got[k].long() - want[k].long()).abs().max())
              for k in dense_sp.DSP_ROWS)
    if err or not all(torch.equal(got[k], want[k]) for k in want):
        fail(f"{what} kernel disagrees with plain (max_abs_err {err})")
    if int(jacobi) != n_want:
        fail(f"{what}: {int(jacobi)} contigs took the Jacobi branch, "
             f"expected {n_want}")
    return err


def phase_python_kernels(paf, cfg, device, results):
    """The Python plane's kernels against their plain versions on every
    bucket of ``paf``, packed and bucketed as solve_dataset_torch's
    Python plane does.  Returns the packed contigs."""
    import numpy as np
    import torch

    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.ops import cuda_relax32, cuda_sweep, dense, relax32
    from alignasm_tpu_torch.runtime import scheduler as tsched
    from alignasm_tpu_torch.runtime.roofline import path_work

    t0 = time.perf_counter()
    stats = dict(singleton=0, oversize=0)
    _res, packed = tsched.pack_dataset(read_paf(str(paf)), cfg, stats)
    buckets = tsched.python_buckets(packed, cfg)
    print(f"python plane: {len(packed)} contigs packed into "
          f"{len(buckets)} buckets in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    for _i, pg in packed:
        tsched.topo_hint(pg, tsched._next_pow2(pg.g.n_vertices))
    print(f"python plane: topo_hint of {len(packed)} contigs in "
          f"{time.perf_counter() - t0:.4f} s (host)", flush=True)
    for bk in buckets:
        B, V, ns, kind = bk["B"], bk["V"], bk["n_sweeps"], bk["kind"]
        *args, order = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in bk["args"]]
        if kind == "dense":
            ws, wa, dest = args
            edge = ws < dense.INF32
            kernel = lambda o, j: cuda_sweep.sweep_dense_batch(  # noqa: E731
                ws, wa, dest, ns, o, j)
            p_fn = lambda: dense.solve_one(ws, wa, edge, dest, ns)  # noqa: E731
            kname, edges = "sweep_dense", int(edge.sum())
        elif kind == "sparse32":
            kernel = lambda o, j: cuda_relax32.relax32(  # noqa: E731
                *args, V, ns, o, j)
            p_fn = lambda: relax32.sp_batch32_plain(*args, V, ns)  # noqa: E731
            kname, edges = "relax32", int(args[4].sum())
        else:
            fail(f"long2000 python: unexpected {kind} bucket (V={V})")
        jacobi = jacobi_count()
        got, want = kernel(order, jacobi), p_fn()
        err = int((got.long() - want.long()).abs().max())
        what = f"long2000 python V={V} B={B} {kname}"
        if err:
            fail(f"{what}: kernel disagrees with plain (max_abs_err {err})")
        if int(jacobi):
            fail(f"{what}: {int(jacobi)} contigs took the Jacobi branch")
        jac_ms = check_jacobi_branch(what, kernel, order.flip(1).contiguous(),
                                     B, want)
        ms = cuda_ms(lambda: kernel(order, None), 20)
        plain = cuda_ms(p_fn, 1)
        bound = record(results, kname, err, ms, plain,
                       *path_work(args, got, edges))
        extra = ""
        if kind == "dense":
            extra = "; " + check_dense_sp(bk, got, device, results)
        print(f"kernels long2000 python V={V} B={B} n_sweeps={ns} {kind}: "
              f"bit-equal; {kname} {ms:.4f} ms/bucket (plain {plain:.4f}; "
              f"{bound}; {edges} edges; jacobi 0; Jacobi branch {jac_ms:.4f} "
              f"ms, reversed hint, {B} contigs){extra}", flush=True)
    return packed


def topk_batches(items, n_sweeps):
    """Batches (V, items, n_sweeps) of (graph, PackedGraph) items: grouped
    by V (the next power of two of the vertex count, at least 8), sorted
    by (vertices, edges), TOPK_B contigs a batch; ``n_sweeps(graphs)``
    gives a batch's sweeps."""
    from alignasm_tpu_torch.runtime.scheduler import _next_pow2

    by_v = {}
    for g, pg in sorted(items, key=lambda t: (t[0].n_vertices, len(t[1].eu))):
        by_v.setdefault(_next_pow2(g.n_vertices), []).append((g, pg))
    for V, group in sorted(by_v.items()):
        if V > TOPK_MAX_V:
            fail(f"topk: a contig of V = {V} over the kernel's {TOPK_MAX_V}")
        for lo in range(0, len(group), TOPK_B):
            chunk = group[lo:lo + TOPK_B]
            yield V, chunk, n_sweeps([g for g, _pg in chunk])


def topk_cycle_batch(seed, B=TOPK_B, V=64):
    """A seeded batch whose contigs hold cycles: position i links to i + 1
    and up to three of the next 16 (dest V - 1), row 1 to every vertex
    (itself included: out-degree V, so INF + x keys enter its list), an
    edge 2 -> 0, a self-loop at V / 2, and a negative key (-7) from V - 3
    into V - 2, which reaches no sink (INF - 7 is kept)."""
    import numpy as np

    from alignasm_tpu_torch.ops.topk import INF

    rng = np.random.default_rng(seed)
    wk1 = np.full((B, V, V), INF, np.int64)

    def keys(n):
        return (rng.integers(0, 2**20, n).astype(np.int64) << 16) \
            | rng.integers(0, 2, n)

    for b in range(B):
        for i in range(V - 1):
            cols = {i + 1, *rng.integers(i + 1, min(V, i + 17),
                                         rng.integers(0, 4)).tolist()}
            wk1[b, i, sorted(cols)] = keys(len(cols))
        wk1[b, 1] = keys(V)
        wk1[b, 2, 0] = keys(1)[0]
        wk1[b, V // 2, V // 2] = keys(1)[0]
        wk1[b, V - 3:V - 1] = INF
        wk1[b, V - 3, V - 2] = -7
        wk1[b, V - 4, V - 1] = keys(1)[0]
    return wk1, np.full(B, V - 1, np.int32)


def check_topk(what, wk1, dest, V, ns, results, totals):
    """The top-K walk kernel against its plain version (the torch.topk
    composition) on one batch: bit-equal, timed with CUDA events after a
    warm-up, its sweeps counted.  Returns the kernel's output and time."""
    import torch

    from alignasm_tpu_torch.ops import cuda_topk, topk
    from alignasm_tpu_torch.runtime.roofline import nbytes_of

    sweeps = jacobi_count()
    got = cuda_topk.topk_walks_batch(wk1, dest, V, TOPK_K, ns, sweeps)
    # the plain version's warm-up is one sweep at the batch's shapes; its
    # timed run, the long one, gives the rows the kernel is held to
    topk.topk_walks_batch_plain(wk1, dest, V, TOPK_K, 1)
    plain, want = cuda_ms_once(
        lambda: topk.topk_walks_batch_plain(wk1, dest, V, TOPK_K, ns))
    if not torch.equal(got, want):
        bad = int((got != want).any(2).any(1).sum())
        fail(f"{what}: topk kernel disagrees with plain on {bad} contigs")
    ms = cuda_ms(lambda: cuda_topk.topk_walks_batch(wk1, dest, V, TOPK_K,
                                                    ns), 5)
    B = wk1.shape[0]
    edges = int((wk1 < topk.INF).sum())
    bound = record(results, "topk", 0, ms, plain,
                   nbytes_of(wk1, dest, got), 2 * edges * TOPK_K)
    ran = int(sweeps)
    for k, x in (("batches", 1), ("contigs", B), ("ms", ms), ("plain", plain),
                 ("sweeps", ran), ("of", B * ns)):
        totals[k] = totals.get(k, 0) + x
    print(f"kernels {what} V={V} B={B} n_sweeps={ns}: topk bit-equal; "
          f"{ms:.4f} ms (plain {plain:.4f}, the torch.topk composition; "
          f"{bound}; {edges} edges; sweeps {ran} of {B} x {ns})", flush=True)
    return got, ms


def topk_slowest(wk1, dest, V, ns):
    """The most sweeps one contig of the batch runs, each launched alone
    (the batch runs in one wave, so its time is about that many
    sweeps)."""
    from alignasm_tpu_torch.ops import cuda_topk

    most = 0
    for b in range(wk1.shape[0]):
        sweeps = jacobi_count()
        cuda_topk.topk_walks_batch(wk1[b:b + 1], dest[b:b + 1], V, TOPK_K,
                                   ns, sweeps)
        most = max(most, int(sweeps))
    return most


def check_eppstein(what, items, got):
    """Each contig's out[src]: its finite keys are the sorted (score_sum
    << 16) | anom of the port's Eppstein engine's first TOPK_K walks
    (tests/test_topk.py's check).  Returns the number of contigs."""
    import torch

    from alignasm_tpu_torch.engine.kshortest import KShortestWalks
    from alignasm_tpu_torch.model import distance as D
    from alignasm_tpu_torch.ops.topk import INF

    src = torch.tensor([g.src for g, _pg in items], device=got.device)
    rows = got[torch.arange(len(items), device=got.device), src].cpu()
    for b, (g, _pg) in enumerate(items):
        kd = KShortestWalks(g.adj, D.CALC_SUM).solve(g.src, g.dest, TOPK_K)
        want = sorted((D.score_sum(d) << 16) | d[D.A] for d in kd)
        have = [int(x) for x in rows[b] if x < INF]
        if have != want:
            fail(f"{what}: contig {b} ({g.n_vertices} vertices): top-K keys "
                 f"{have} differ from the Eppstein engine's {want}")
    return len(items)


def phase_topk(packed, device, results):
    """The top-K walk kernel (a library entry, no engine path calls it) on
    long2000's packed contigs (n_sweeps each batch's largest vertex
    count, more than its longest path), on synth_hard's contigs as
    tests/test_topk.py picks them (n_sweeps their largest n + 2) and on a
    seeded batch with cycles (INF + x keys selected), each held to the
    plain version; every long2000 and synth_hard contig's out[src] held
    to the Eppstein engine."""
    import numpy as np
    import torch

    from alignasm_tpu_torch.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.engine.device import pack_graph
    from alignasm_tpu_torch.engine.graph import build_graph
    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.ops.topk import INF, pack_edge_keys

    hard = []
    for contig in read_paf(str(ROOT / "tests" / "data" /
                               "synth_hard.paf")).contigs:
        if 2 <= len(contig) <= 24:
            g = build_graph(contig, DEFAULT_CONFIG)
            hard.append((g, pack_graph(g)))
    corpora = (("long2000", [(pg.g, pg) for _i, pg in packed],
                lambda gs: max(g.n_vertices for g in gs)),
               ("synth_hard", hard, lambda gs: max(g.n + 2 for g in gs)))
    totals, agreed, t0 = {}, 0, time.perf_counter()
    for name, items, n_sweeps in corpora:
        before = totals.get("sweeps", 0)
        for V, chunk, ns in topk_batches(items, n_sweeps):
            wk1 = torch.from_numpy(np.stack(
                [pack_edge_keys(pg, V) for _g, pg in chunk])).to(device)
            dest = torch.tensor([g.dest for g, _pg in chunk],
                                dtype=torch.int32, device=device)
            got, ms = check_topk(name, wk1, dest, V, ns, results, totals)
            agreed += check_eppstein(f"{name} V={V}", chunk, got)
            if name == "long2000" and V == TOPK_MAX_V and len(chunk) == TOPK_B:
                most = topk_slowest(wk1, dest, V, ns)
                print(f"topk long2000 V={V} B={TOPK_B}: {ms:.4f} ms, its "
                      f"slowest contig {most} sweeps: {1e3 * ms / most:.3f} "
                      f"us a sweep", flush=True)
        if name == "long2000" and \
                totals["sweeps"] - before != TOPK_LONG2000_SWEEPS:
            fail(f"topk: long2000 ran {totals['sweeps'] - before} sweeps, "
                 f"not the literal loop's {TOPK_LONG2000_SWEEPS}")
    wk1, dest = (torch.from_numpy(a).to(device) for a in topk_cycle_batch(12))
    got, _ms = check_topk("cycles", wk1, dest, 64, 64, results, totals)
    if not bool(((got != INF) & ((got - INF).abs() < 2**40)).any()):
        fail("topk cycles: no INF + x key was selected")
    print(f"topk: {totals['batches']} batches, {totals['contigs']} contigs: "
          f"kernel {totals['ms']:.4f} ms, plain {totals['plain']:.4f} ms "
          f"(the torch.topk composition), bound "
          f"{results['topk']['bound_ms']:.4f} ms; sweeps {totals['sweeps']} "
          f"of {totals['of']}; out[src] = the Eppstein engine's first "
          f"{TOPK_K} walks on {agreed} contigs (long2000 and synth_hard); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def sparse64_bucket(seed, B=256, V=512):
    """A seeded bucket of the int64 relaxation's kind: B chain-like DAGs
    of V vertices (i -> j for j in i+1 .. i+8, dest V-1, src 0) whose
    scores in [2^25, 2^26) make every src -> dest path sum pass 2^31
    (at least 64 edges), as ``python_buckets`` pads edge lists: the
    (eu, ev, es, ea, enz, etot, erank, evalid, src, dest) arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lists = []
    for _b in range(B):
        u = np.repeat(np.arange(V - 1), 3)
        v = np.minimum(u + rng.integers(1, 9, len(u)), V - 1)
        u, v = np.unique(np.stack([u, v]), axis=1)
        lists.append((u, v))
    E = 1 << max(len(u) for u, _v in lists).bit_length()
    arrs = [np.zeros((B, E), t) for t in
            (np.int32, np.int32, np.int64, np.int32, np.int32, np.int32,
             np.int64)]
    evalid = np.zeros((B, E), bool)
    for b, (u, v) in enumerate(lists):
        k = len(u)
        nz = rng.integers(0, 60, k)
        for arr, val in zip(arrs, (u, v, rng.integers(2**25, 2**26, k),
                                   rng.integers(0, 3, k), nz,
                                   nz + rng.integers(1, 60, k),
                                   rng.permutation(k))):
            arr[b, :k] = val
        evalid[b, :k] = True
    return (*arrs, evalid, np.zeros(B, np.int32), np.full(B, V - 1, np.int32))


def query_sparse(text, shift=4_000_000, grow=800_000_000):
    """A PAF whose contigs' alignments lie sparse along a long query (as a
    chromosome-scale scaffold of a large genome with sparse alignments):
    the k-th record of each contig moves k * ``shift`` along the query,
    and every query grows by ``grow``.  The uncapped query gaps push every
    contig's path-sum bound past 2^29, so the Python plane solves it in
    int64 buckets only (tests/test_torch_relax64.py makes the same)."""
    out, seen = [], {}
    for line in text.splitlines():
        f = line.split("\t")
        k = seen.get(f[0], 0)
        seen[f[0]] = k + 1
        f[1] = str(int(f[1]) + grow)
        f[2] = str(int(f[2]) + k * shift)
        f[3] = str(int(f[3]) + k * shift)
        out.append("\t".join(f))
    return "\n".join(out) + "\n"


def branch64(host_args, order):
    """The contigs of an int64 bucket that csrc/relax64.cu's checks send
    to its Jacobi branch, for the hint ``order`` and for it reversed:
    check (a) fails under a hint when a valid edge (u, v) does not climb,
    other than an edge into dest while dest's row holds no edge; check
    (c) when the longest path is under 3/4 of the rows (the vertices
    with a valid out-edge).  Returns the two counts."""
    import numpy as np

    eu, ev, evalid, dest = (host_args[i] for i in (0, 1, 7, 9))
    B, V = order.shape
    fwd = rev = 0
    for b in range(B):
        u, v = eu[b][evalid[b]], ev[b][evalid[b]]
        L = np.zeros(V, np.int64)
        while True:
            new = L.copy()
            np.maximum.at(new, u, L[v] + 1)
            if np.array_equal(new, L):
                break
            L = new
        wide = 4 * int(L.max()) < 3 * len(np.unique(u))
        into_free = (v == dest[b]) & (not (u == dest[b]).any())

        def misses(o):
            pos = np.empty(V, np.int64)
            pos[o] = np.arange(V)
            return bool(((pos[v] <= pos[u]) & ~into_free).any())

        fwd += wide or misses(order[b])
        rev += wide or misses(order[b, ::-1])
    return fwd, rev


def check_relax64(what, host_args, V, ns, device, order=None):
    """The int64 relaxation kernel against its plain version on the same
    CUDA tensors (every output and dtype equal), with the hint ``order``
    (None: the identity) and with it reversed, each time with as many
    Jacobi-branch contigs as ``branch64`` counts.  Returns (kernel ms,
    the reversed hint's ms, plain ms, bytes, operations, the hint's
    Jacobi-branch contigs, the plain result): the bytes of every input
    and output once (the hint is the kernel's aid, not an input of the
    function), and SP64_OPS per valid edge."""
    import numpy as np
    import torch

    from alignasm_tpu_torch.ops import cuda_relax64, relax
    from alignasm_tpu_torch.runtime.roofline import SP64_OPS, nbytes_of

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in host_args]
    B = args[0].shape[0]
    if order is None:
        order = np.tile(np.arange(V, dtype=np.int32), (B, 1))
    hint = torch.from_numpy(np.ascontiguousarray(order)).to(device)
    flip = hint.flip(1).contiguous()
    n_fwd, n_rev = branch64(host_args, order)
    want = relax.solve_graph_batch_plain(*args, V=V, n_sweeps=ns)
    for o, n_want, tag in ((hint, n_fwd, "hint"), (flip, n_rev, "reversed")):
        jacobi = jacobi_count()
        got = cuda_relax64.relax64(*args, V, ns, o, jacobi)
        if list(got) != list(want):
            fail(f"{what} {tag}: relax64 returns {list(got)}, plain "
                 f"{list(want)}")
        for k, t in want.items():
            if got[k].dtype != t.dtype or not torch.equal(got[k], t):
                fail(f"{what} {tag}: relax64 disagrees with plain in {k}")
        if int(jacobi) != n_want:
            fail(f"{what} {tag}: {int(jacobi)} contigs took the Jacobi "
                 f"branch, expected {n_want}")
    ms = cuda_ms(lambda: cuda_relax64.relax64(*args, V, ns, hint), 10)
    rev = cuda_ms(lambda: cuda_relax64.relax64(*args, V, ns, flip), 3)
    plain = cuda_ms(
        lambda: relax.solve_graph_batch_plain(*args, V=V, n_sweeps=ns), 1)
    return (ms, rev, plain, nbytes_of(*args) + nbytes_of(*want.values()),
            int(args[7].sum()) * SP64_OPS, n_fwd, want)


def phase_relax64_kernels(paf, cfg, device, results):
    """The int64 relaxation kernel against its plain version on the card:
    on every int64 bucket of ``paf`` (querysparse2000), packed and
    bucketed as solve_dataset_torch's Python plane does, with the bucket's
    hint and reversed (summed into the kernels line; no contig may take
    the Jacobi branch under the hint), and on a seeded V = 512 bucket
    whose path sums pass 2^31, with the identity hint (printed)."""
    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.runtime import scheduler as tsched
    from alignasm_tpu_torch.runtime.roofline import SP64_OPS, bound_ms

    t0 = time.perf_counter()
    stats = dict(singleton=0, oversize=0)
    _res, packed = tsched.pack_dataset(read_paf(str(paf)), cfg, stats)
    buckets = tsched.python_buckets(packed, cfg)
    shapes = [(bk["V"], bk["B"]) for bk in buckets]
    edges = sum(int(bk["args"][7].sum()) for bk in buckets)
    if {bk["kind"] for bk in buckets} != {"sparse64"} \
            or (shapes, edges) != QUERYSPARSE_BUCKETS:
        fail(f"querysparse2000: buckets {shapes} of kinds "
             f"{sorted({bk['kind'] for bk in buckets})}, {edges} edges; "
             f"expected {QUERYSPARSE_BUCKETS} int64 buckets")
    print(f"python plane querysparse2000: {len(packed)} contigs packed into "
          f"{len(buckets)} int64 buckets ({edges} valid edges) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for bk in buckets:
        V, B, ns = bk["V"], bk["B"], bk["n_sweeps"]
        what = f"querysparse2000 python V={V} B={B} relax64"
        *args, order = bk["args"]
        ms, rev, plain, nbytes, nops, n_jac, _want = check_relax64(
            what, args, V, ns, device, order)
        if n_jac:
            fail(f"{what}: {n_jac} contigs sent to the Jacobi branch under "
                 f"the hint, expected none")
        bound = record(results, "relax64", 0, ms, plain, nbytes, nops)
        print(f"kernels querysparse2000 python V={V} B={B} n_sweeps={ns} "
              f"sparse64: bit-equal, jacobi 0; relax64 {ms:.4f} ms/bucket "
              f"(plain {plain:.4f}; {bound}; {int(args[7].sum())} edges; "
              f"Jacobi branch {rev:.4f} ms, reversed hint, {B} contigs)",
              flush=True)
    V = 512
    ms, rev, plain, nbytes, nops, n_jac, want = check_relax64(
        f"sparse64 seeded V={V}", sparse64_bucket(64, V=V), V, V, device)
    if int(want["d_s"][:, 0].min()) < 2**31:
        fail("sparse64: the seeded bucket's path sums do not pass int32")
    print(f"sparse64 relax64 seeded V={V} B=256 {nops // SP64_OPS} edges: "
          f"bit-equal, jacobi {n_jac} (check (c)); relax64 {ms:.4f} ms "
          f"(plain {plain:.4f}; Jacobi branch {rev:.4f} ms, reversed "
          f"hint); bound {bound_ms(nbytes, nops)[0]:.4f} ms by bytes, "
          f"{bound_ms(nbytes, nops)[1]:.4f} by operations", flush=True)


def outputs(prefix):
    return [pathlib.Path(f"{prefix}.aln{s}.paf").read_bytes()
            for s in ("", ".alt", ".all")]


def phase_end_to_end(paths, cfg, device, tmp):
    """The port's native plane vs native.run on each corpus.  Returns each
    corpus's stats."""
    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    by_name = {}
    for name, paf in paths.items():
        native.drain_teardowns()
        t0 = time.perf_counter()
        nstats = native.run(str(paf), out_prefix=str(tmp / f"native_{name}"),
                            config=cfg)
        t_native = time.perf_counter() - t0
        native.drain_teardowns()
        t0 = time.perf_counter()
        solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                            write_prefix=str(tmp / f"port_{name}"),
                            device=device)
        t_port = time.perf_counter() - t0
        stats = solve_dataset_torch.last_stats
        if "device_error" in stats:
            fail(f"{name}: device path degraded: {stats['device_error']}")
        if outputs(tmp / f"port_{name}") != outputs(tmp / f"native_{name}"):
            fail(f"{name}: output files differ from native.run")
        for key, want in CORPORA[name].items():
            if stats.get(key, 0) != want:
                fail(f"{name}: stats[{key!r}] = {stats.get(key, 0)}, "
                     f"expected {want}")
        n = stats["n_contigs"]
        print(f"end-to-end {name} on {device} (device_max_v "
              f"{cfg.device_max_v}): {n} contigs, files byte-equal "
              f"to native.run; device {stats['device']} fallback "
              f"{stats['fallback']} native_direct {stats['native_direct']}; "
              f"buckets {stats['bucket_vs']} wire16 "
              f"{stats.get('wire16_buckets', 0)}; "
              f"{n / t_port:.1f} contigs/s ({t_port:.4f} s; launch_s "
              f"{stats['launch_s']} sync_s {stats['sync_s']} cfinish_s "
              f"{stats['cfinish_s']}) vs native.run {n / t_native:.1f} "
              f"contigs/s ({t_native:.4f} s, {nstats['contigs']} contigs)",
              flush=True)
        by_name[name] = dict(stats)
    return by_name


def phase_python_plane(name, paf, want_stats, cfg, device, tmp):
    """The Python plane on the card vs native.run's files on ``paf``
    (``native_<name>`` in ``tmp``: written by phase_end_to_end, or here
    for a corpus that phase does not run), counts held to the JAX Python
    plane's ``want_stats``."""
    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.io.paf import read_paf, write_outputs
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    if not (tmp / f"native_{name}.aln.paf").exists():
        native.drain_teardowns()
        native.run(str(paf), out_prefix=str(tmp / f"native_{name}"),
                   config=cfg)
        native.drain_teardowns()
    t0 = time.perf_counter()
    dataset = read_paf(str(paf))
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = solve_dataset_torch(dataset, cfg, device=device)
    t_solve = time.perf_counter() - t0
    stats = solve_dataset_torch.last_stats
    prefix = tmp / f"python_{name}"
    for suffix, outs, counts in zip((".aln", ".aln.alt", ".aln.all"), results,
                                    (False, False, True)):
        with open(f"{prefix}{suffix}.paf", "w") as fh:
            write_outputs(dataset, outs, fh, name_suffix_counts=counts)
    if outputs(prefix) != outputs(tmp / f"native_{name}"):
        fail(f"{name} python plane: output files differ from native.run")
    for key, want in want_stats.items():
        if stats.get(key) != want:
            fail(f"{name} python plane: stats[{key!r}] = {stats.get(key)}, "
                 f"expected {want}")
    n = len(dataset.contigs)
    print(f"end-to-end {name} python plane on {device}: {n} contigs, files "
          f"byte-equal to native.run; device {stats['device']} fallback "
          f"{stats['fallback']} singleton {stats['singleton']}; buckets dense "
          f"{stats['dense_buckets']} int32 {stats['int32_buckets']}; "
          f"jacobi {stats['jacobi']}; "
          f"read_paf {t_read:.4f} s, solve {t_solve:.4f} s ({n / t_solve:.1f} "
          f"contigs/s; pack_s {stats['pack_s']} launch_s {stats['launch_s']} "
          f"finish_s {stats['finish_s']})", flush=True)


def union_ms(spans) -> float:
    """Length in ms of the union of (start, end) intervals in us."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_profile(paths, cfg, device, tmp):
    """One more native-plane run per corpus under torch.profiler (after
    phase 3, so nothing builds): the wall time, the device's busy time
    (the union of its kernel and copy intervals) and share, and the time
    of the scan's and the blocked solve's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    for name, paf in paths.items():
        native.drain_teardowns()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve_dataset_torch(None, cfg, src_paths=(str(paf), None),
                                write_prefix=str(tmp / f"prof_{name}"),
                                device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, kern = [], {"topo_scan": 0.0, "blocked": 0.0}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            for key in kern:
                if key in e.name:
                    kern[key] += (e.time_range.end - e.time_range.start) / 1e3
        if not spans:
            print(f"profile {name}: wall {wall:.4f} s; device busy not "
                  f"measured (the profiler saw no device events)", flush=True)
            continue
        busy = union_ms(spans)
        st = solve_dataset_torch.last_stats
        print(f"profile {name}: wall {wall:.4f} s; device busy {busy:.4f} ms "
              f"({100 * busy / (1e3 * wall):.2f} %); kernels topo_scan "
              f"{kern['topo_scan']:.4f} ms, blocked_dp {kern['blocked']:.4f} "
              f"ms; pack_s {st.get('pack_s')} cfinish_s {st.get('cfinish_s')} "
              f"write_s {st.get('write_s')} launch_s {st.get('launch_s')}",
              flush=True)


def card_mesh():
    """Every visible card, or cuda:0 twice on one card."""
    import torch

    n = torch.cuda.device_count()
    return tuple(f"cuda:{i}" for i in range(n)) if n > 1 else ("cuda:0",) * 2


def write_giant(tmp: pathlib.Path) -> pathlib.Path:
    from alignasm_tpu_torch.testing.synth import _chain_contig

    path = tmp / "giant.paf"
    path.write_text("".join(
        _chain_contig(n, seed=s).replace("bigctg", f"bigctg{k}")
        for k, (n, s) in enumerate(BIGV)) + _chain_contig(
            *GIANT[:1], seed=GIANT[1]).replace("bigctg", "giantctg"))
    return path


def giant_edges(paf, cfg, n_dev):
    """The giant contig's exported edges, padded as the graph axis pads
    them for ``n_dev`` devices: (8 arrays, Vp, n_sweeps, dest, n_rec)."""
    import numpy as np

    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.parallel.mesh import _pad_shapes

    with native.GraphExporter(str(paf), config=cfg, max_records=8192) as exp:
        i = int(exp.meta_bulk()[:, 1].argmax())
        exp.build_graph_one(i)
        _b, V, E, _src, dest, n = exp.edge_meta(i)
        cols = exp.export_edges(i)
    Ep, Vp, n_sweeps = _pad_shapes(E, V, n, n_dev)
    out = []
    for c, t in zip(cols, (np.int32, np.int32, np.int64, np.int32, np.int32,
                           np.int32, np.int64)):
        a = np.zeros(Ep, t)
        a[:E] = c
        out.append(a)
    valid = np.zeros(Ep, bool)
    valid[:E] = True
    return out + [valid], Vp, n_sweeps, dest, n, V, E


def cuda_ms_once(fn):
    """Device time of one call of ``fn`` (a long one: no warm-up)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def check_densify_wire(name, V, W, realB, k, dev, w, results):
    """densify_wire and the scan rows after it against their plain
    versions on shard ``k`` of one bucket's wire, on its mesh entry."""
    from alignasm_tpu_torch.ops import cuda_densify, cuda_topo, dense
    from alignasm_tpu_torch.runtime.roofline import densify_wire_work

    k_fn = lambda: cuda_densify.densify_wire(w, V)  # noqa: E731
    p_fn = lambda: dense.densify_wire(w, V)  # noqa: E731
    slabs, slabs_p = k_fn(), p_fn()
    err = int((slabs.long() - slabs_p.long()).abs().max())
    rows = cuda_topo.topo_scan_nxt8(slabs)
    err_rows = int((rows.long() - dense.solve_slab_topo_nxt8(
        slabs_p).long()).abs().max())
    del slabs_p
    if err or err_rows:
        fail(f"mesh {name} V={V} shard {k}: densify_wire disagrees with "
             f"plain (max_abs_err {err}, rows {err_rows})")
    ms, plain = cuda_ms(k_fn, 20), cuda_ms(p_fn, 5)
    bound = record(results, "densify_wire", err, ms, plain,
                   *densify_wire_work(w, slabs))
    print(f"mesh kernels {name} V={V} W={W} shard {k} on {dev}: "
          f"{w.shape[0]} rows of the bucket's {realB}: densify_wire "
          f"bit-equal, scan rows bit-equal; {ms:.4f} ms (plain "
          f"{plain:.4f}; {bound})", flush=True)


def phase_mesh_kernels(paths, giant, cfg, mesh, results):
    """densify_wire on every V <= 256 bucket's fixed-width wire, its scan
    rows too, shard by shard as the data axis launches them, and
    shard_relax on the giant contig's shards, each against its plain
    version."""
    import numpy as np
    import torch

    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.ops.cuda_shard_relax import shard_relax
    from alignasm_tpu_torch.parallel import mesh as tmesh
    from alignasm_tpu_torch.runtime import scheduler as tsched
    from alignasm_tpu_torch.runtime.roofline import SP64_OPS, bound_ms

    for name in ("karyotype10k", "long2000"):
        with native.GraphExporter(
                str(paths[name]), config=cfg,
                max_records=tsched._device_cap(cfg)) as exp:
            meta = exp.meta_bulk()
            idx = np.where(tsched._eligible_mask(meta, cfg))[0]
            n_v, n_edges = meta[:, 2], meta[:, 3]
            order = idx[n_v[idx].argsort(kind="stable")]
            for V, idxs in tsched._dense_buckets(order, n_v):
                if V > tsched.MAX_V:
                    continue
                W = tsched._next_pow2(int(n_edges[idxs].max()) + 2)
                wire, ok = exp.export_wire(idxs, V, W)
                # the shards the data axis launches: rows padded to the
                # mesh, one slice on each entry
                wire, _idxs, realB = tsched.data_axis_wire(wire, ok, idxs,
                                                           len(mesh))
                if not realB:
                    continue
                slices = tmesh.shard_slices(len(wire), len(mesh))
                for k, (d, sl) in enumerate(zip(mesh, slices)):
                    with torch.cuda.device(d):
                        check_densify_wire(name, V, W, realB, k, d,
                                           torch.from_numpy(wire[sl]).to(d),
                                           results)
    cols, Vp, n_sweeps, dest, n_rec, V, E = giant_edges(giant, cfg, len(mesh))
    shards = [tuple(torch.from_numpy(c[sl]).to(d) for c in cols)
              for d, sl in zip(mesh, tmesh.shard_slices(len(cols[0]),
                                                        len(mesh)))]
    rows, L = giant_depth(cols, Vp)
    # the plain rounds once: both routes are held to that one result
    t0 = time.perf_counter()
    plain, want = cuda_ms_once(lambda: tmesh.edge_sharded_sp_plain(
        shards, Vp, n_sweeps, dest))
    plain_wall = time.perf_counter() - t0
    reached = int((want[0] < 2**62).sum())
    print(f"mesh kernels giant: {n_rec} records, V={V} (Vp={Vp}) E={E} "
          f"(Ep={len(cols[0])}), {rows} rows, longest path {L} edges, "
          f"{len(mesh)} shards on {', '.join(mesh)}, {n_sweeps} sweeps; "
          f"plain rounds {plain:.4f} ms ({plain_wall:.1f} s wall, {reached} "
          f"vertices reach dest)", flush=True)
    # one pass of the int64 relaxation over the contig's edges, each input
    # read once (37 bytes an edge) and the four outputs written once
    nbytes, nops = 37 * len(cols[0]) + 32 * Vp, SP64_OPS * E
    for route in ("pass", "rounds"):
        k_fn = lambda: shard_relax(  # noqa: E731
            shards, Vp, n_sweeps, dest, route=route)
        rounds = shard_relax.rounds
        got = k_fn()  # also the warm-up
        took = "rounds" if shard_relax.rounds > rounds else "pass"
        # the pass: the mean of five calls (one call's host stalls show);
        # the rounds: one call
        ms = cuda_ms(k_fn, 5) if route == "pass" else cuda_ms_once(k_fn)[0]
        if took != route:
            fail(f"mesh giant: shard_relax route={route} took the {took}")
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        if err:
            fail(f"mesh giant: shard_relax route={route} disagrees with "
                 f"plain (max_abs_err {err})")
        if route == "pass":  # the route of the main path
            bound = record(results, "shard_relax", err, ms, plain, nbytes,
                           nops)
            detail = f"{1000 * ms / rows:.4f} us a row"
        else:
            by_bytes, by_ops = bound_ms(nbytes, nops)
            bound = (f"bound {by_bytes:.4f} ms by bytes, {by_ops:.4f} by "
                     f"operations")
            detail = (f"{shard_relax.sweeps} of {n_sweeps} sweeps at the "
                      f"fixpoint exit, {1000 * ms / shard_relax.sweeps:.4f} "
                      f"us a sweep")
        print(f"mesh kernels giant shard_relax route={route}: bit-equal to "
              f"the plain rounds; {ms:.4f} ms ({detail}; plain {plain:.4f} "
              f"ms; {bound}); shard_relax.rounds {shard_relax.rounds}",
              flush=True)
    return n_rec


def giant_depth(cols, V):
    """(rows, longest path): the giant contig's vertices with a valid
    out-edge and its longest path in edges, over the wrapper's hint (a
    reverse Kahn order from erank)."""
    import torch

    from alignasm_tpu_torch.ops.cuda_shard_relax import pass_inputs

    start, ev, *_rest, order = pass_inputs(
        [tuple(torch.from_numpy(c) for c in cols)], V, torch.device("cpu"))
    start, ev, order = start.tolist(), ev.tolist(), order.tolist()
    depth = [0] * V
    for u in reversed(order):
        depth[u] = max((depth[v] + 1 for v in ev[start[u]:start[u + 1]]),
                       default=0)
    return sum(start[u + 1] > start[u] for u in range(V)), max(depth)


def profiled_run(fn):
    """(wall s, device busy ms or None) of ``fn()`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, (union_ms(spans) if spans else None)


def busy_text(wall, busy):
    if busy is None:
        return f"wall {wall:.4f} s; device busy not measured"
    return (f"wall {wall:.4f} s; device busy {busy:.4f} ms "
            f"({100 * busy / (1e3 * wall):.2f} %)")


def phase_mesh_end_to_end(paths, giant, giant_rec, cfg, mesh, tmp):
    """The main path over the mesh: the native plane on karyotype10k and
    long2000, the Python plane on long2000, the giant corpus through the
    graph axis; files byte-equal to native.run, counts held to JAX's."""
    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.io.paf import read_paf, write_outputs
    from alignasm_tpu_torch.ops.cuda_shard_relax import shard_relax
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    def held(what, stats, want):
        if "device_error" in stats:
            fail(f"mesh {what}: device path degraded: {stats['device_error']}")
        for key, v in {**want, "data_mesh_devices": len(mesh)}.items():
            if stats.get(key) != v:
                fail(f"mesh {what}: stats[{key!r}] = {stats.get(key)}, "
                     f"expected {v}")

    for name, want in MESH_NATIVE.items():
        prefix = tmp / f"mesh_{name}"
        native.drain_teardowns()
        t0 = time.perf_counter()
        solve_dataset_torch(None, cfg, src_paths=(str(paths[name]), None),
                            write_prefix=str(prefix), device=mesh)
        wall = time.perf_counter() - t0
        st = solve_dataset_torch.last_stats
        held(name, st, want)
        if outputs(prefix) != outputs(tmp / f"native_{name}"):
            fail(f"mesh {name}: output files differ from native.run")
        print(f"mesh end-to-end {name} native plane over {len(mesh)} "
              f"devices: files byte-equal to native.run; device "
              f"{st['device']} fallback {st['fallback']} buckets "
              f"{st['bucket_vs']}; wall {wall:.4f} s; launch_s "
              f"{st['launch_s']} sync_s {st['sync_s']} cfinish_s "
              f"{st['cfinish_s']}", flush=True)
    dataset = read_paf(str(paths["long2000"]))
    box = {}
    wall, busy = profiled_run(lambda: box.setdefault(
        "r", solve_dataset_torch(dataset, cfg, device=mesh)))
    st = solve_dataset_torch.last_stats
    held("long2000 python plane", st, MESH_PYTHON)
    prefix = tmp / "mesh_python_long2000"
    for suffix, outs, counts in zip((".aln", ".aln.alt", ".aln.all"),
                                    box["r"], (False, False, True)):
        with open(f"{prefix}{suffix}.paf", "w") as fh:
            write_outputs(dataset, outs, fh, name_suffix_counts=counts)
    if outputs(prefix) != outputs(tmp / "native_long2000"):
        fail("mesh long2000 python plane: output files differ from "
             "native.run")
    print(f"mesh end-to-end long2000 python plane over {len(mesh)} devices: "
          f"files byte-equal to native.run; device {st['device']} fallback "
          f"{st['fallback']} dense {st['dense_buckets']} int32 "
          f"{st['int32_buckets']}; {busy_text(wall, busy)}; pack_s "
          f"{st['pack_s']} finish_s {st['finish_s']}", flush=True)
    gcfg = dataclasses.replace(cfg, graph_shard_min_records=giant_rec)
    native.drain_teardowns()
    t0 = time.perf_counter()
    native.run(str(giant), out_prefix=str(tmp / "native_giant"), config=gcfg)
    shard_relax.rounds = 0
    t_native = time.perf_counter() - t0
    native.drain_teardowns()
    t0 = time.perf_counter()
    solve_dataset_torch(None, gcfg, src_paths=(str(giant), None),
                        write_prefix=str(tmp / "mesh_giant"), device=mesh)
    wall = time.perf_counter() - t0
    st = solve_dataset_torch.last_stats
    held("giant", st, dict(graph_sharded=1))
    if outputs(tmp / "mesh_giant") != outputs(tmp / "native_giant"):
        fail("mesh giant: output files differ from native.run")
    print(f"mesh end-to-end giant graph axis over {len(mesh)} devices: files "
          f"byte-equal to native.run ({t_native:.4f} s); graph_sharded "
          f"{st['graph_sharded']} shard_relax.rounds {shard_relax.rounds} "
          f"shard_s {st['shard_s']} device "
          f"{st['device']} fallback {st['fallback']} buckets "
          f"{st.get('bucket_vs')}; wall {wall:.4f} s", flush=True)
    return gcfg


def phase_mesh_profile(paths, giant, gcfg, cfg, mesh, tmp):
    """The native plane's mesh runs once more, each under torch.profiler,
    after the counted runs: wall and device busy.  On the card the
    profiler has recorded no event of the data axis's side streams
    (PERF.md §5), so a data-axis run's busy time is a lower bound; the
    graph axis runs on the devices' current streams."""
    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    for name, paf, c in (("karyotype10k", paths["karyotype10k"], cfg),
                         ("long2000", paths["long2000"], cfg),
                         ("giant", giant, gcfg)):
        native.drain_teardowns()
        wall, busy = profiled_run(lambda: solve_dataset_torch(
            None, c, src_paths=(str(paf), None),
            write_prefix=str(tmp / f"meshprof_{name}"), device=mesh))
        st = solve_dataset_torch.last_stats
        print(f"mesh profile {name}: {busy_text(wall, busy)}; pack_s "
              f"{st.get('pack_s')} shard_s {st.get('shard_s')} launch_s "
              f"{st.get('launch_s')} cfinish_s {st.get('cfinish_s')} write_s "
              f"{st.get('write_s')}", flush=True)



def phase_multihost(paf, tmp):
    """Two local ranks of the port's multihost with a gloo group over
    localhost; their files held to native.run's."""
    import importlib
    import socket

    importlib.import_module("alignasm_tpu_torch.parallel.multihost")
    mh = tmp / "multihost_long2000.paf"
    mh.write_bytes(paf.read_bytes())
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "alignasm_tpu_torch.parallel.multihost",
         str(mh), "--local-procs", "2", "--device-runtime", "--coordinator",
         f"localhost:{port}"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"multihost: exit {run.returncode}: {run.stderr[-2000:]}")
    if outputs(tmp / "multihost_long2000") != outputs(tmp / "native_long2000"):
        fail("multihost long2000: output files differ from native.run")
    print(f"multihost long2000: 2 local ranks, gloo group at localhost:"
          f"{port}; files byte-equal to native.run; {secs:.4f} s",
          flush=True)


# The bench phase: devbench's sections on the corpus size of the JAX
# bench's default, run as ``python -m alignasm_tpu_torch.runtime.devbench``
# as bench.py runs the JAX module; the kernels each section must launch.
BENCH_CONTIGS = 2000
BENCH_KERNELS = {"end_to_end": ("topo_scan",),
                 "topo": ("densify_wire", "topo_scan"),
                 "dense": ("sweep_dense",), "sparse": ("relax32",),
                 "bigv": ("densify_ragged", "blocked_dp")}
# the sweep's grid (devbench.bench_bigv_sweep's defaults): V x B x Bk
SWEEP_ROWS = 2 * 3 * 3


def devbench_lines(args, timeout):
    """The JSON lines of ``python -m alignasm_tpu_torch.runtime.devbench
    ARGS``, which must exit 0, and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "alignasm_tpu_torch.runtime.devbench", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if proc.returncode:
        fail(f"devbench {' '.join(args)} exited {proc.returncode}: "
             f"{proc.stdout[-1500:]} {proc.stderr[-2500:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")], secs


def keyed(obj, pred, path=""):
    """(path, value) of every key of the nested dicts and lists in ``obj``
    for which ``pred(key)`` holds."""
    items = obj.items() if isinstance(obj, dict) else enumerate(obj) \
        if isinstance(obj, list) else ()
    for k, v in items:
        if isinstance(k, str) and pred(k):
            yield f"{path}{k}", v
        yield from keyed(v, pred, f"{path}{k}.")


def check_bench_line(what, section, kernels):
    """No ``*_error`` and every ``bit_equal`` true in a section's object
    (at least one where it launches ``kernels``; end_to_end holds its
    files to native.run's instead), and every kernel of ``kernels``
    launched in it."""
    errors = list(keyed(section, lambda k: k.endswith("_error")))
    if errors:
        fail(f"bench {what}: {errors}")
    equal = list(keyed(section, lambda k: k == "bit_equal"))
    if not all(v is True for _p, v in equal) or (
            kernels and what != "end_to_end" and not equal):
        fail(f"bench {what}: bit_equal {equal}")
    for k in kernels:
        if section["launches"].get(k, 0) < 1:
            fail(f"bench {what}: kernel {k} was not launched "
                 f"({section['launches']})")


def phase_bench(card):
    """devbench's sections (end_to_end, kernels, bigv, then --bigv-sweep)
    in their own processes, each section held to its plain versions and
    its kernels' launches read from its line; then graft_entry.entry() on
    the card held to entry(device="cpu"), and dryrun_multichip over the
    mesh, each with the launch counts set to 0 just before and read just
    after.  Returns every kernel's launches in the phase."""
    import torch

    from alignasm_tpu_torch import graft_entry
    from alignasm_tpu_torch.ops import launch_counts, reset_launch_counts

    lines, secs = devbench_lines([str(BENCH_CONTIGS)], 900)
    if len(lines) != 5:
        fail(f"devbench {BENCH_CONTIGS}: {len(lines)} JSON lines, expected "
             f"three sections, the trailer and the merged object")
    e2e, kernels, bigv, trailer, merged = lines
    if trailer != {"sections_skipped": []}:
        fail(f"devbench {BENCH_CONTIGS}: trailer {trailer}")
    sections = {"end_to_end": e2e, **kernels.get("kernels", {}),
                "bigv": bigv.get("kernels", {}).get("bigv", {})}
    for name, want in BENCH_KERNELS.items():
        if name not in sections:
            fail(f"bench: no {name} section ({list(merged)})")
        check_bench_line(name, sections[name], want)
    check_bench_line("merged", merged, ())
    forced = e2e["cuda_engine_forced_stats"]
    if not e2e["files_byte_equal_native"] or forced["device"] < 1 \
            or "device_error" in forced or e2e["reps_done"] < 1:
        fail(f"bench end_to_end: files byte-equal "
             f"{e2e['files_byte_equal_native']}, forced device "
             f"{forced['device']}, reps {e2e['reps_done']}, "
             f"{forced.get('device_error')}")
    if e2e["launches"].get("densify_wire16", 0) \
            + e2e["launches"].get("densify_ragged", 0) < 1:
        fail(f"bench end_to_end: no densify launched ({e2e['launches']})")
    print(f"bench: devbench {BENCH_CONTIGS} in {secs:.1f} s ({card})",
          flush=True)
    print(f"bench end_to_end N={e2e['n_contigs']}: contigs/s auto "
          f"{e2e['cuda_engine_contigs_per_s']:.2f} (routed "
          f"{e2e['cuda_engine_stats'].get('routed')}), forced "
          f"{e2e['cuda_engine_forced_contigs_per_s']:.2f} (device "
          f"{forced['device']} fallback {forced['fallback']} buckets "
          f"{forced.get('bucket_vs')}), native in process "
          f"{e2e['native_inproc_contigs_per_s']:.2f}; cuda_vs_native_inproc "
          f"{e2e['cuda_vs_native_inproc']:.4f}; {e2e['reps_done']} reps; files "
          f"byte-equal to native.run; launches {e2e['launches']} "
          f"({e2e['device_kind']}, {e2e['power_limit']})", flush=True)
    topo = sections["topo"]
    marg = topo.get("marginal_s_per_contig")
    print(f"bench kernels topo B={topo['B']} V={topo['V']}: "
          f"{1e3 * topo['s_per_launch']:.4f} ms a launch (plain "
          f"{1e3 * topo['plain']['s_per_launch']:.4f}), marginal "
          + (f"{1e6 * marg:.5f} us/contig" if marg is not None
             else topo["marginal_note"])
          + f", chained {1e6 * topo['chained_s_per_contig']:.5f} us/contig "
          f"at B={topo['chained_B']}; bound {topo['bound_ms']:.6f} ms "
          f"({topo['bound_by']}), {topo['x_bound']:.1f}x, chained "
          f"{topo['chained_x_bound']:.2f}x; bit-equal ({card})", flush=True)
    for name in ("dense", "sparse"):
        s = sections[name]
        print(f"bench kernels {name} ({s['kernel']}) B={s['B']} V={s['V']} "
              f"n_sweeps={s['n_sweeps']}: {1e3 * s['s_per_launch']:.4f} ms a "
              f"launch (plain {1e3 * s['plain']['s_per_launch']:.4f}); bound "
              f"{s['bound_ms']:.6f} ms ({s['bound_by']}), {s['x_bound']:.1f}x; "
              f"jacobi {s['jacobi']} of {s['B']}; bit-equal ({card})",
              flush=True)
    bv, bb = sections["bigv"], sections["bigv"]["batched"]
    print(f"bench bigv V={bv['V']} E={bv['E']} Bk={bv['Bk']}: blocked "
          f"{1e3 * bv['blocked_s_per_launch']:.4f} ms (plain scan "
          f"{1e3 * bv['plain_s_per_launch']:.4f}, {bv['blocked_vs_plain']:.1f}x"
          f"), bound {bv['bound_ms']:.4f} ms, {bv['x_bound']:.1f}x; B={bb['B']} "
          f"{1e3 * bb['s_per_launch']:.4f} ms, {1e3 * bb['s_per_contig']:.4f} "
          f"ms/contig, {bb['x_bound']:.1f}x its bound; bit-equal ({card})",
          flush=True)
    counts = {}
    for s in sections.values():
        for k, n in s["launches"].items():
            counts[k] = counts.get(k, 0) + n

    lines, secs = devbench_lines(["--bigv-sweep"], 900)
    rows = [ln["bigv_sweep_row"] for ln in lines[:-1]]
    if len(rows) != SWEEP_ROWS or lines[-1].get("rows") != rows:
        fail(f"devbench --bigv-sweep: {len(rows)} rows, expected "
             f"{SWEEP_ROWS} streamed and the whole result")
    best = {}
    for r in rows:
        check_bench_line(f"bigv_sweep V={r['V']} B={r['B']} Bk={r['Bk']}", r,
                         ("densify_ragged", "blocked_dp"))
        for k, n in r["launches"].items():
            counts[k] = counts.get(k, 0) + n
        key = (r["V"], r["B"])
        if key not in best or r["s_per_launch"] < best[key]["s_per_launch"]:
            best[key] = r
    print(f"bench: devbench --bigv-sweep in {secs:.1f} s, {len(rows)} rows "
          f"bit-equal ({card})", flush=True)
    for (V, B), r in sorted(best.items()):
        each = ", ".join(f"Bk={o['Bk']} {1e3 * o['s_per_launch']:.4f}"
                         for o in rows if (o["V"], o["B"]) == (V, B))
        print(f"bench bigv_sweep V={V} B={B}: best Bk={r['Bk']} "
              f"{1e3 * r['s_per_launch']:.4f} ms ({each}); "
              f"{r['x_bound']:.1f}x its bound; first call "
              f"{r['warm_compile_s']:.3f} s ({card})", flush=True)

    reset_launch_counts()
    fn, args = graft_entry.entry()
    got = fn(*args)
    torch.cuda.synchronize()
    entry_counts = launch_counts()
    want_fn, want_args = graft_entry.entry(device="cpu")
    want = want_fn(*want_args)
    if sorted(got) != sorted(want) or not all(
            got[k].dtype == want[k].dtype and torch.equal(got[k].cpu(),
                                                          want[k])
            for k in want):
        fail("graft_entry.entry(): the card's relaxation disagrees with "
             "entry(device='cpu')")
    if entry_counts["relax64"] != 1:
        fail(f"graft_entry.entry(): relax64 launched "
             f"{entry_counts['relax64']} times, expected once")
    ms = cuda_ms(lambda: fn(*args), 10)
    print(f"bench graft_entry.entry(): B={args[0].shape[0]} "
          f"E={args[0].shape[1]} relax64 bit-equal to entry(device='cpu') on "
          f"{len(want)} keys; {ms:.4f} ms ({card})", flush=True)
    mesh = card_mesh()
    reset_launch_counts()
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(len(mesh), device=mesh)
    secs = time.perf_counter() - t0
    dry_counts = launch_counts()
    if dry_counts["shard_relax"] < 1 or \
            dry_counts["sweep_dense"] + dry_counts["relax32"] < 1:
        fail(f"dryrun_multichip: the graph axis or the data axis launched "
             f"nothing ({dry_counts})")
    print(f"bench dryrun_multichip over {', '.join(mesh)}: {secs:.1f} s; "
          f"launches {({k: v for k, v in dry_counts.items() if v})}",
          flush=True)
    return {k: counts.get(k, 0) + entry_counts[k] + dry_counts[k]
            for k in entry_counts}


# The routing phase: the calibration corpus's contigs (the JAX calibration's
# default), the corpora it routes, and tests/test_routing.py's two
# overrides: near-free transport launches every bucket, a 1000 s round trip
# gates every one.
CAL_CONTIGS = 20000
ROUTED = ("long2000", "karyotype10k")
LAUNCH_ALL = {"finish_vs_solve": 0.2, "dispatch_rtt_s": 1e-7,
              "h2d_bytes_per_s": 1e12, "d2h_bytes_per_s": 1e12,
              "device_s_per_contig": 1e-9, "device_s_per_step": 1e-9,
              "solve_s_per_record": 1e-3}
GATE_ALL = {"finish_vs_solve": 0.2, "dispatch_rtt_s": 1000.0}
COST_ENV = "ALIGNASM_TORCH_COSTMODEL"


def calibrate_into(path, card):
    """``python -m alignasm_tpu_torch.runtime.devbench --calibrate`` into
    ``path``; prints N, its seconds and every field beside the card's name
    and power limit, and checks that the port's ``_parse_model`` reads
    it."""
    from alignasm_tpu_torch.runtime import costmodel

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "alignasm_tpu_torch.runtime.devbench",
         "--calibrate", "--out", str(path), str(CAL_CONTIGS)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode:
        fail(f"devbench --calibrate exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    raw = json.loads(path.read_text())
    model, _prov = costmodel._parse_model(raw, "artifact", str(path))
    print(f"routing: devbench --calibrate N={CAL_CONTIGS} in {secs:.1f} s "
          f"({card})", flush=True)
    for k, v in raw.items():
        if k != "_meta":
            print(f"routing: calibration {k} = {v!r} ({card})", flush=True)
    meta = raw["_meta"]
    print(f"routing: calibration _meta device_kind {meta['device_kind']!r} "
          f"power_limit {meta['power_limit']!r} date {meta['date']} "
          f"details {json.dumps(meta['details'])}", flush=True)
    print(f"routing: calibration summary {json.dumps(model.summary())}",
          flush=True)
    return raw


def routed_run(name, paf, tmp, tag, device):
    """``solve_dataset_torch(None, DEFAULT_CONFIG, ...)`` ("auto") on
    ``paf`` under the calibration in ``$ALIGNASM_TORCH_COSTMODEL``, files
    held to native.run's, its launches counted from 0; returns (stats,
    launches)."""
    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.ops import launch_counts, reset_launch_counts
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    native.drain_teardowns()
    prefix = tmp / f"auto_{tag}_{name}"
    reset_launch_counts()
    t0 = time.perf_counter()
    solve_dataset_torch(None, DEFAULT_CONFIG, src_paths=(str(paf), None),
                        write_prefix=str(prefix), device=device)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    stats = solve_dataset_torch.last_stats
    if "device_error" in stats:
        fail(f"routing {tag} {name}: device path degraded: "
             f"{stats['device_error']}")
    if outputs(prefix) != outputs(tmp / f"native_{name}"):
        fail(f"routing {tag} {name}: output files differ from native.run")
    launched = {k: v for k, v in counts.items() if v}
    print(f"routing {tag} {name}: files byte-equal to native.run; routing "
          f"{stats['routing']} routed {stats.get('routed')} "
          f"device_routed_frac {stats['device_routed_frac']} device "
          f"{stats['device']} fallback {stats['fallback']} buckets_gated "
          f"{stats.get('buckets_gated', 0)} contigs_gated "
          f"{stats.get('contigs_gated', 0)}; launches {launched}; "
          f"{secs:.4f} s; cost_model {json.dumps(stats['cost_model'])}",
          flush=True)
    return stats, counts


def resume_run(paf, tmp, device):
    """Resume on the card: a journal pre-filled with the even-indexed
    contigs of ``paf`` through the native engine, then the command line
    ``--resume`` under the near-free model (in $ALIGNASM_TORCH_COSTMODEL):
    the odd ones go through solve_missing_torch_native on the card.  The
    files must equal native.run's; returns the launches."""
    import contextlib
    import io

    from alignasm_tpu_torch import cli
    from alignasm_tpu_torch.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.ops import launch_counts, reset_launch_counts
    from alignasm_tpu_torch.runtime.checkpoint import (
        Journal, contig_digest, solve_dataset_resumable,
    )
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    journal, full = tmp / "resume.journal", tmp / "resume_full.journal"
    dataset = read_paf(str(paf))
    t0 = time.perf_counter()
    solve_dataset_resumable(dataset, DEFAULT_CONFIG, str(full),
                            engine="native", src_paths=(str(paf), None))
    src, dst = Journal(str(full)), Journal(str(journal))
    try:
        for contig in dataset.contigs[::2]:
            key = contig_digest(contig, DEFAULT_CONFIG)
            dst.put(key, src.get(key))
    finally:
        src.close()
        dst.close()
    prefill = time.perf_counter() - t0
    solve_dataset_torch.last_stats = None
    reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.run([str(paf), "--resume", str(journal)], device=device)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    stats = solve_dataset_torch.last_stats
    if rc != 0 or stats is None:
        fail(f"resume: the command line exited {rc}: {out.getvalue()[-2000:]}")
    said = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("resume: ")]
    want = f"'resumed': {len(dataset.contigs[::2])}, 'solved': " \
           f"{len(dataset.contigs[1::2])}"
    if not said or want not in said[0]:
        fail(f"resume: expected {want}, the command line said {said}")
    if stats["device"] <= 0 or "device_error" in stats:
        fail(f"resume: no contig solved on the card ({stats})")
    stem = str(paf)[: -len(".paf")]
    if outputs(stem) != outputs(tmp / f"native_{paf.stem}"):
        fail("resume: output files differ from native.run")
    launched = {k: v for k, v in counts.items() if v}
    print(f"routing resume {paf.stem}: {said[0]}; files byte-equal to "
          f"native.run; device {stats['device']} fallback {stats['fallback']} "
          f"native_direct {stats['native_direct']} buckets "
          f"{stats['dense_buckets']}; launches {launched}; prefill (native "
          f"engine) {prefill:.4f} s, resumed run {secs:.4f} s", flush=True)
    return counts


def phase_routing(paths, always, tmp, device, card):
    """``device_routing="auto"`` on the card: calibrate, route long2000 and
    karyotype10k under that calibration, under near-free transport (no
    bucket gated; the device and fallback counts of the "always" run) and
    under a 1000 s round trip (every bucket gated), each byte-equal to
    native.run; then resume long2000 from a half-filled journal on the
    card.  Returns the launches of the near-free runs and of the resumed
    run."""
    import os

    saved = os.environ.get(COST_ENV)
    try:
        cal_path = tmp / "calibration.json"
        calibrate_into(cal_path, card)
        free, gate = tmp / "launch_all.json", tmp / "gate_all.json"
        free.write_text(json.dumps(LAUNCH_ALL))
        gate.write_text(json.dumps(GATE_ALL))
        free_counts = {}
        for name in ROUTED:
            os.environ[COST_ENV] = str(cal_path)
            st, _ = routed_run(name, paths[name], tmp, "calibrated", device)
            if st["cost_model"]["calibration"]["source"] != "env":
                fail(f"routing calibrated {name}: the calibration was not "
                     f"read ({st['cost_model']})")
            os.environ[COST_ENV] = str(free)
            st, counts = routed_run(name, paths[name], tmp, "near-free",
                                    device)
            want = always[name]["device"] + always[name]["fallback"]
            if st.get("buckets_gated", 0) or \
                    st["device"] + st["fallback"] != want:
                fail(f"routing near-free {name}: {st.get('buckets_gated', 0)} "
                     f"buckets gated, device + fallback "
                     f"{st['device'] + st['fallback']}, expected 0 and {want}")
            free_counts = {k: free_counts.get(k, 0) + v
                           for k, v in counts.items()}
            os.environ[COST_ENV] = str(gate)
            st, counts = routed_run(name, paths[name], tmp, "gate-all", device)
            if st["device"] or st.get("buckets_gated", 0) < 1 or any(
                    counts.values()):
                fail(f"routing gate-all {name}: device {st['device']}, "
                     f"{st.get('buckets_gated', 0)} buckets gated, launches "
                     f"{counts}")
        for k in ("densify_wire16", "densify_ragged", "topo_scan",
                  "blocked_dp"):
            if free_counts[k] < 1:
                fail(f"routing near-free: kernel {k} was not launched")
        os.environ[COST_ENV] = str(free)
        resume_counts = resume_run(paths["long2000"], tmp, device)
        if resume_counts["topo_scan"] < 1 or resume_counts["densify_ragged"] \
                + resume_counts["densify_wire16"] < 1:
            fail(f"routing resume: the densify and scan kernels were not "
                 f"launched ({resume_counts})")
    finally:
        if saved is None:
            os.environ.pop(COST_ENV, None)
        else:
            os.environ[COST_ENV] = saved
    return free_counts, resume_counts


def phases_one_card(paths, qs_paf, cfg, device, results, tmp, card):
    """Phases 2-5 on ``device``; returns each path's launch counts."""
    from alignasm_tpu_torch.ops import launch_counts, reset_launch_counts

    counts = {}
    chain = {"chain16k": write_chain16k(tmp)}
    cfg16 = dataclasses.replace(cfg, device_max_v=16384)
    phase_kernels(paths, cfg, device, results)
    phase_kernels(chain, cfg16, device, results)
    packed = phase_python_kernels(paths["long2000"], cfg, device, results)
    phase_topk(packed, device, results)
    phase_relax64_kernels(qs_paf, cfg, device, results)
    reset_launch_counts()
    always = phase_end_to_end(paths, cfg, device, tmp)
    phase_end_to_end(chain, cfg16, device, tmp)
    counts["native"] = launch_counts()
    reset_launch_counts()
    phase_python_plane("long2000", paths["long2000"], PYTHON_PLANE, cfg,
                       device, tmp)
    long2000 = launch_counts()
    reset_launch_counts()
    phase_python_plane("querysparse2000", qs_paf, QUERYSPARSE, cfg,
                       device, tmp)
    qs = launch_counts()
    if qs["relax64"] != len(QUERYSPARSE_BUCKETS[0]):
        fail(f"querysparse2000 python plane: relax64 launched "
             f"{qs['relax64']} times, expected one per int64 bucket")
    # the Python plane's launches: its sweep_dense and relax32 buckets
    # are long2000's, its int64 buckets querysparse2000's
    counts["python"] = {k: long2000[k] + qs[k] for k in qs}
    phase_profile(paths, cfg, device, tmp)
    counts["auto"], counts["resume"] = phase_routing(paths, always, tmp,
                                                     device, card)
    return counts


def main() -> int:
    mesh_only = sys.argv[1:] == ["--mesh"]
    if sys.argv[1:] and not mesh_only:
        fail(f"usage: {sys.argv[0]} [--mesh]")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: needs a CUDA device")
    if not (ROOT / "alignasm_tpu_torch" / "csrc").is_dir():
        fail(f"no alignasm_tpu_torch/csrc beside {__file__}: run it from a "
             "checkout of the repository")
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from alignasm_tpu_torch.ops import _build, launch_counts, reset_launch_counts

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    built = (f"built in {_build.build_seconds:.2f} s"
             if _build.build_seconds is not None else "reused")
    print(f"kernels: {_build.library_path().relative_to(ROOT)} {built} "
          f"(load {time.perf_counter() - t0:.2f} s; nvcc "
          f"{' '.join(_build.NVCC_FLAGS)})", flush=True)

    cfg = config()
    device = torch.device("cuda", 0)  # phases 2-5: one card
    results = {k: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
               for k in KERNELS}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    counts = {}
    try:
        t0 = time.perf_counter()
        paths = write_corpora(tmp)
        qs_paf = None if mesh_only else write_querysparse(paths["long2000"])
        print(f"corpora written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if not mesh_only:
            counts.update(phases_one_card(paths, qs_paf, cfg, device,
                                          results, tmp, card))
        else:
            from alignasm_tpu_torch import native

            for name in ("karyotype10k", "long2000"):
                native.run(str(paths[name]),
                           out_prefix=str(tmp / f"native_{name}"), config=cfg)
        mesh = card_mesh()
        giant = write_giant(tmp)
        giant_rec = phase_mesh_kernels(paths, giant, cfg, mesh, results)
        reset_launch_counts()
        gcfg = phase_mesh_end_to_end(paths, giant, giant_rec, cfg, mesh, tmp)
        counts["mesh"] = launch_counts()
        phase_mesh_profile(paths, giant, gcfg, cfg, mesh, tmp)
        if not mesh_only:
            phase_multihost(paths["long2000"], tmp)
            counts["bench"] = phase_bench(card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = sorted(m for m in sys.modules if m in ("jax", "alignasm_tpu")
                    or m.startswith(("jax.", "alignasm_tpu.")))
    if loaded:
        fail(f"a phase loaded JAX or the JAX package: {loaded}")
    lines = []
    for k, (src, rep, path) in KERNELS.items():
        if mesh_only and path != "mesh":
            continue
        if results[k]["ms"] <= 0:
            fail(f"kernel {k} was not held against its plain version")
        n = counts[path][k] if path in counts else None
        if n is not None and n < 1:
            fail(f"kernel {k} was not launched on the {path} plane's run")
        r = results[k]
        lines.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": None,
            "launches_auto_near_free": counts.get("auto", {}).get(k),
            "launches_resume": counts.get("resume", {}).get(k),
            "launches_mesh": counts["mesh"].get(k),
            "launches_bench": counts.get("bench", {}).get(k),
            "path": {"native": "native plane", "python": "Python plane",
                     "mesh": "mesh: data and graph axes (phase 6)",
                     "library": "library entry (phase 2 only)"}[path]})
    print(json.dumps({"kernels": lines}))
    print(f"total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
