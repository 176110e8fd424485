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
   every bucket, the scan on V <= 256, the blocked solve on V > 256 with
   both block sizes (Bk = 32 and 64), and the sweep solve's slab entry
   (``n_sweeps = V``) on long2000's widest V <= 256 slab bucket.  Python
   plane: packs long2000 as ``solve_dataset_torch(dataset, ...)`` does;
   the sweep solve on every dense bucket, the int32 sparse relaxation on
   every int32 bucket, and the dense shortest-path kernel (a library
   entry, no engine path calls it) on the dense buckets' contigs, its
   s / a rows held to the sweep solve's d_s / d_a.  Times both with CUDA
   events after a warm-up.
3. End to end, each path with the launch counts set to 0 just before it
   and read just after: the native plane, ``solve_dataset_torch(None,
   cfg, src_paths=...)`` at the default ``device_max_v`` (8192) on the
   three corpora, the three output files byte-compared with the port's
   ``native.run`` on the same input, the engine's counts held to the JAX
   device engine's; then the Python plane, ``solve_dataset_torch(
   read_paf(long2000), cfg)`` on the card, its files byte-compared with
   ``native.run``'s and its counts held to the JAX Python plane's.  Every
   kernel of a path must have launched in its run.

Then one JSON line of per-kernel results (``launches`` counted in phase
3, null for the library entries: ``dense_sp`` and the sweep solve's slab
entry, ``sweep_dense_slabs``; ``ms``/``plain_ms`` the kernel's and its
plain version's times summed over every bucket it ran on in phase 2, for
the blocked solve at the block size the scheduler picks; ``bound_ms``
the least time the card could take for the same work, from the bytes
each input and output moves once and the operations of one pass over
this run's edges or cells; ``library_ms`` null: no single PyTorch call
computes any of these functions), the card line again and, as the last
line, ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line.  Imports no JAX and nothing of the JAX package.
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
}
# The JAX Python plane's counts on long2000 (solve_dataset_tpu(read_paf(
# long2000), cfg) on the CPU, batch_size 256).
PYTHON_PLANE = dict(device=1952, fallback=34, singleton=14, oversize=0,
                    dense_buckets=6, int32_buckets=2)
# bigv: four chain contigs of tests/test_scale.py, (segments, seed) each,
# of 970 to 7,226 vertices.
BIGV = ((600, 11), (1200, 23), (2500, 35), (4500, 47))
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
    "dense_sp": ("alignasm_tpu_torch/csrc/dense_sp.cu",
                 "alignasm_tpu/ops/pallas_relax.py:160", "library"),
}
# The card's rates for the bound (H100 SXM data sheet, 700 W): device
# memory, and the issue rate of 32-bit scalar operations.  Each of an SM's
# four schedulers issues one 32-lane instruction a clock: 132 SMs x 128 a
# clock at the 1.98 GHz of the data sheet's 67 TFLOP/s float32, which
# counts an FMA as two operations, so 33.5e12 a second.  int32 add,
# compare, min and max run at half that (64 a clock per SM on compute
# capability 9.0: CUDA C++ Programming Guide, throughput of the arithmetic
# instructions); the issue rate keeps the bound a lower bound whatever
# the mix.
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12 / 2
# Operations of one pass, the least work of each function: the sweep
# kernels' vectors are DAG dynamic programs that one reverse-topological
# pass computes, however many Jacobi sweeps a kernel runs.  Per edge of
# the five vectors of the sweep solve and the int32 relaxation: the sum
# and anomaly adds, a lexicographic compare (4) and two selects; the
# floor's add and min; the walk count's add; the min-walk test's two
# compares, and, add.
PATH_OPS = 15
# Per edge of dense_sp's cascade: four adds, the f32 key's two
# conversions, clamp, division and negation, the four-key lexicographic
# compare (10), six selects.
DENSE_SP_OPS = 25
SCAN_OPS = 25        # per cell: three reduction rounds a row
FOLD_OPS = 15        # blocked solve: per upper-triangle cell, folded once


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
    operations its inputs need."""
    r = results[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain
    by_bytes, by_ops = 1e3 * nbytes / MEM_BYTES_PER_S, 1e3 * nops / OPS_PER_S
    r["bound_ms"] += max(by_bytes, by_ops)
    r["bytes_ms"] += by_bytes
    r["ops_ms"] += by_ops


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_scan(name, V, padB, slabs, results):
    """The scan kernel against its plain version on one V <= 256 bucket."""
    from alignasm_tpu_torch.ops import cuda_topo, dense

    rows = cuda_topo.topo_scan_nxt8(slabs)
    rows_p = dense.solve_slab_topo_nxt8(slabs)
    err = int((rows.int() - rows_p.int()).abs().max())
    if err:
        fail(f"{name} V={V} B={padB}: scan kernel disagrees with plain "
             f"(max_abs_err {err})")
    ms = cuda_ms(lambda: cuda_topo.topo_scan_nxt8(slabs), 20)
    plain = cuda_ms(lambda: dense.solve_slab_topo_nxt8(slabs), 3)
    record(results, "topo_scan", err, ms, plain, nbytes_of(slabs, rows),
           padB * V * V * SCAN_OPS)
    return (f"topo_scan {1000 * ms / padB:.4f} us/contig (plain "
            f"{1000 * plain / padB:.4f}; {ms:.4f} vs {plain:.4f} ms/bucket)")


def check_blocked(name, V, padB, slabs, results):
    """The blocked kernel against its plain version on one V > 256
    bucket, at both block sizes; the scheduler's size is recorded."""
    from alignasm_tpu_torch.ops import cuda_blocked, dense
    from alignasm_tpu_torch.runtime import scheduler as tsched

    parts = []
    for Bk in (32, 64):
        rows = cuda_blocked.blocked_dp_nxt16(slabs, Bk)
        rows_p = dense.solve_slab_topo_nxt16_blocked(slabs, Bk)
        err = int((rows.int() - rows_p.int()).abs().max())
        if err:
            fail(f"{name} V={V} B={padB} Bk={Bk}: blocked kernel disagrees "
                 f"with plain (max_abs_err {err})")
        ms = cuda_ms(lambda: cuda_blocked.blocked_dp_nxt16(slabs, Bk), 10)
        plain = cuda_ms(
            lambda: dense.solve_slab_topo_nxt16_blocked(slabs, Bk), 1)
        picked = Bk == tsched._blocked_bk(padB)
        if picked:
            record(results, "blocked_dp", err, ms, plain,
                   nbytes_of(slabs, rows), padB * V * V // 2 * FOLD_OPS)
        parts.append(
            f"blocked_dp Bk={Bk}{' (scheduler)' if picked else ''} "
            f"{1000 * ms / padB:.1f} us/contig (plain "
            f"{1000 * plain / padB:.1f}; {ms:.4f} vs {plain:.4f} ms/bucket)")
    return "; ".join(parts)


def check_slab_sweep(name, V, padB, slabs, results):
    """The sweep solve's slab entry (``dense_solve_slabs``, a library
    entry) against its plain version on one V <= 256 bucket, n_sweeps =
    V."""
    from alignasm_tpu_torch.ops import cuda_sweep, dense

    rows = cuda_sweep.sweep_dense_slabs(slabs, V)
    rows_p = dense.solve_slabs(slabs, V)
    err = int((rows.long() - rows_p.long()).abs().max())
    if err:
        fail(f"{name} V={V} B={padB}: sweep kernel (slabs) disagrees with "
             f"plain (max_abs_err {err})")
    ms = cuda_ms(lambda: cuda_sweep.sweep_dense_slabs(slabs, V), 5)
    plain = cuda_ms(lambda: dense.solve_slabs(slabs, V), 1)
    edges = int((slabs[:, :V] != dense.INF32).sum())
    record(results, "sweep_dense_slabs", err, ms, plain,
           nbytes_of(slabs, rows), edges * PATH_OPS)
    return f"sweep_dense_slabs {ms:.4f} ms (plain {plain:.4f})"


def phase_kernels(paths, cfg, device, results):
    """Each kernel against its plain version on every bucket."""
    import torch

    from alignasm_tpu_torch.ops import cuda_densify, dense
    from alignasm_tpu_torch.runtime import scheduler as tsched

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
            record(results, kname, err_d, d_ms, d_plain,
                   nbytes_of(*wire_in, slabs), 0)
            check = check_scan if V <= tsched.MAX_V else check_blocked
            solve = check(name, V, padB, slabs, results)
            if name == "long2000" and kind == "ragged" and V <= tsched.MAX_V:
                solve += "; " + check_slab_sweep(name, V, padB, slabs,
                                                 results)
            print(f"kernels {name} V={V} B={realB} padB={padB} wire={kind}: "
                  f"bit-equal; {kname} {d_ms:.4f} ms/bucket "
                  f"(plain {d_plain:.4f}); {solve}", flush=True)


def check_dense_sp(bucket, sweep_rows, device, results):
    """The dense shortest-path kernel against its plain version on the
    contigs of one dense bucket that ``pack_dense`` accepts; its s / a
    rows must equal the sweep solve's d_s / d_a (the same lex-min (sum,
    anom) after the same Jacobi sweeps).  Returns the contigs checked."""
    import numpy as np
    import torch

    from alignasm_tpu_torch.ops import cuda_dense_sp, dense_sp

    V, ns = bucket["V"], bucket["n_sweeps"]
    rows, mats, dests = [], [], []
    for b, (_i, pg) in enumerate(bucket["chunk"]):
        m = dense_sp.pack_dense(pg, V)
        if m is not None:
            rows.append(b)
            mats.append(m)
            dests.append(np.full((1, V), pg.g.dest, np.int32))
    if not rows:
        return 0
    ts = [torch.from_numpy(np.stack([m[k] for m in mats])).to(device)
          for k in range(5)]
    dest = torch.from_numpy(np.stack(dests)).to(device)
    got = cuda_dense_sp.dense_sp(*ts, dest, ns)
    want = dense_sp.dense_sp_plain(*ts, dest, ns)
    err = max(int((got[k].long() - want[k].long()).abs().max())
              for k in dense_sp.DSP_ROWS)
    if err:
        fail(f"long2000 python V={V}: dense_sp kernel disagrees with plain "
             f"(max_abs_err {err})")
    idx = torch.tensor(rows, device=device)
    for k, j in (("s", 0), ("a", 1)):
        if not torch.equal(got[k][:, 0], sweep_rows[idx, j]):
            fail(f"long2000 python V={V}: dense_sp {k} differs from the "
                 f"sweep solve's")
    ms = cuda_ms(lambda: cuda_dense_sp.dense_sp(*ts, dest, ns), 3)
    plain = cuda_ms(lambda: dense_sp.dense_sp_plain(*ts, dest, ns), 1)
    edges = int((ts[0] < dense_sp.INF32).sum())
    record(results, "dense_sp", err, ms, plain,
           nbytes_of(*ts, dest) + 6 * dest.numel() * 4, edges * DENSE_SP_OPS)
    return len(rows)


def phase_python_kernels(paf, cfg, device, results):
    """The Python plane's kernels against their plain versions on every
    bucket of ``paf``, packed and bucketed as solve_dataset_torch's
    Python plane does."""
    import numpy as np
    import torch

    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.ops import cuda_relax32, cuda_sweep, dense, relax32
    from alignasm_tpu_torch.runtime import scheduler as tsched

    t0 = time.perf_counter()
    stats = dict(singleton=0, oversize=0)
    _res, packed = tsched.pack_dataset(read_paf(str(paf)), cfg, stats)
    buckets = tsched.python_buckets(packed, cfg)
    print(f"python plane: {len(packed)} contigs packed into "
          f"{len(buckets)} buckets in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for bk in buckets:
        B, V, ns, kind = bk["B"], bk["V"], bk["n_sweeps"], bk["kind"]
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in bk["args"]]
        if kind == "dense":
            ws, wa, dest = args
            edge = ws < dense.INF32
            got = cuda_sweep.sweep_dense_batch(ws, wa, dest, ns)
            want = dense.solve_one(ws, wa, edge, dest, ns)
            k_fn = lambda: cuda_sweep.sweep_dense_batch(ws, wa, dest, ns)  # noqa: E731
            p_fn = lambda: dense.solve_one(ws, wa, edge, dest, ns)  # noqa: E731
            kname, edges = "sweep_dense", int(edge.sum())
        elif kind == "sparse32":
            got = cuda_relax32.relax32(*args, V, ns)
            want = relax32.sp_batch32_plain(*args, V, ns)
            k_fn = lambda: cuda_relax32.relax32(*args, V, ns)  # noqa: E731
            p_fn = lambda: relax32.sp_batch32_plain(*args, V, ns)  # noqa: E731
            kname, edges = "relax32", int(args[4].sum())
        else:
            fail(f"long2000 python: unexpected {kind} bucket (V={V})")
        err = int((got.long() - want.long()).abs().max())
        if err:
            fail(f"long2000 python V={V} B={B}: {kname} kernel disagrees "
                 f"with plain (max_abs_err {err})")
        ms, plain = cuda_ms(k_fn, 5), cuda_ms(p_fn, 1)
        record(results, kname, err, ms, plain, nbytes_of(*args, got),
               edges * PATH_OPS)
        extra = ""
        if kind == "dense":
            n = check_dense_sp(bk, got, device, results)
            extra = f"; dense_sp bit-equal on {n} contigs, s / a = sweep's"
        print(f"kernels long2000 python V={V} B={B} n_sweeps={ns} {kind}: "
              f"bit-equal; {kname} {ms:.4f} ms/bucket (plain {plain:.4f}; "
              f"{edges} edges){extra}", flush=True)


def outputs(prefix):
    return [pathlib.Path(f"{prefix}.aln{s}.paf").read_bytes()
            for s in ("", ".alt", ".all")]


def phase_end_to_end(paths, cfg, device, tmp):
    """The port's native plane vs native.run on each corpus."""
    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

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
        print(f"end-to-end {name} on {device}: {n} contigs, files byte-equal "
              f"to native.run; device {stats['device']} fallback "
              f"{stats['fallback']} native_direct {stats['native_direct']}; "
              f"buckets {stats['bucket_vs']} wire16 "
              f"{stats.get('wire16_buckets', 0)}; "
              f"{n / t_port:.1f} contigs/s ({t_port:.4f} s; launch_s "
              f"{stats['launch_s']} sync_s {stats['sync_s']} cfinish_s "
              f"{stats['cfinish_s']}) vs native.run {n / t_native:.1f} "
              f"contigs/s ({t_native:.4f} s, {nstats['contigs']} contigs)",
              flush=True)


def phase_python_plane(paf, cfg, device, tmp):
    """The Python plane on the card vs native.run's files on ``paf``
    (written by phase_end_to_end), counts held to the JAX Python
    plane's."""
    from alignasm_tpu_torch.io.paf import read_paf, write_outputs
    from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch

    t0 = time.perf_counter()
    dataset = read_paf(str(paf))
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = solve_dataset_torch(dataset, cfg, device=device)
    t_solve = time.perf_counter() - t0
    stats = solve_dataset_torch.last_stats
    prefix = tmp / "python_long2000"
    for suffix, outs, counts in zip((".aln", ".aln.alt", ".aln.all"), results,
                                    (False, False, True)):
        with open(f"{prefix}{suffix}.paf", "w") as fh:
            write_outputs(dataset, outs, fh, name_suffix_counts=counts)
    if outputs(prefix) != outputs(tmp / "native_long2000"):
        fail("long2000 python plane: output files differ from native.run")
    for key, want in PYTHON_PLANE.items():
        if stats.get(key) != want:
            fail(f"long2000 python plane: stats[{key!r}] = {stats.get(key)}, "
                 f"expected {want}")
    n = len(dataset.contigs)
    print(f"end-to-end long2000 python plane on {device}: {n} contigs, files "
          f"byte-equal to native.run; device {stats['device']} fallback "
          f"{stats['fallback']} singleton {stats['singleton']}; buckets dense "
          f"{stats['dense_buckets']} int32 {stats['int32_buckets']}; "
          f"read_paf {t_read:.4f} s, solve {t_solve:.4f} s ({n / t_solve:.1f} "
          f"contigs/s; pack_s {stats['pack_s']} launch_s {stats['launch_s']} "
          f"finish_s {stats['finish_s']})", flush=True)


def main() -> int:
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
    device = torch.device("cuda")
    results = {k: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
               for k in KERNELS}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    counts = {}
    try:
        t0 = time.perf_counter()
        paths = write_corpora(tmp)
        print(f"corpora written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        phase_kernels(paths, cfg, device, results)
        phase_python_kernels(paths["long2000"], cfg, device, results)
        reset_launch_counts()
        phase_end_to_end(paths, cfg, device, tmp)
        counts["native"] = launch_counts()
        reset_launch_counts()
        phase_python_plane(paths["long2000"], cfg, device, tmp)
        counts["python"] = launch_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = []
    for k, (src, rep, path) in KERNELS.items():
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
            "path": {"native": "native plane", "python": "Python plane",
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
