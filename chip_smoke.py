#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main path on one CUDA device.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   kernels of alignasm_tpu_torch/csrc with nvcc.
2. Kernel vs plain: exports every device bucket of the three corpora,
   runs each kernel and its plain PyTorch version on the same CUDA
   tensors, and requires bit-equal slabs and rows (all values are
   integers): the densify kernels on every bucket, the scan on V <= 256,
   the blocked solve on V > 256 with both block sizes (Bk = 32 and 64).
   Times both with CUDA events after a warm-up.
3. End to end: ``solve_dataset_torch(device="cuda")`` at the default
   ``device_max_v`` (8192) on the three corpora, the three output files
   byte-compared with ``alignasm_tpu.native.run`` on the same input, the
   engine's counts held to the JAX device engine's on the same corpora,
   and every kernel's launch counter > 0.

Then one JSON line of per-kernel results (``launches`` counted in phase
3; ``ms``/``plain_ms`` the kernel's and its plain version's times summed
over every bucket of the corpora, for the blocked solve at the block
size the scheduler picks; ``max_abs_err`` over all of phase 2),
the card line again and, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line.  Imports no JAX.
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
# bigv: four chain contigs of tests/test_scale.py, (segments, seed) each,
# of 970 to 7,226 vertices.
BIGV = ((600, 11), (1200, 23), (2500, 35), (4500, 47))
KERNELS = {
    "densify_wire16": ("alignasm_tpu_torch/csrc/densify.cu",
                       "alignasm_tpu/ops/dense.py:532"),
    "densify_ragged": ("alignasm_tpu_torch/csrc/densify.cu",
                       "alignasm_tpu/ops/dense.py:491"),
    "topo_scan": ("alignasm_tpu_torch/csrc/topo_scan.cu",
                  "alignasm_tpu/ops/pallas_topo.py:38"),
    "blocked_dp": ("alignasm_tpu_torch/csrc/blocked_dp.cu",
                   "alignasm_tpu/ops/dense.py:277"),
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def config():
    from alignasm_tpu.config import DEFAULT_CONFIG

    return dataclasses.replace(DEFAULT_CONFIG, device_routing="always")


def write_corpora(tmp: pathlib.Path) -> dict:
    from alignasm_tpu.testing.synth import config_karyotype, generate_paf

    sys.path.insert(0, str(ROOT / "tests"))  # the module alone, no conftest
    from test_scale import _chain_contig

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

    from alignasm_tpu import native
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


def record(results, name, err, ms, plain):
    r = results[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain


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
    record(results, "topo_scan", err, ms, plain)
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
            record(results, "blocked_dp", err, ms, plain)
        parts.append(
            f"blocked_dp Bk={Bk}{' (scheduler)' if picked else ''} "
            f"{1000 * ms / padB:.1f} us/contig (plain "
            f"{1000 * plain / padB:.1f}; {ms:.4f} vs {plain:.4f} ms/bucket)")
    return "; ".join(parts)


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
            record(results, kname, err_d, d_ms, d_plain)
            check = check_scan if V <= tsched.MAX_V else check_blocked
            solve = check(name, V, padB, slabs, results)
            print(f"kernels {name} V={V} B={realB} padB={padB} wire={kind}: "
                  f"bit-equal; {kname} {d_ms:.4f} ms/bucket "
                  f"(plain {d_plain:.4f}); {solve}", flush=True)


def outputs(prefix):
    return [pathlib.Path(f"{prefix}.aln{s}.paf").read_bytes()
            for s in ("", ".alt", ".all")]


def phase_end_to_end(paths, cfg, device, tmp):
    """The port's main path vs native.run on each corpus."""
    from alignasm_tpu import native
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
    results = {k: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0}
               for k in KERNELS}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        paths = write_corpora(tmp)
        print(f"corpora written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        phase_kernels(paths, cfg, device, results)
        reset_launch_counts()
        phase_end_to_end(paths, cfg, device, tmp)
        counts = launch_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, n in counts.items():
        if n < 1:
            fail(f"kernel {k} was not launched on the main path")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], **results[k]}
        for k, (src, rep) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
