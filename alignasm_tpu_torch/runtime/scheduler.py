"""Bucket scheduler of the device engine on PyTorch.

Counterpart of the native-plane device path of
``alignasm_tpu/runtime/scheduler.py`` (``_solve_tpu_native`` and what it
calls).  The C++ host plane (``alignasm_tpu.native``, shared with the JAX
package) parses the PAF, builds each contig's DAG and exports one sparse
wire per bucket; the device densifies the wire and runs one
reverse-topological scan per contig for buckets with V <= 256 (uint8 gate
rows ``[nxt, fast, src]``) or the blocked tropical solve for 256 < V <=
8192 (the same rows in int16) (ops/dense.py); ``finish_bulk8`` /
``finish_bulk16`` chase each path in C++ and ``write_results`` writes the
three PAF files.  The device only decides
which contigs take the fast finish, so the files are byte-identical to the
native engine's whatever it answers.  A host-plane failure (wire export,
finish) degrades the affected contigs to the native solve with the reason
in ``stats["device_error"]``; a kernel that fails to build, launch or run
raises.

This slice covers buckets with V <= 8192 on one device.
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import torch

from alignasm_tpu import native
from alignasm_tpu.config import AlignasmConfig
from alignasm_tpu_torch.ops.dense import (
    dense_solve_wire16_topo_nxt8, dense_solve_wire_topo_nxt8_ragged,
    dense_solve_wire_topo_nxt16_blocked_ragged,
)
from alignasm_tpu_torch.ops.wire import (
    as_device, ragged_to_device, wire16_to_device,
)

MAX_V = 256  # the scan and uint8 gate rows; above it the blocked solve
MAX_DEVICE_V = 8192  # a V = 16384 slab is 1 GB of int32 per contig


def _check_supported(cfg: AlignasmConfig, src_paths) -> None:
    """Raise NotImplementedError for what this slice does not cover yet,
    naming the ROADMAP.md item that will."""
    if src_paths is None:
        raise NotImplementedError(
            "the Python host plane (src_paths=None) is not ported yet "
            "(ROADMAP.md: 'Python-plane fallback')")
    if cfg.device_routing == "auto":
        raise NotImplementedError(
            "device_routing='auto' needs the port's own calibration; the "
            "JAX package's cost model was measured on a TPU (ROADMAP.md: "
            "'Port calibration and auto routing')")
    if cfg.device_routing != "always":
        raise NotImplementedError(
            f"device_routing={cfg.device_routing!r}: the port only runs the "
            "device path; use alignasm_tpu.native.run for a host-only run")
    if cfg.device_max_v > MAX_DEVICE_V:
        raise NotImplementedError(
            f"device_max_v={cfg.device_max_v} > {MAX_DEVICE_V}: a bucket "
            "of V = 16384 holds 1 GB of slab per contig and no corpus of "
            "the repo reaches it (ROADMAP.md: 'Buckets above V = 8192'); "
            f"set device_max_v <= {MAX_DEVICE_V}")


def _device_cap(cfg) -> int:
    """Vertex ceiling of the device engine: cfg.device_max_v bounded by
    32767, int16 topo positions in the gate rows (the JAX scheduler's
    _device_cap; _check_supported holds it to MAX_DEVICE_V)."""
    return min(cfg.device_max_v, 32767)


def _eligible_mask(meta, cfg):
    """Contigs the device may solve: built, at most _device_cap vertices,
    and a path-sum bound under 2^27 so every packed score and DP value
    fits the wire's 28-bit score field."""
    built = meta[:, 0] == 1
    n_v, bound = meta[:, 2], meta[:, 6]
    return built & (n_v <= _device_cap(cfg)) & (bound < 2**27)


def _next_pow2(x: int) -> int:
    """Padded vertex count (or small-V batch): the next power of two, at
    least 8."""
    return 1 << max(3, (x - 1).bit_length())


def _pad_batch(realB: int, V: int) -> int:
    """Padded batch of a bucket: the next power of two, at least 8 for
    V <= 256; big-V buckets drop the floor (as the JAX scheduler does), so
    a lone V = 8192 contig costs one 268 MB slab and one solve, not
    eight."""
    if V > MAX_V:
        return 1 << (realB - 1).bit_length()
    return _next_pow2(realB)


def _blocked_bk(padB: int) -> int:
    """Block size of the blocked solve: the JAX scheduler's rule, tuned on
    a TPU and a placeholder here until the port's calibration sets it
    (rows do not depend on it; PERF.md has both sizes' times on the
    H100)."""
    return 64 if padB == 1 else 32


def _dense_buckets(order, n_v, dense_cells: int = 2**26,
                   merge_cells: int = 2**25):
    """Partition ``order`` (contig indices sorted by vertex count) into
    ``(V, idxs)`` buckets: pow2-padded V per group (at least 8), each
    bucket's slabs holding at most ``dense_cells`` cells (256 MB of int32
    at the default).  Every contig lands in exactly one bucket, and
    n_v[idx] <= V in each.

    An adjacent V group merges into the next (its contigs pad up) while
    that adds at most ``merge_cells`` padding cells.  Every bucket has a
    fixed cost, mostly on the host (export, transfer, launch, finish):
    on an H100 each bucket fewer saved 4 to 9 ms of wall time, while the
    padding of a 2^25 threshold cost 0.34 ms of device time (PERF.md)."""
    sorted_v = n_v[order]
    groups = []  # [V, lo, hi]
    lo = 0
    while lo < len(order):
        V = _next_pow2(int(sorted_v[lo]))
        hi = int(np.searchsorted(sorted_v, V, side="right"))
        if groups:
            pV, plo, phi = groups[-1]
            if (phi - plo) * (V * V - pV * pV) <= merge_cells and \
                    (hi - plo) * V * V <= max(dense_cells, V * V):
                groups[-1] = [V, plo, hi]
                lo = hi
                continue
        groups.append([V, lo, hi])
        lo = hi
    buckets = []
    for V, lo, hi in groups:
        cap = max(1, dense_cells // (V * V))
        for s in range(lo, hi, cap):
            buckets.append((V, order[s:min(s + cap, hi)]))
    return buckets


def export_wire(exporter, V: int, idxs, n_edges, padB: int):
    """Export one bucket's wire on the host, the smallest transport first:
    the 16-bit wire for V <= 128 (it declines when its value table
    overflows), else the ragged int32 wire.

    Returns ``(kind, wire, ok, nbytes)``: ``kind`` is "wire16" or
    "ragged", ``wire`` the exporter's arrays, ``ok`` its per-contig accept
    mask (rejected contigs decode to empty slabs and their rows are
    dropped before the finish), ``nbytes`` the bytes to move."""
    w16 = exporter.export_wire16(idxs, V, n_edges, padB) if V <= 128 else None
    if w16 is not None:
        deltas, vidx, table, _n_real, seeds, ok = w16
        nbytes = deltas.nbytes + vidx.nbytes + table.nbytes + seeds.nbytes
        return "wire16", w16, ok, nbytes
    wire, ok, _cap = exporter.export_wire_ragged(idxs, V, n_edges, padB)
    return "ragged", wire, ok, wire.nbytes


def wire_to_device(kind: str, wire, device):
    """The tensors on ``device`` that ``kind``'s solve takes."""
    if kind == "wire16":
        return wire16_to_device(wire, device)
    return (ragged_to_device(wire, device),)


def solve_bucket(kind: str, args, padB: int, V: int):
    """(padB, V+2) gate rows of one exported bucket, on its device: uint8
    from the scan for V <= 256, int16 from the blocked solve above."""
    if kind == "wire16":
        return dense_solve_wire16_topo_nxt8(*args, B=padB, V=V)
    if V > MAX_V:
        return dense_solve_wire_topo_nxt16_blocked_ragged(
            *args, B=padB, V=V, Bk=_blocked_bk(padB))
    return dense_solve_wire_topo_nxt8_ragged(*args, B=padB, V=V)


def _rows_to_host(rows):
    """Start the rows' copy to the host.  On CUDA: a non-blocking copy
    into pinned memory, fenced by an event that must be synchronized
    before the host reads it.  Returns (host tensor, event or None)."""
    if rows.device.type != "cuda":
        return rows, None
    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    host.copy_(rows, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(rows.device))
    return host, ev


def _launch_buckets(buckets, n_edges, exporter, device, launches, stats):
    """Export each bucket's wire and launch its solve (asynchronous on
    CUDA); appends ``(idxs, realB, V, (host_rows, event), ok)`` to
    ``launches`` — ``ok`` is the accept mask when a contig was rejected,
    else None.

    A failing export stops the launches there, with the reason in
    ``stats["device_error"]``: that bucket's contigs and the later ones
    fall to the caller's native solve.  Errors of the transfer and the
    kernels propagate."""
    for V, idxs in buckets:
        realB = len(idxs)
        padB = _pad_batch(realB, V)
        try:
            kind, wire, ok, nbytes = export_wire(
                exporter, V, idxs, n_edges[idxs], padB)
        except Exception as exc:  # host plane: degrade to the native solve
            stats["device_error"] = f"export: {exc!r}"[:500]
            return
        if kind == "wire16":
            stats["wire16_buckets"] = stats.get("wire16_buckets", 0) + 1
        stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + nbytes
        rows = solve_bucket(kind, wire_to_device(kind, wire, device), padB, V)
        launches.append((idxs, realB, V, _rows_to_host(rows),
                         None if ok.all() else ok))
        stats["dense_buckets"] += 1
        stats.setdefault("bucket_vs", []).append(int(V))


def _device_assist(exporter, cfg: AlignasmConfig, meta, stats, device,
                   overlap=None):
    """Run the bucket device pipeline over the device-eligible contigs:
    bucket by padded V, export and launch every bucket, then per bucket
    wait for its rows and run the threaded C++ finish.

    ``overlap``: optional 0-arg callable run on a host thread while the
    main thread waits on the device (the caller's native solve of the
    non-device contigs).

    A failing export or finish (the host plane) leaves the affected
    contigs without stored results, for the caller's solve_remaining, and
    is recorded in ``stats["device_error"]`` with a RuntimeWarning.  A
    kernel build, launch or device fault raises, after the overlap thread
    has been joined."""
    idx_all = np.where(_eligible_mask(meta, cfg))[0]
    n_v, n_edges = meta[:, 2], meta[:, 3]
    order = idx_all[np.argsort(n_v[idx_all], kind="stable")]
    buckets = _dense_buckets(order, n_v)

    t0 = time.perf_counter()
    launches = []
    _launch_buckets(buckets, n_edges, exporter, device, launches, stats)
    stats["launch_s"] = round(time.perf_counter() - t0, 4)

    overlap_thread = None
    if overlap is not None:
        overlap_thread = threading.Thread(target=overlap, daemon=True)
        overlap_thread.start()

    sync_s = cfinish_s = 0.0
    try:
        for idxs, realB, V, (host, ev), ok in launches:
            t1 = time.perf_counter()
            if ev is not None:
                ev.synchronize()
            dp = host.numpy()[:realB]
            stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + dp.nbytes
            if ok is not None:
                dp = dp[ok]
                idxs = idxs[ok]
                if not len(idxs):
                    continue
            t2 = time.perf_counter()
            sync_s += t2 - t1
            try:
                finish = exporter.finish_bulk8 if dp.dtype == np.uint8 \
                    else exporter.finish_bulk16  # int16 gate rows
                n_fast, n_fb = finish(idxs, dp, V)
            except Exception as exc:  # host plane: degrade to native solve
                stats["device_error"] = f"finish: {exc!r}"[:500]
                cfinish_s += time.perf_counter() - t2
                continue
            cfinish_s += time.perf_counter() - t2
            stats["device"] += n_fast
            stats["fallback"] += n_fb
    finally:  # the exporter must outlive the overlap thread's solve
        if overlap_thread is not None:
            t1 = time.perf_counter()
            overlap_thread.join()
            stats["overlap_join_s"] = round(time.perf_counter() - t1, 4)
    if "device_error" in stats:
        warnings.warn("device path degraded to native solve: "
                      + stats["device_error"], RuntimeWarning, stacklevel=2)
    stats["sync_s"] = round(sync_s, 4)        # device wait + transfer
    stats["cfinish_s"] = round(cfinish_s, 4)  # threaded C++ finish


def _solve_torch_native(cfg: AlignasmConfig, src_paths, write_prefix, device,
                        stats):
    """The C++ host plane does parse -> graph build -> wire export ->
    device-assisted finish -> output writing; Python only orchestrates
    bucket-shaped launches.  Contigs outside the device envelope
    (singletons, oversize, over the vertex cap, over the score bound)
    solve natively on a host thread that overlaps the device wait."""
    t_start = time.perf_counter()
    native.tune_heap()
    exporter = native.GraphExporter(
        src_paths[0], alt_path=src_paths[1],
        alt_baseline=cfg.alt_baseline,
        non_skip_linkable=cfg.non_skip_linkable,
        max_records=max(cfg.max_device_records, _device_cap(cfg)),
        config=cfg,
    )
    try:
        n = len(exporter)
        meta = exporter.meta_bulk()
        n_rec = meta[:, 1]
        stats["singleton"] = int((n_rec == 1).sum())
        stats["oversize"] = int((n_rec > cfg.max_device_records).sum())
        stats["n_contigs"] = n
        stats["n_records"] = int(n_rec.sum())
        stats["pack_s"] = round(time.perf_counter() - t_start, 4)

        non_device = np.where(~_eligible_mask(meta, cfg))[0]
        exporter.prepare_results()  # pre-size result slots: the overlap
        # thread and the finish calls must not race a lazy resize
        overlap = None
        if len(non_device):
            def overlap(idx=non_device):
                t1 = time.perf_counter()
                try:
                    exporter.solve_subset(idx, format_out=True)
                except Exception as exc:  # surfaced via stats
                    stats["overlap_error"] = repr(exc)[:500]
                stats["overlap_solve_s"] = round(time.perf_counter() - t1, 4)

        _device_assist(exporter, cfg, meta, stats, device, overlap=overlap)
        # leftovers: export-rejected / device-error contigs (and the
        # overlap set if its thread failed)
        stats["native_direct"] = exporter.solve_remaining() \
            + len(non_device) - stats["singleton"]

        if write_prefix is not None:
            t0 = time.perf_counter()
            exporter.write_results(write_prefix)
            stats["write_s"] = round(time.perf_counter() - t0, 4)
            result = (None, None, None)
        else:
            result = exporter.fetch_results()
    finally:
        exporter.close()
    stats["total_s"] = round(time.perf_counter() - t_start, 4)
    return result


def solve_dataset_torch(dataset, cfg: AlignasmConfig, src_paths=None,
                        write_prefix=None, *, device):
    """Device engine on PyTorch: solve every contig of ``src_paths =
    (paf, alt_or_None)`` with the native host plane and the device
    kernels on ``device`` ("cpu" runs the plain PyTorch versions, "cuda"
    the CUDA kernels; a CUDA device that is not available raises).

    With ``write_prefix`` the three PAF files are written natively and
    (None, None, None) is returned; without it, the per-contig results.
    ``dataset`` is accepted for signature parity with solve_dataset_tpu
    and unused.  Stats land in ``solve_dataset_torch.last_stats``."""
    del dataset  # the native plane parses src_paths itself
    _check_supported(cfg, src_paths)
    dev = as_device(device)
    stats = {"device": 0, "fallback": 0, "singleton": 0, "oversize": 0,
             "host_plane": "native", "dense_buckets": 0, "native_direct": 0,
             "routing": cfg.device_routing, "torch_device": str(dev)}
    solve_dataset_torch.last_stats = stats
    return _solve_torch_native(cfg, src_paths, write_prefix, dev, stats)


solve_dataset_torch.last_stats = None
