"""Bucket scheduler of the device engine on PyTorch.

Counterpart of ``alignasm_tpu/runtime/scheduler.py:solve_dataset_tpu``:
its two host planes, each feeding the device kernels.

The native plane (``src_paths`` given; ``_solve_tpu_native`` and what it
calls there): the C++ host plane (``alignasm_tpu_torch.native``, the
port's copy of the JAX package's) parses the PAF, builds each contig's
DAG and exports one sparse wire per bucket; the device densifies the wire and runs one
reverse-topological scan per contig for buckets with V <= 256 (uint8 gate
rows ``[nxt, fast, src]``) or the blocked tropical solve for 256 < V <=
16384 (the same rows in int16) (ops/dense.py); ``finish_bulk8`` /
``finish_bulk16`` chase each path in C++ and ``write_results`` writes the
three PAF files.  The device only decides
which contigs take the fast finish, so the files are byte-identical to the
native engine's whatever it answers.  A host-plane failure (wire export,
finish) degrades the affected contigs to the native solve with the reason
in ``stats["device_error"]``; a kernel that fails to build, launch or run
raises.  It covers buckets with V <= 16384.  On a mesh of several devices
(parallel/mesh.py) a V <= 256 bucket ships the fixed-width wire and
shards its contigs over the mesh (the data axis), larger ones stay on the
mesh's first device, and a contig over both ``max_device_records`` and
``graph_shard_min_records`` relaxes with its edges sharded over the mesh
(the graph axis) before the buckets.  With
``device_routing="auto"`` (the default) the port's calibrated cost model
(runtime/costmodel.py) decides: when it predicts that no bucket can win,
nothing goes to the device, else each bucket goes only where it predicts
a win (``_gate_buckets``).  When nothing goes to the device (also with
``"never"``), a run that writes takes the fused ``native.run``
(``_solve_native_routed``), an in-memory run the exporter's native solve
of every contig.  ``solve_missing_torch_native`` runs the same pipeline
on a subset of the file's contigs (resume, runtime/checkpoint.py).

The Python plane (``src_paths=None``, a parsed ``dataset``; the JAX
package's test and degrade plane): per contig ``build_graph`` ->
``pack_graph`` in Python, buckets of ``batch_size`` contigs sorted by
(vertices, edges), each solved by the dense sweep solve (V <=
``dense_max_v``, ops/dense.py), the int32 sparse relaxation
(ops/relax32.py) or, when path sums may pass int32, the int64 one
(ops/relax.py, csrc/relax64.cu); then ``finish_contig``, or
``finish_contig_exact`` on ``Fallback``.  On a mesh the dense and int32
buckets shard their contigs over it and the graph axis takes the contigs
over both record thresholds, as in the JAX plane.  A ``NativeError`` of
the native plane degrades to it when a ``dataset`` was given, with a
RuntimeWarning and the reason in ``stats["native_error"]``.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from alignasm_tpu_torch import native
from alignasm_tpu_torch.config import AlignasmConfig
from alignasm_tpu_torch.ops.dense import (
    dense_solve_wire16_topo_nxt8, dense_solve_wire_topo_nxt8,
    dense_solve_wire_topo_nxt8_ragged,
    dense_solve_wire_topo_nxt16_blocked_ragged,
)
from alignasm_tpu_torch.ops.wire import ragged_to_device, wire16_to_device
from alignasm_tpu_torch.parallel.mesh import as_mesh, gather, launch_sharded
from alignasm_tpu_torch.runtime import tracing
from alignasm_tpu_torch.runtime.tracing import span

MAX_V = 256  # the scan and uint8 gate rows; above it the blocked solve
# A V = 16384 bucket holds one contig (_dense_buckets), a 1.07 GB slab.
# Above it the ragged wire's int32 flat index (native/__init__.py,
# trash + M < 2**31) cannot address a V = 32768 slab.
MAX_DEVICE_V = 16384


def _check_supported(cfg: AlignasmConfig) -> None:
    """Raise NotImplementedError for a device route the native plane does
    not cover, with the reason."""
    if cfg.device_max_v > MAX_DEVICE_V:
        raise NotImplementedError(
            f"device_max_v={cfg.device_max_v} > {MAX_DEVICE_V}: the ragged "
            "wire's int32 flat index cannot address a slab of V = 32768 "
            "(the JAX engine cannot run it either); set device_max_v <= "
            f"{MAX_DEVICE_V}")


class Route(NamedTuple):
    """The routing decision of the JAX scheduler's solve_dataset_tpu."""
    allow_device: bool  # may any contig go to the device
    gate: object  # the cost model that gates each bucket ("auto"), or None
    cost_model: dict  # stats["cost_model"]: the model and its calibration


def _routing(cfg: AlignasmConfig) -> Route:
    """``"always"`` sends every eligible contig to the device; ``"auto"``
    only where the calibrated cost model can predict a win
    (``any_possible_win``), bucket by bucket (``_gate_buckets``); anything
    else, ``"never"`` included, routes every contig to the native plane.
    A device route that is not covered raises (``_check_supported``)."""
    from alignasm_tpu_torch.runtime.costmodel import load_model_info

    model, model_prov = load_model_info()
    mode = cfg.device_routing
    allow_device = mode == "always" or (
        mode == "auto" and model.any_possible_win())
    if allow_device:
        _check_supported(cfg)
    return Route(allow_device, model if mode == "auto" else None,
                 {**model.summary(),
                  "calibration": model_prov or {"source": "defaults"}})


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


# Block size of the blocked solve, the same at every batch size: an A/B of
# Bk = 32, 64, 128 and 256 on every bigv and long2000 bucket in one
# ``chip_smoke.py`` run (NVIDIA H100 80GB HBM3, 700.00 W power limit;
# PERF.md) put 64 first over the four buckets, 4.6853 ms against 4.8600 at
# 128, 5.5031 at 32 and 9.4255 at 256, and first on three of them (128 was
# 2.4 % faster on long2000's V = 512, padB 256 bucket).  A block step's
# cost grows with Bk / 32, the columns a lane holds, while the launches
# fall with V / Bk.  The rows do not depend on Bk when no edge (r, dest)
# comes from a row r past dest, as on exporter wires.
BLOCKED_BK = 64


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
            *args, B=padB, V=V, Bk=BLOCKED_BK)
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


def _pad_rows(arrays, padB: int):
    """Pad each array's dim 0 to ``padB`` rows by repeating its last row
    (the JAX data mesh's padding; the caller drops the padded rows)."""
    B = arrays[0].shape[0]
    if padB == B:
        return arrays
    return tuple(np.concatenate([a, np.repeat(a[-1:], padB - B, 0)])
                 for a in arrays)


def _mesh_rows(B: int, n: int) -> int:
    """``B`` rounded up to a multiple of the mesh's ``n`` entries."""
    return -(-B // n) * n


def data_axis_wire(wire, ok, idxs, n: int):
    """A V <= 256 bucket's fixed-width wire as the data axis launches it
    over ``n`` mesh entries: rejected contigs dropped (the caller's native
    solve takes them), then the rows padded to a multiple of ``n`` by
    repeating the last row.  The JAX scheduler pads B to a power of two
    first to bound its compiled shapes; the kernels here compile nothing
    per shape, so those rows would only add work.  Returns (wire, idxs,
    realB)."""
    if not ok.all():
        wire, idxs = wire[ok], idxs[ok]
    realB = len(idxs)
    if realB:
        (wire,) = _pad_rows((wire,), _mesh_rows(realB, n))
    return wire, idxs, realB


def _launch_data_axis(wire, ok, V: int, idxs, mesh, launches, stats) -> None:
    """One V <= 256 bucket over the data axis (the JAX scheduler's
    ``_launch_buckets`` on a mesh), from its fixed-width wire
    (``data_axis_wire``), each shard solved on its mesh entry."""
    wire, idxs, realB = data_axis_wire(wire, ok, idxs, len(mesh))
    if not realB:
        return
    parts = launch_sharded(mesh, (wire,),
                           lambda w: dense_solve_wire_topo_nxt8(w, V))
    launches.append((idxs, realB, V, parts, None))
    stats["dense_buckets"] += 1
    stats.setdefault("bucket_vs", []).append(int(V))


def _launch_buckets(buckets, n_edges, exporter, mesh, launches, stats):
    """Export each bucket's wire and launch its solve (asynchronous on
    CUDA); appends ``(idxs, realB, V, parts, ok)`` to ``launches`` —
    ``parts`` the rows' pending copies to the host (``mesh.gather``), ``ok``
    the accept mask when a contig was rejected, else None.  On a mesh of
    several devices a V <= 256 bucket takes the data axis
    (``_launch_data_axis``); every other bucket runs on mesh[0].

    A failing export stops the launches there, with the reason in
    ``stats["device_error"]``: that bucket's contigs and the later ones
    fall to the caller's native solve.  Errors of the transfer and the
    kernels propagate."""
    device = mesh[0]
    for V, idxs in buckets:
        if len(mesh) > 1 and V <= MAX_V:
            # the fixed-width wire: W the next power of two above the
            # widest contig's edges + 2
            W = _next_pow2(int(n_edges[idxs].max()) + 2)
            try:
                wire, ok = exporter.export_wire(idxs, V, W)
            except Exception as exc:  # host plane: degrade to native solve
                stats["device_error"] = f"export: {exc!r}"[:500]
                return
            _launch_data_axis(wire, ok, V, idxs, mesh, launches, stats)
            continue
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
        launches.append((idxs, realB, V, [_rows_to_host(rows)],
                         None if ok.all() else ok))
        stats["dense_buckets"] += 1
        stats.setdefault("bucket_vs", []).append(int(V))


def _gate_buckets(buckets, meta, model, stats):
    """The cost gate of ``device_routing="auto"`` (the JAX scheduler's
    ``_device_assist``): keep a bucket only when ``model`` predicts that
    its device route beats the native solve of its contigs, from the JAX
    package's byte estimates (an int32 pair per edge of ragged wire, a
    V + 2 byte row per contig).  Gated buckets and their contigs are
    counted in ``stats["buckets_gated"]`` / ``["contigs_gated"]`` and fall
    to the caller's native solve."""
    n_rec, n_edges = meta[:, 1], meta[:, 3]
    kept = []
    for V, idxs in buckets:
        wire_b = int(n_edges[idxs].sum()) * 8 + 64
        row_b = len(idxs) * (V + 2)
        if model.bucket_profitable(len(idxs), int(V), wire_b, row_b,
                                   int(n_rec[idxs].sum())):
            kept.append((V, idxs))
        else:
            stats["buckets_gated"] = stats.get("buckets_gated", 0) + 1
            stats["contigs_gated"] = stats.get("contigs_gated", 0) + len(idxs)
    return kept


def _device_assist(exporter, cfg: AlignasmConfig, meta, idx_pool, stats,
                   mesh, overlap=None, model=None):
    """Run the bucket device pipeline over the device-eligible members of
    ``idx_pool`` (contig indices into the exporter): bucket by padded V,
    export and launch every bucket, then per bucket wait for its rows and
    run the threaded C++ finish.  With a cost ``model``
    (``device_routing="auto"``) only the buckets it predicts to win are
    launched (``_gate_buckets``).

    ``overlap``: optional 0-arg callable run on a host thread while the
    main thread waits on the device (the caller's native solve of the
    non-device contigs, a set disjoint from ``idx_pool``'s eligible
    members).

    A failing export or finish (the host plane) leaves the affected
    contigs without stored results, for the caller's native solve, and
    is recorded in ``stats["device_error"]`` with a RuntimeWarning.  A
    kernel build, launch or device fault raises, after the overlap thread
    has been joined.

    Returns the contig indices whose results the finish stored."""
    with span(stats, "bucket_s", tracing.BUCKET):
        pool_mask = np.zeros(len(meta), bool)
        pool_mask[idx_pool] = True
        idx_all = np.where(_eligible_mask(meta, cfg) & pool_mask)[0]
        n_v, n_edges = meta[:, 2], meta[:, 3]
        order = idx_all[np.argsort(n_v[idx_all], kind="stable")]
        buckets = _dense_buckets(order, n_v)
        if model is not None:
            buckets = _gate_buckets(buckets, meta, model, stats)
    if len(mesh) > 1:
        stats["data_mesh_devices"] = len(mesh)

    launches = []
    with span(stats, "launch_s", tracing.LAUNCH):
        _launch_buckets(buckets, n_edges, exporter, mesh, launches, stats)

    with span(stats, "overlap_start_s", tracing.START):
        overlap_thread = None
        if overlap is not None:
            overlap_thread = threading.Thread(target=overlap, daemon=True)
            overlap_thread.start()

    # stats: finish_s wait + finish, sync_s device wait + transfer,
    # cfinish_s the threaded C++ finish
    stats["sync_s"] = stats["cfinish_s"] = 0.0
    covered = []
    with span(stats, "finish_s"):
        try:
            for idxs, realB, V, parts, ok in launches:
                with span(stats, "sync_s", tracing.SYNC) as sync:
                    dp = gather(parts)[:realB]
                    stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + dp.nbytes
                    if ok is not None:
                        dp = dp[ok]
                        idxs = idxs[ok]
                if not len(idxs):
                    continue
                with span(stats, "cfinish_s", tracing.FINISH) as fin:
                    try:
                        finish = exporter.finish_bulk8 \
                            if dp.dtype == np.uint8 \
                            else exporter.finish_bulk16  # int16 gate rows
                        n_fast, n_fb = finish(idxs, dp, V)
                    except Exception as exc:  # host plane: degrade
                        stats["device_error"] = f"finish: {exc!r}"[:500]
                        continue
                stats.setdefault("bucket_phases", []).append(
                    (int(V), int(len(idxs)), round(sync.seconds, 4),
                     round(fin.seconds, 4)))
                covered.append(idxs)
                stats["device"] += n_fast
                stats["fallback"] += n_fb
        finally:  # the exporter must outlive the overlap thread's solve
            with span(stats, "overlap_join_s", tracing.WAIT):
                if overlap_thread is not None:
                    overlap_thread.join()
    if "device_error" in stats:
        warnings.warn("device path degraded to native solve: "
                      + stats["device_error"], RuntimeWarning, stacklevel=2)
    return np.concatenate(covered) if covered else np.empty(0, np.int64)


def _solve_native_routed(cfg: AlignasmConfig, src_paths, write_prefix,
                         cost_model):
    """The routing sent the whole corpus away from the device (``"never"``,
    or ``"auto"`` under a cost model that predicts no win) and the caller
    wants output files: the fused native pipeline, as ``--engine native``
    runs it, with the decision and its calibration in the stats (the JAX
    scheduler's ``_solve_native_routed``)."""
    t0 = time.perf_counter()
    alt = src_paths[1]
    if alt and os.path.getsize(alt) == 0:
        alt = None  # a zero-size alt disables the merge, as in the reference
    run_stats = native.run(
        src_paths[0], alt_path=alt, alt_baseline=cfg.alt_baseline,
        non_skip_linkable=cfg.non_skip_linkable, threads=0,
        out_prefix=write_prefix, config=cfg,
    )
    solve_dataset_torch.last_stats = {
        "device": 0, "fallback": 0, "singleton": 0, "oversize": 0,
        "host_plane": "native", "routing": cfg.device_routing,
        "routed": "fused-native", "device_routed_frac": 0.0,
        "cost_model": cost_model,
        "written_natively": True,
        "read_s": run_stats["read_s"], "solve_s": run_stats["solve_s"],
        "write_s": run_stats["write_s"],
        "n_contigs": run_stats["contigs"],
        "n_records": run_stats["records"],
        "total_s": round(time.perf_counter() - t0, 4),
    }
    return (None, None, None)


def _open_exporter(cfg: AlignasmConfig, src_paths, threads: int = 0):
    """One parse of the source files by the C++ host plane, keeping every
    contig the device could take."""
    return native.GraphExporter(
        src_paths[0], alt_path=src_paths[1],
        alt_baseline=cfg.alt_baseline,
        non_skip_linkable=cfg.non_skip_linkable,
        max_records=max(cfg.max_device_records, _device_cap(cfg)),
        config=cfg, threads=threads,
    )


def _mesh_name(mesh) -> str:
    return ", ".join(map(str, mesh))


def _native_stats(cfg: AlignasmConfig, route: Route, mesh) -> dict:
    """A native-plane run's stats, published as
    ``solve_dataset_torch.last_stats`` before the run starts."""
    stats = {"device": 0, "fallback": 0, "singleton": 0, "oversize": 0,
             "host_plane": "native", "dense_buckets": 0, "native_direct": 0,
             "routing": cfg.device_routing, "cost_model": route.cost_model}
    if route.allow_device:
        stats["torch_device"] = _mesh_name(mesh)
    solve_dataset_torch.last_stats = stats
    return stats


def _route_pool(exporter, cfg: AlignasmConfig, meta, pool, stats, mesh,
                route: Route, threads: int = 0, format_out: bool = False):
    """Solve the contigs of ``pool`` (sorted indices into the exporter) as
    ``route`` says.  With the device allowed, the bucket device pipeline
    takes the eligible members (``_device_assist``) while the others
    solve natively on a host thread that overlaps the device wait;
    without it, every member solves natively here.  A failing native
    solve is recorded in ``stats["overlap_error"]`` and leaves its
    contigs without results.

    Returns ``(covered, non_device)``: the indices whose results the
    device finish stored, and the ones handed to the native solve.  The
    caller solves what neither left a result for."""
    with span(stats, "bucket_s", tracing.BUCKET):
        eligible = _eligible_mask(meta, cfg) if route.allow_device \
            else np.zeros(len(meta), bool)
        non_device = pool[~eligible[pool]]
        exporter.prepare_results()  # pre-size result slots: the overlap
        # thread and the finish calls must not race a lazy resize

    def solve_non_device():
        # no label: a span on this thread would claim the main thread's
        # idle time in the trace
        with span(stats, "overlap_solve_s"):
            try:
                exporter.solve_subset(non_device, threads=threads,
                                      format_out=format_out)
            except Exception as exc:  # the caller solves the set again
                stats["overlap_error"] = repr(exc)[:500]

    overlap = solve_non_device if len(non_device) else None
    if not route.allow_device:
        if overlap is not None:
            overlap()
        return np.empty(0, np.int64), non_device
    covered = _device_assist(exporter, cfg, meta, pool, stats, mesh,
                             overlap=overlap, model=route.gate)
    return covered, non_device


def _graph_axis(exporter, cfg: AlignasmConfig, n_rec, stats, mesh):
    """The native plane's graph axis (the JAX scheduler's
    ``_solve_tpu_native`` on a mesh): each contig over both
    ``max_device_records`` and ``graph_shard_min_records`` relaxes
    edge-sharded over ``mesh`` and finishes in C++, which stores its
    result.  A host-plane failure (``NativeError``: graph build, edge
    export, finish) stops the graph axis with the reason in
    ``stats["device_error"]``, and the native solve covers the contig and
    the later ones; a kernel failure raises.  Returns the contigs done."""
    from alignasm_tpu_torch.parallel.mesh import solve_contig_sharded_native

    big = np.where((n_rec > cfg.max_device_records)
                   & (n_rec >= cfg.graph_shard_min_records))[0]
    if not len(big):
        return np.empty(0, np.int64)
    t0 = time.perf_counter()
    done = []
    for i in big:
        try:
            solve_contig_sharded_native(exporter, int(i), cfg, mesh)
        except native.NativeError as exc:
            stats["device_error"] = f"shard: {exc!r}"[:500]
            warnings.warn("graph axis degraded to native solve: "
                          + stats["device_error"], RuntimeWarning,
                          stacklevel=3)
            break
        done.append(i)
        stats["graph_sharded"] = stats.get("graph_sharded", 0) + 1
    stats["shard_s"] = round(time.perf_counter() - t0, 4)
    return np.asarray(done, np.int64)


def _solve_torch_native(dataset, cfg: AlignasmConfig, src_paths, write_prefix,
                        mesh, route: Route):
    """The C++ host plane does parse -> graph build -> wire export ->
    device-assisted finish -> output writing; Python only orchestrates
    bucket-shaped launches (``_route_pool``).  Contigs outside the device
    envelope (singletons, oversize, over the vertex cap, over the score
    bound) solve natively on a host thread that overlaps the device wait,
    and every contig does when the route keeps the device out.  A
    ``dataset`` must hold the file's contigs (AssertionError otherwise, as
    in the JAX scheduler).  On a mesh of several devices the graph axis
    (``_graph_axis``) runs first."""
    stats = _native_stats(cfg, route, mesh)
    exporter = None
    with span(stats, "total_s"):
        try:
            with span(stats, "pack_s", tracing.PACK):
                with span(stats, "pack_open_s"):
                    native.tune_heap()
                    exporter = _open_exporter(cfg, src_paths)
                n = len(exporter)
                if dataset is not None and n != len(dataset.contigs):
                    raise AssertionError("native/python contig count mismatch")
                meta = exporter.meta_bulk()
                n_rec = meta[:, 1]
                stats["singleton"] = int((n_rec == 1).sum())
                stats["oversize"] = int((n_rec > cfg.max_device_records).sum())
                stats["n_contigs"] = n
                stats["n_records"] = int(n_rec.sum())

            pool = np.arange(n)
            if route.allow_device and len(mesh) > 1:
                pool = np.setdiff1d(pool, _graph_axis(exporter, cfg, n_rec,
                                                      stats, mesh))
            _covered, non_device = _route_pool(
                exporter, cfg, meta, pool, stats, mesh, route,
                format_out=write_prefix is not None)
            if not route.allow_device:
                stats["routed"] = "native-plane"
            # leftovers: export-rejected / gated / device-error contigs
            # (and the non-device set if its native solve failed)
            with span(stats, "remaining_s", tracing.NATIVE_SOLVE):
                n_left = exporter.solve_remaining()
            stats["native_direct"] = n_left + len(non_device) \
                - stats["singleton"]
            stats["device_routed_frac"] = round(stats["device"] / n, 4) \
                if n else 0.0

            if write_prefix is not None:
                with span(stats, "write_s", tracing.WRITE):
                    exporter.write_results(write_prefix)
                stats["written_natively"] = True
                result = (None, None, None)
            else:
                result = exporter.fetch_results()
        finally:
            if exporter is not None:
                with span(stats, "close_s", tracing.CLOSE):
                    exporter.close()
    return result


def _fits32(pg) -> bool:
    """int32 eligibility of a packed contig (the JAX plane's ``fits32``):
    every path sum is bounded by the sum over vertices of their largest
    outgoing edge score, held under 2^29, well under the int32 kernels'
    2^30 sentinel."""
    if len(pg.eu) == 0:
        return True
    seg_max = {}
    for u, s in zip(pg.eu.tolist(), pg.es.tolist()):
        if s > seg_max.get(u, -1):
            seg_max[u] = s
    return sum(seg_max.values()) < 2**29


def pack_dataset(dataset, cfg: AlignasmConfig, stats, mesh=None):
    """The Python plane's host packing (the JAX plane's first loop):
    singletons and contigs over ``max_device_records`` records solve with
    the exact engine right away, except that on a ``mesh`` of several
    devices a contig of at least ``graph_shard_min_records`` records takes
    the graph axis (``parallel/mesh.py:solve_contig_sharded``, counted in
    ``stats["graph_sharded"]``); every other contig is built and packed.

    Returns ``(results, packed)``: ``results[i]`` the (out, alt, max)
    triple of contig i or None, ``packed`` a list of (i, PackedGraph)."""
    from alignasm_tpu_torch.engine.device import pack_graph
    from alignasm_tpu_torch.engine.exact import solve_contig
    from alignasm_tpu_torch.engine.graph import build_graph
    from alignasm_tpu_torch.parallel.mesh import solve_contig_sharded

    results = [None] * len(dataset.contigs)
    packed = []
    for i, contig in enumerate(dataset.contigs):
        if len(contig) == 1:
            results[i] = solve_contig(contig, cfg)
            stats["singleton"] += 1
            continue
        if len(contig) > cfg.max_device_records:
            if (mesh is not None and len(mesh) > 1
                    and len(contig) >= cfg.graph_shard_min_records):
                results[i] = solve_contig_sharded(contig, cfg, mesh)
                stats["graph_sharded"] = stats.get("graph_sharded", 0) + 1
            else:
                results[i] = solve_contig(contig, cfg)
            stats["oversize"] += 1
            continue
        packed.append((i, pack_graph(build_graph(contig, cfg))))
    return results, packed


def topo_hint(pg, V: int):
    """(V,) int32 topological order of a PackedGraph's vertices, padded to
    V, derived from ``erank`` alone: its high bits are each edge target's
    position in the Kahn order of the reversed graph
    (engine/device.py:pack_graph), so an edge u -> v has kahn_pos[u] >
    kahn_pos[v].  Vertices that are no edge's target come first (nothing
    points into them), then the targets by that position descending, then
    the padding vertices: every edge goes from an earlier position to a
    later one.  It is the solve kernels' hint (csrc/topo_pass.cuh,
    csrc/relax64.cu), which they check before they trust it."""
    from alignasm_tpu_torch.engine.device import _RANK_SHIFT

    n = pg.g.n_vertices
    kahn_pos = np.full(n, -1, np.int64)
    kahn_pos[pg.ev] = pg.erank >> _RANK_SHIFT
    targets = np.flatnonzero(kahn_pos >= 0)
    return np.concatenate([
        np.flatnonzero(kahn_pos < 0),
        targets[np.argsort(-kahn_pos[targets], kind="stable")],
        np.arange(n, V),
    ]).astype(np.int32)


def python_buckets(packed, cfg: AlignasmConfig, batch_size: int = 256):
    """Bucket the packed contigs as the JAX plane does: sorted by
    (vertices, edges), ``batch_size`` per bucket, V and E padded to
    powers of two (at least 8), ``n_sweeps`` the next power of two above
    the largest record count + 2.  A bucket is "dense" ((B, V, V)
    matrices) when every contig fits int32 and V <= ``dense_max_v`` and
    no cell holds two edges, else "sparse32" or "sparse64" ((B, E) edge
    lists).  Returns dicts of chunk, B, V, n_sweeps, kind and the numpy
    ``args`` of the bucket's solve, which end with its (B, V)
    ``topo_hint`` rows, the kernels' ``order``."""
    from alignasm_tpu_torch.ops.dense import pack_dense_bucket

    packed = sorted(packed, key=lambda t: (t[1].g.n_vertices, len(t[1].eu)))
    buckets = []
    for lo in range(0, len(packed), batch_size):
        chunk = packed[lo:lo + batch_size]
        B = len(chunk)
        V = _next_pow2(max(pg.g.n_vertices for _i, pg in chunk))
        E = _next_pow2(max(max(len(pg.eu), 1) for _i, pg in chunk))
        n_sweeps = _next_pow2(max(pg.g.n for _i, pg in chunk) + 2)
        use32 = all(_fits32(pg) for _i, pg in chunk)
        bucket = dict(chunk=chunk, B=B, V=V, n_sweeps=n_sweeps)
        order = np.stack([topo_hint(pg, V) for _i, pg in chunk])
        if use32 and V <= cfg.dense_max_v:
            dense = pack_dense_bucket(chunk, V)
            if dense is not None:
                buckets.append(dict(bucket, kind="dense",
                                    args=(*dense, order)))
                continue

        def pad(arrs, dtype, fill=0):
            out = np.full((B, E), fill, dtype)
            for b, a in enumerate(arrs):
                out[b, : len(a)] = a
            return out

        idt = np.int32 if use32 else np.int64
        pgs = [pg for _i, pg in chunk]
        eu = pad([pg.eu for pg in pgs], np.int32)
        ev = pad([pg.ev for pg in pgs], np.int32)
        es = pad([pg.es for pg in pgs], idt)
        ea = pad([pg.ea for pg in pgs], np.int32)
        evalid = np.zeros((B, E), bool)
        for b, pg in enumerate(pgs):
            evalid[b, : len(pg.eu)] = True
        srcs = np.asarray([pg.g.src for pg in pgs], np.int32)
        dests = np.asarray([pg.g.dest for pg in pgs], np.int32)
        if use32:
            args = (eu, ev, es, ea, evalid, srcs, dests, order)
        else:
            enz = pad([pg.enz for pg in pgs], np.int32)
            etot = pad([pg.etot for pg in pgs], np.int32)
            erank = pad([pg.erank for pg in pgs], idt)
            args = (eu, ev, es, ea, enz, etot, erank, evalid, srcs, dests,
                    order)
        buckets.append(dict(bucket, kind="sparse32" if use32 else "sparse64",
                            args=args))
    return buckets


def launch_python_bucket(bucket, dev, jacobi=None):
    """Move one bucket's arrays to ``dev`` and start its solve
    (asynchronous on CUDA).  Returns the (B, 5, V) int32 tensor of a
    dense or sparse32 bucket, or the dict of (B, V) tensors of a sparse64
    one.  ``jacobi``, one int32 on ``dev``, gains the count of the
    bucket's contigs that took the kernel's Jacobi branch (the plain
    versions add nothing)."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in bucket["args"]]
    return solve_python_bucket(bucket, args, jacobi)


def solve_python_bucket(bucket, args, jacobi=None):
    """Start the solve of one bucket from its ``args`` as tensors on one
    device (``launch_python_bucket``)."""
    from alignasm_tpu_torch.ops.dense import dense_solve_batch
    from alignasm_tpu_torch.ops.relax import solve_graph_batch
    from alignasm_tpu_torch.ops.relax32 import sp_batch32

    kind, ns = bucket["kind"], bucket["n_sweeps"]
    *args, order = args
    if kind == "sparse64":
        return solve_graph_batch(*args, V=bucket["V"], n_sweeps=ns,
                                 order=order, jacobi=jacobi)
    if kind == "dense":
        return dense_solve_batch(*args, n_sweeps=ns, order=order,
                                 jacobi=jacobi)
    return sp_batch32(*args, V=bucket["V"], n_sweeps=ns, order=order,
                      jacobi=jacobi)


def _solve_torch_python(dataset, cfg: AlignasmConfig, mesh, stats,
                        batch_size: int = 256):
    """The Python plane (``alignasm_tpu/runtime/scheduler.py:147-362``):
    pack, bucket, launch every bucket before reading any, then finish
    each contig on the host.  On a mesh of several devices the dense and
    int32 buckets pad their rows to a multiple of it (repeating the last)
    and shard over it (``mesh.launch_sharded``); int64 buckets stay on
    mesh[0], as in the JAX plane."""
    from alignasm_tpu_torch.engine.device import (
        Fallback, finish_contig, finish_contig_exact,
    )
    from alignasm_tpu_torch.ops.dense import unpack_dense

    dev = mesh[0]
    t0 = time.perf_counter()
    results, packed = pack_dataset(dataset, cfg, stats, mesh)
    buckets = python_buckets(packed, cfg, batch_size)
    stats["pack_s"] = round(time.perf_counter() - t0, 4)
    if len(mesh) > 1:
        stats["data_mesh_devices"] = len(mesh)
    t0 = time.perf_counter()
    counted = {"dense": "dense_buckets", "sparse32": "int32_buckets"}
    jacobi = [torch.zeros(1, dtype=torch.int32, device=dev)]

    def shard(bucket):
        def launch(*args):  # on a mesh entry's own stream
            jacobi.append(torch.zeros(1, dtype=torch.int32,
                                      device=args[0].device))
            return solve_python_bucket(bucket, args, jacobi[-1])
        return launch

    for bucket in buckets:
        if bucket["kind"] in counted:
            stats[counted[bucket["kind"]]] += 1
        if len(mesh) > 1 and bucket["kind"] != "sparse64":
            padB = _mesh_rows(bucket["B"], len(mesh))
            bucket["pending"] = launch_sharded(
                mesh, _pad_rows(bucket["args"], padB), shard(bucket))
        else:
            bucket["pending"] = launch_python_bucket(bucket, dev, jacobi[0])
    stats["launch_s"] = round(time.perf_counter() - t0, 4)  # H2D + launch
    t0 = time.perf_counter()
    for bucket in buckets:
        pending = bucket.pop("pending")
        if bucket["kind"] == "sparse64":
            dev_out = {k: v.cpu().numpy() for k, v in pending.items()}
            pers = [{k: v[b] for k, v in dev_out.items()}
                    for b in range(bucket["B"])]
            inf = 2**62
        else:  # (B, 5, V) int32 rows, one transfer (a gather on a mesh)
            stacked = gather(pending)[:bucket["B"]] \
                if isinstance(pending, list) else pending.cpu().numpy()
            pers = [unpack_dense(row) for row in stacked]
            inf = 2**30
        for (i, pg), per in zip(bucket["chunk"], pers):
            try:
                results[i] = finish_contig(pg, per, cfg, inf=inf)
                stats["device"] += 1
            except Fallback as fb:
                results[i] = finish_contig_exact(pg, per, cfg)
                stats["fallback"] += 1
                reasons = stats["fallback_reasons"]
                reasons[str(fb)] = reasons.get(str(fb), 0) + 1
    stats["finish_s"] = round(time.perf_counter() - t0, 4)  # wait + finish
    # after every bucket's rows: no extra wait
    stats["jacobi"] = sum(int(j) for j in jacobi)
    return ([r[0] for r in results], [r[1] for r in results],
            [r[2] for r in results])


def solve_dataset_torch(dataset, cfg: AlignasmConfig, src_paths=None,
                        write_prefix=None, *, device="cuda",
                        batch_size: int = 256):
    """Device engine on PyTorch: solve every contig on ``device`` ("cuda"
    by default runs the CUDA kernels on every visible card, "cpu" the
    plain PyTorch versions; a CUDA device that is not available raises).
    ``device`` may name a mesh (parallel/mesh.py:as_mesh): "cuda" is one
    entry a visible card, a sequence such as ``("cuda:0", "cuda:1")`` or
    ``("cpu",) * 8`` its entries; on more than one entry the data and
    graph axes run and ``stats["data_mesh_devices"]`` is its length.

    With ``src_paths = (paf, alt_or_None)`` the native plane parses the
    files itself; with ``write_prefix`` it writes the three PAF files and
    (None, None, None) is returned, without it the per-contig results.
    ``cfg.device_routing`` is "always" (the device pipeline), "auto" (the
    default: the device only where the port's calibrated cost model,
    ``runtime/costmodel.py``, predicts a win, bucket by bucket; with no
    possible win the fused native plane) or "never" (every contig on the
    host plane); the decision and its calibration land in
    ``stats["cost_model"]``.
    Without ``src_paths`` (or when the native plane raises NativeError
    and a parsed ``dataset`` was given) the Python plane solves
    ``dataset`` in buckets of ``batch_size`` contigs and returns the
    per-contig results; ``write_prefix`` is then not used, as in the JAX
    package.  Stats land in ``solve_dataset_torch.last_stats``.  While a
    ``torch.profiler`` records, the call and its stages are spans
    (``runtime/tracing.py``) and the native route's stats carry the C++
    host plane's counters (``native_<slot>_s``, ``native_<slot>_n``)."""
    with span(None, None, tracing.SOLVE):
        return _solve_dataset_torch(dataset, cfg, src_paths, write_prefix,
                                    device, batch_size)


def _solve_dataset_torch(dataset, cfg: AlignasmConfig, src_paths,
                         write_prefix, device, batch_size: int):
    mesh = as_mesh(device)
    if src_paths is not None:
        route = _routing(cfg)
        try:
            with tracing.native_counters(
                    lambda c: solve_dataset_torch.last_stats.update(c)):
                if not route.allow_device and write_prefix is not None:
                    return _solve_native_routed(cfg, src_paths, write_prefix,
                                                route.cost_model)
                return _solve_torch_native(dataset, cfg, src_paths,
                                           write_prefix, mesh, route)
        except native.NativeError as exc:
            if dataset is None:
                raise  # no parsed dataset to degrade to
            warnings.warn(f"native host plane unavailable: {exc}",
                          RuntimeWarning, stacklevel=2)
            native_error = str(exc)
    elif dataset is None:
        raise ValueError("solve_dataset_torch needs a dataset or src_paths")
    else:
        native_error = None
    stats = {"device": 0, "fallback": 0, "singleton": 0, "oversize": 0,
             "host_plane": "python", "fallback_reasons": {},
             "dense_buckets": 0, "int32_buckets": 0,
             "torch_device": _mesh_name(mesh)}
    if native_error is not None:
        stats["native_error"] = native_error[:500]
    solve_dataset_torch.last_stats = stats
    return _solve_torch_python(dataset, cfg, mesh, stats, batch_size)


solve_dataset_torch.last_stats = None


def solve_missing_torch_native(cfg: AlignasmConfig, src_paths, missing,
                               put_chunk=None, chunk: int = 4096,
                               threads: int = 0, expected_n=None, *,
                               device="cuda"):
    """Device-engine solve of an explicit contig subset on the native host
    plane: the resume path of ``checkpoint.solve_dataset_resumable(engine=
    "cuda")`` (the JAX scheduler's ``solve_missing_tpu_native``).

    Opens one exporter (one parse), routes as ``solve_dataset_torch``
    does, runs the bucket device pipeline over the device-eligible members
    of ``missing`` while the other members solve natively on a host
    thread, native-solves whatever the device left, and streams the
    results back through ``put_chunk(indices, outs, alts, maxes)`` in
    ``chunk``-sized slices (the journal's flush granularity).  A file
    whose contig count differs from ``expected_n`` raises RuntimeError
    before any ``put_chunk``.  ``device`` names a mesh, as in
    ``solve_dataset_torch``: its data axis takes the buckets (there is no
    graph axis here, as in the JAX scheduler).  Returns the stats dict
    (also ``solve_dataset_torch.last_stats``)."""
    mesh = as_mesh(device)
    t_start = time.perf_counter()
    native.tune_heap()
    missing = np.ascontiguousarray(np.sort(np.asarray(missing, np.int64)))
    route = _routing(cfg)
    stats = _native_stats(cfg, route, mesh)
    exporter = _open_exporter(cfg, src_paths, threads)
    try:
        meta = exporter.meta_bulk()
        stats["n_contigs_file"] = len(meta)
        if expected_n is not None and len(meta) != expected_n:
            # results stored under the caller's digests would belong to
            # other contigs: raise before any put_chunk runs
            raise RuntimeError(
                f"native parse found {len(meta)} contigs but the caller "
                f"expects {expected_n}: src_paths does not match dataset")
        covered, non_device = _route_pool(exporter, cfg, meta, missing,
                                          stats, mesh, route, threads=threads)
        # the device's leftovers, and the non-device set again when its
        # native solve failed: no contig may reach the journal unsolved
        solved = covered if "overlap_error" in stats \
            else np.concatenate([covered, non_device])
        leftover = np.setdiff1d(missing, solved)
        if len(leftover):
            exporter.solve_subset(leftover, threads=threads)
        stats["native_direct"] = int(len(missing) - len(covered))
        if put_chunk is not None:
            for lo in range(0, len(missing), chunk):
                part = missing[lo:lo + chunk]
                o, a, m = exporter.fetch_results_for(part)
                put_chunk(part, o, a, m)
    finally:
        exporter.close()
    stats["total_s"] = round(time.perf_counter() - t_start, 4)
    return stats
