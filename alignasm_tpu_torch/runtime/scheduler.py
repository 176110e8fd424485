"""Bucket scheduler of the device engine on PyTorch.

Counterpart of ``alignasm_tpu/runtime/scheduler.py:solve_dataset_tpu``:
its two host planes, each feeding the device kernels.

The native plane (``src_paths`` given; ``_solve_tpu_native`` and what it
calls there): the C++ host plane (``alignasm_tpu_torch.native``, the
port's copy of the JAX package's) parses the PAF, builds each contig's
DAG and exports one sparse wire per bucket; the device densifies the wire and runs one
reverse-topological scan per contig for buckets with V <= 256 (uint8 gate
rows ``[nxt, fast, src]``) or the blocked tropical solve for 256 < V <=
8192 (the same rows in int16) (ops/dense.py); ``finish_bulk8`` /
``finish_bulk16`` chase each path in C++ and ``write_results`` writes the
three PAF files.  The device only decides
which contigs take the fast finish, so the files are byte-identical to the
native engine's whatever it answers.  A host-plane failure (wire export,
finish) degrades the affected contigs to the native solve with the reason
in ``stats["device_error"]``; a kernel that fails to build, launch or run
raises.  It covers buckets with V <= 8192 on one device.

The Python plane (``src_paths=None``, a parsed ``dataset``; the JAX
package's test and degrade plane): per contig ``build_graph`` ->
``pack_graph`` in Python, buckets of ``batch_size`` contigs sorted by
(vertices, edges), each solved by the dense sweep solve (V <=
``dense_max_v``, ops/dense.py), the int32 sparse relaxation
(ops/relax32.py) or, when path sums may pass int32, the int64 one
(ops/relax.py); then ``finish_contig``, or ``finish_contig_exact`` on
``Fallback``.  A ``NativeError`` of the native plane degrades to it when
a ``dataset`` was given, with a RuntimeWarning and the reason in
``stats["native_error"]``.
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import torch

from alignasm_tpu_torch import native
from alignasm_tpu_torch.config import AlignasmConfig
from alignasm_tpu_torch.ops.dense import (
    dense_solve_wire16_topo_nxt8, dense_solve_wire_topo_nxt8_ragged,
    dense_solve_wire_topo_nxt16_blocked_ragged,
)
from alignasm_tpu_torch.ops.wire import (
    as_device, ragged_to_device, wire16_to_device,
)

MAX_V = 256  # the scan and uint8 gate rows; above it the blocked solve
MAX_DEVICE_V = 8192  # a V = 16384 slab is 1 GB of int32 per contig


def _check_supported(cfg: AlignasmConfig) -> None:
    """Raise NotImplementedError for what the native plane does not cover
    yet, naming the ROADMAP.md item that will."""
    if cfg.device_routing == "auto":
        raise NotImplementedError(
            "device_routing='auto' needs the port's own calibration; the "
            "JAX package's cost model was measured on a TPU (ROADMAP.md: "
            "'Port calibration and auto routing')")
    if cfg.device_routing != "always":
        raise NotImplementedError(
            f"device_routing={cfg.device_routing!r}: the port only runs the "
            "device path; use alignasm_tpu_torch.native.run for a host-only run")
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


def _n_devices(dev) -> int:
    """The devices the JAX Python plane would spread over
    (``jax.device_count()``): every visible card for an unindexed
    "cuda", else the one device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.cuda.device_count()
    return 1


def _check_one_device(dataset, cfg: AlignasmConfig, dev) -> None:
    """The JAX Python plane's multi-device branches are not ported: raise
    NotImplementedError naming the ROADMAP item where they would run."""
    if _n_devices(dev) <= 1:
        return
    where = (f"{dev} has {_n_devices(dev)} devices; pass one device "
             "(\"cuda:0\")")
    if any(len(c) > cfg.max_device_records
           and len(c) >= cfg.graph_shard_min_records
           for c in dataset.contigs):
        raise NotImplementedError(
            f"the graph-sharded solve of a contig over several devices is "
            f"not ported (ROADMAP.md: 'Multi-GPU'); {where}")
    raise NotImplementedError(
        f"the Python plane's data mesh over several devices is not ported "
        f"(ROADMAP.md: 'Multi-GPU'); {where}")


def pack_dataset(dataset, cfg: AlignasmConfig, stats):
    """The Python plane's host packing (the JAX plane's first loop):
    singletons and contigs over ``max_device_records`` records solve with
    the exact engine right away; every other contig is built and packed.

    Returns ``(results, packed)``: ``results[i]`` the (out, alt, max)
    triple of contig i or None, ``packed`` a list of (i, PackedGraph)."""
    from alignasm_tpu_torch.engine.device import pack_graph
    from alignasm_tpu_torch.engine.exact import solve_contig
    from alignasm_tpu_torch.engine.graph import build_graph

    results = [None] * len(dataset.contigs)
    packed = []
    for i, contig in enumerate(dataset.contigs):
        if len(contig) == 1 or len(contig) > cfg.max_device_records:
            results[i] = solve_contig(contig, cfg)
            stats["singleton" if len(contig) == 1 else "oversize"] += 1
            continue
        packed.append((i, pack_graph(build_graph(contig, cfg))))
    return results, packed


def python_buckets(packed, cfg: AlignasmConfig, batch_size: int = 256):
    """Bucket the packed contigs as the JAX plane does: sorted by
    (vertices, edges), ``batch_size`` per bucket, V and E padded to
    powers of two (at least 8), ``n_sweeps`` the next power of two above
    the largest record count + 2.  A bucket is "dense" ((B, V, V)
    matrices) when every contig fits int32 and V <= ``dense_max_v`` and
    no cell holds two edges, else "sparse32" or "sparse64" ((B, E) edge
    lists).  Returns dicts of chunk, B, V, n_sweeps, kind and the numpy
    ``args`` of the bucket's solve."""
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
        if use32 and V <= cfg.dense_max_v:
            dense = pack_dense_bucket(chunk, V)
            if dense is not None:
                buckets.append(dict(bucket, kind="dense", args=dense))
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
            args = (eu, ev, es, ea, evalid, srcs, dests)
        else:
            enz = pad([pg.enz for pg in pgs], np.int32)
            etot = pad([pg.etot for pg in pgs], np.int32)
            erank = pad([pg.erank for pg in pgs], idt)
            args = (eu, ev, es, ea, enz, etot, erank, evalid, srcs, dests)
        buckets.append(dict(bucket, kind="sparse32" if use32 else "sparse64",
                            args=args))
    return buckets


def launch_python_bucket(bucket, dev):
    """Move one bucket's arrays to ``dev`` and start its solve
    (asynchronous on CUDA).  Returns the (B, 5, V) int32 tensor of a
    dense or sparse32 bucket, or the dict of (B, V) tensors of a sparse64
    one."""
    from alignasm_tpu_torch.ops.dense import dense_solve_batch
    from alignasm_tpu_torch.ops.relax import solve_graph_batch
    from alignasm_tpu_torch.ops.relax32 import sp_batch32

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in bucket["args"]]
    if bucket["kind"] == "dense":
        return dense_solve_batch(*args, n_sweeps=bucket["n_sweeps"])
    if bucket["kind"] == "sparse32":
        return sp_batch32(*args, V=bucket["V"], n_sweeps=bucket["n_sweeps"])
    return solve_graph_batch(*args, V=bucket["V"], n_sweeps=bucket["n_sweeps"])


def _solve_torch_python(dataset, cfg: AlignasmConfig, dev, stats,
                        batch_size: int = 256):
    """The Python plane (``alignasm_tpu/runtime/scheduler.py:147-362``):
    pack, bucket, launch every bucket before reading any, then finish
    each contig on the host."""
    from alignasm_tpu_torch.engine.device import (
        Fallback, finish_contig, finish_contig_exact,
    )
    from alignasm_tpu_torch.ops.dense import unpack_dense

    _check_one_device(dataset, cfg, dev)
    t0 = time.perf_counter()
    results, packed = pack_dataset(dataset, cfg, stats)
    buckets = python_buckets(packed, cfg, batch_size)
    stats["pack_s"] = round(time.perf_counter() - t0, 4)
    t0 = time.perf_counter()
    counted = {"dense": "dense_buckets", "sparse32": "int32_buckets"}
    for bucket in buckets:
        if bucket["kind"] in counted:
            stats[counted[bucket["kind"]]] += 1
        bucket["pending"] = launch_python_bucket(bucket, dev)
    stats["launch_s"] = round(time.perf_counter() - t0, 4)  # H2D + launch
    t0 = time.perf_counter()
    for bucket in buckets:
        pending = bucket.pop("pending")
        if bucket["kind"] == "sparse64":
            dev_out = {k: v.cpu().numpy() for k, v in pending.items()}
            pers = [{k: v[b] for k, v in dev_out.items()}
                    for b in range(bucket["B"])]
            inf = 2**62
        else:  # (B, 5, V) int32 rows, one transfer
            stacked = pending.cpu().numpy()
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
    return ([r[0] for r in results], [r[1] for r in results],
            [r[2] for r in results])


def solve_dataset_torch(dataset, cfg: AlignasmConfig, src_paths=None,
                        write_prefix=None, *, device="cuda",
                        batch_size: int = 256):
    """Device engine on PyTorch: solve every contig on ``device`` ("cuda"
    by default runs the CUDA kernels, "cpu" the plain PyTorch versions;
    a CUDA device that is not available raises).

    With ``src_paths = (paf, alt_or_None)`` the native plane parses the
    files itself; with ``write_prefix`` it writes the three PAF files and
    (None, None, None) is returned, without it the per-contig results.
    Without ``src_paths`` (or when the native plane raises NativeError
    and a parsed ``dataset`` was given) the Python plane solves
    ``dataset`` in buckets of ``batch_size`` contigs and returns the
    per-contig results; ``write_prefix`` is then not used, as in the JAX
    package.  Stats land in ``solve_dataset_torch.last_stats``."""
    dev = as_device(device)
    if src_paths is not None:
        _check_supported(cfg)
        stats = {"device": 0, "fallback": 0, "singleton": 0, "oversize": 0,
                 "host_plane": "native", "dense_buckets": 0,
                 "native_direct": 0, "routing": cfg.device_routing,
                 "torch_device": str(dev)}
        solve_dataset_torch.last_stats = stats
        try:
            return _solve_torch_native(cfg, src_paths, write_prefix, dev,
                                       stats)
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
             "torch_device": str(dev)}
    if native_error is not None:
        stats["native_error"] = native_error[:500]
    solve_dataset_torch.last_stats = stats
    return _solve_torch_python(dataset, cfg, dev, stats, batch_size)


solve_dataset_torch.last_stats = None
