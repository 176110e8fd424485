"""Calibration of the port's device-routing cost model on the card.

    python -m alignasm_tpu_torch.runtime.devbench --calibrate [--out PATH] [N]

measures every ``DeviceCostModel`` field (runtime/costmodel.py) on the
CUDA device and this host, on the port's own main path, and writes the
calibration artifact (``costmodel.CALIBRATION_PATH`` unless ``--out``
names another file) atomically through a ``.tmp`` file; ``N`` is the
calibration corpus's contig count (20000 by default).  It is the
counterpart of ``calibrate`` and the ``--calibrate`` branch of
``alignasm_tpu/runtime/devbench.py``; the end-to-end, kernel and big-V
sections of that module are not ported here.

What differs from the JAX calibration, and why:

- Transport: the round trip is a one-element kernel and its ``.cpu()``;
  host to device moves the ~33 MB (cell, packed value) int32 blob with the
  main path's transfer (``ops/wire.py:ragged_to_device``), fenced by
  ``torch.cuda.synchronize()``; device to host moves 4 MiB of uint8 rows
  through ``scheduler._rows_to_host`` and its event, a fresh device
  tensor per rep.  Both subtract the round trip, as JAX does.
- The Amdahl A/B (``finish_vs_solve``) harvests its gate rows, and its
  finish side exports its wires, through the port's own route:
  ``scheduler._dense_buckets``, ``export_wire`` (the 16-bit wire for
  V <= 128 where it fits, else the ragged int32 wire), ``wire_to_device``,
  ``solve_bucket`` and ``finish_bulk8`` for the buckets of V <= 256.  The
  JAX calibration exports its fixed-width (B, 2, W) wire instead, which
  the port does not ship; the port measures the wire its route ships.
- Device compute is timed with CUDA events over chained launches:
  ``device_s_per_contig`` on the ragged-wire scan (csrc/densify.cu +
  csrc/topo_scan.cu) at B = 2048, V = 64, ``device_s_per_step`` on one
  V = 8192 chain through the blocked solve (csrc/blocked_dp.cu) at
  ``scheduler.BLOCKED_BK``.
- ``_meta`` adds the card's ``power_limit`` (nvidia-smi) beside
  ``device_kind``, so every number in the artifact stands beside the
  card's name and power limit.

``calibrate(device="cuda")`` raises without a card; ``device="cpu"``
runs the plain PyTorch versions (tests) at the sizes the caller passes,
and records ``device_kind`` "cpu".
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

METHOD = ("devbench --calibrate (transport round trips through "
          "ragged_to_device and _rows_to_host, native solve phases, "
          "cold-graph Amdahl A/B with the finish side paying the port's wire "
          "export + finish_bulk8 and no DP, chained kernel launches timed "
          "with CUDA events)")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _per_launch_s(launch, n_chain: int, reps: int, dev) -> float:
    """Best seconds per launch over ``reps`` runs of ``n_chain`` launches
    in a row, after one warm-up: CUDA events on the card, the host clock
    on the CPU."""
    launch()
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_chain):
                launch()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t = _timed(lambda: [launch() for _ in range(n_chain)])
        best = min(best, t / n_chain)
    return best


def card_line(dev) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card, or "not
    measured" on the CPU or when nvidia-smi cannot be read."""
    if dev.type != "cuda":
        return "not measured"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "not measured"


def _scan_wire(B: int, V: int, seed: int, rng):
    """A ragged int32 wire of B random DAGs of V vertices (each cell of the
    strict upper triangle an edge with probability 0.08; dest V - 1, src
    0), the JAX calibration's slabs in the port's ragged layout."""
    from alignasm_tpu_torch.ops.dense import ANOM_SHIFT

    mask = np.triu(np.random.default_rng(seed).random((B, V, V)) < 0.08,
                   k=1)
    ws = rng.integers(1, 1000, (B, V, V)).astype(np.int64)
    wa = rng.integers(0, 2, (B, V, V)).astype(np.int64)
    b, u, v = np.nonzero(mask)
    M = V * (V + 1)
    bs = np.arange(B, dtype=np.int64) * M
    cells = np.concatenate([b * M + u * V + v, bs + V * V, bs + V * V + 1])
    vals = np.concatenate([ws[b, u, v] | (wa[b, u, v] << ANOM_SHIFT),
                           np.full(B, V - 1), np.zeros(B, np.int64)])
    return np.stack([cells, vals]).astype(np.int32)


def calibrate(n_contigs: int = 20000, seed: int = 2024, *, device="cuda",
              scan_shape=(2048, 64), bigv_v: int = 8192,
              h2d_cells: int = 1 << 22, d2h_bytes: int = 4 << 20) -> dict:
    """Measure every DeviceCostModel field on ``device`` and this host.
    Returns the calibration dict ``runtime/costmodel.py`` consumes: the
    model's fields at the top level plus a ``_meta`` block with date,
    shelf life, the card's name and power limit, method and raw
    readings.  ``scan_shape`` (B, V), ``bigv_v``, ``h2d_cells`` and
    ``d2h_bytes`` size the device measurements (the defaults are the JAX
    calibration's)."""
    import datetime
    import os
    import pathlib
    import shutil
    import tempfile

    from alignasm_tpu_torch import native
    from alignasm_tpu_torch.config import DEFAULT_CONFIG
    from alignasm_tpu_torch.ops.dense import (
        dense_solve_wire_topo_nxt8_ragged,
        dense_solve_wire_topo_nxt16_blocked_ragged,
    )
    from alignasm_tpu_torch.ops.wire import as_device, ragged_to_device
    from alignasm_tpu_torch.runtime.scheduler import (
        BLOCKED_BK, MAX_V, _dense_buckets, _device_cap, _eligible_mask,
        _pad_batch, _rows_to_host, export_wire, solve_bucket,
        wire_to_device,
    )
    from alignasm_tpu_torch.testing.synth import generate_paf

    dev = as_device(device)
    details: dict = {}

    # --- transport -----------------------------------------------------
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    (x + 1).cpu()  # warm
    rtt = min(_timed(lambda: (x + 1).cpu()) for _ in range(15))
    details["rtt_reps"] = 15

    # host -> device: (cell, packed value) pairs shaped as the sparse wire
    rng = np.random.default_rng(seed)
    blob = np.empty((2, h2d_cells), np.int32)
    blob[0] = np.arange(h2d_cells, dtype=np.int32) % (64 * 65)
    blob[1] = rng.integers(1, 1000, h2d_cells) | (
        rng.integers(0, 4, h2d_cells) << 28)

    def put():
        ragged_to_device(blob, dev)
        _sync(dev)

    put()  # warm
    t_h2d = min(_timed(put) for _ in range(3))
    h2d = blob.nbytes / max(t_h2d - rtt, 1e-9)
    details["h2d_MB"] = round(blob.nbytes / 1e6, 1)

    # device -> host: uint8 rows, one fresh device tensor per rep, as the
    # main path fetches each bucket's new rows
    base = torch.arange(d2h_bytes, dtype=torch.int32, device=dev)
    fresh = [((base + i) % 251).to(torch.uint8) for i in range(4)]
    _sync(dev)

    def fetch(rows):
        _host, ev = _rows_to_host(rows)
        if ev is not None:
            ev.synchronize()

    fetch(fresh[0])  # warm
    t_d2h = min(_timed(lambda r=r: fetch(r)) for r in fresh[1:])
    d2h = d2h_bytes / max(t_d2h - rtt, 1e-9)
    details["d2h_MB"] = round(d2h_bytes / 1e6, 1)

    # --- host plane ----------------------------------------------------
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = pathlib.Path(tempfile.mkdtemp(prefix="alignasm_cal_", dir=shm))
    try:
        paf = work / "cal.paf"
        paf.write_text(generate_paf(n_contigs=n_contigs, seed=seed,
                                    max_records_per_contig=24))
        native.run(str(paf), threads=0)  # warm (build lib, page cache)
        best = None
        for _ in range(3):
            native.drain_teardowns()
            st = native.run(str(paf), threads=0)
            if best is None or st["solve_s"] < best["solve_s"]:
                best = st
        solve_per_record = best["solve_s"] / max(best["records"], 1)
        details["host_solve_s"] = best["solve_s"]
        details["host_records"] = best["records"]

        tiny = work / "tiny.paf"
        tiny.write_text(generate_paf(n_contigs=max(n_contigs // 2, 1000),
                                     seed=seed + 1,
                                     max_records_per_contig=3))
        native.run(str(tiny), threads=0)
        st = min((native.run(str(tiny), threads=0) for _ in range(2)),
                 key=lambda s: s["solve_s"])
        solve_contig_min = st["solve_s"] / max(st["contigs"], 1)

        # --- the Amdahl ratio: finish vs solve, identical cold graphs --
        # 1. one pass to harvest the device's gate rows for the eligible
        #    buckets of V <= 256, through the port's route
        cfg = DEFAULT_CONFIG
        max_records = max(cfg.max_device_records, _device_cap(cfg))
        finish_work = []
        with native.GraphExporter(str(paf), max_records=max_records,
                                  config=cfg) as ex:
            meta = ex.meta_bulk()
            n_v, n_edges = meta[:, 2], meta[:, 3]
            idx_all = np.where(_eligible_mask(meta, cfg))[0]
            order = idx_all[np.argsort(n_v[idx_all], kind="stable")]
            for V, idxs in _dense_buckets(order, n_v):
                if V > MAX_V:
                    continue  # calibrate on the uint8 rows' finish
                padB = _pad_batch(len(idxs), V)
                kind, wire, ok, _nbytes = export_wire(
                    ex, V, idxs, n_edges[idxs], padB)
                rows = solve_bucket(kind, wire_to_device(kind, wire, dev),
                                    padB, V)
                dp = rows.cpu().numpy()[:len(idxs)][ok]
                if len(dp):
                    finish_work.append((idxs, idxs[ok], dp, V, padB))
        idx_used = np.concatenate([w[1] for w in finish_work]) \
            if finish_work else np.empty(0, np.int64)

        # 2. A: full native solve, cold exporter
        def cold_solve():
            with native.GraphExporter(str(paf), max_records=max_records,
                                      config=cfg) as ex:
                ex.meta_bulk()
                ex.prepare_results()
                return _timed(lambda: ex.solve_subset(idx_used, threads=0))

        # 3. B: wire export (graph build + pack) + device-assisted finish:
        #    everything the device route pays on the host except the DP
        def cold_finish():
            with native.GraphExporter(str(paf), max_records=max_records,
                                      config=cfg) as ex:
                ex.meta_bulk()
                ex.prepare_results()

                def go():
                    for idxs, idxs_ok, dp, V, padB in finish_work:
                        export_wire(ex, V, idxs, n_edges[idxs], padB)
                        ex.finish_bulk8(idxs_ok, dp, V)
                return _timed(go)

        if len(idx_used):
            cold_solve(), cold_finish()  # warm (page cache, lib)
            t_solve = min(cold_solve() for _ in range(3))
            t_finish = min(cold_finish() for _ in range(3))
            finish_vs_solve = t_finish / t_solve
            details["amdahl_t_solve_s"] = round(t_solve, 4)
            details["amdahl_t_finish_s"] = round(t_finish, 4)
            details["amdahl_contigs"] = int(len(idx_used))
        else:  # no eligible work (not seen on the calibration corpus)
            finish_vs_solve = None
    finally:
        shutil.rmtree(work, True)

    # --- device compute ------------------------------------------------
    # marginal per-contig cost of the scan's route (ragged densify + scan)
    B, V = scan_shape
    wire_d = ragged_to_device(_scan_wire(B, V, seed, rng), dev)
    dev_per_contig = _per_launch_s(
        lambda: dense_solve_wire_topo_nxt8_ragged(wire_d, B, V), 20, 3,
        dev) / B
    details["scan_B_V"] = [B, V]

    # per-vertex cost of the big-V blocked solve (one chain slab)
    bw_d = ragged_to_device(_bigv_wire(bigv_v, seed), dev)
    t_big = _per_launch_s(
        lambda: dense_solve_wire_topo_nxt16_blocked_ragged(
            bw_d, 1, bigv_v, BLOCKED_BK), 4, 2, dev)
    dev_per_step = t_big / bigv_v
    details["bigv_V_Bk"] = [bigv_v, BLOCKED_BK]

    card = card_line(dev)
    today = datetime.date.today()
    fields = {
        "dispatch_rtt_s": float(f"{rtt:.3g}"),
        "h2d_bytes_per_s": round(h2d, -3),
        "d2h_bytes_per_s": round(d2h, -3),
        "solve_s_per_record": float(f"{solve_per_record:.3g}"),
        "solve_s_per_contig_min": float(f"{solve_contig_min:.3g}"),
        "device_s_per_contig": float(f"{dev_per_contig:.3g}"),
        "device_s_per_step": float(f"{dev_per_step:.3g}"),
    }
    if finish_vs_solve is not None:
        fields["finish_vs_solve"] = round(finish_vs_solve, 3)
    fields["_meta"] = {
        "date": today.isoformat(),
        "stale_after": (today + datetime.timedelta(days=120)).isoformat(),
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "power_limit": card.split(",")[-1].strip(),
        "method": METHOD,
        "n_contigs": n_contigs,
        "details": details,
    }
    return fields


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _bigv_wire(V: int, seed: int):
    """Chain-shaped V-vertex ragged wire of one contig (the JAX
    calibration's ``_bigv_wire``)."""
    from alignasm_tpu_torch.ops.dense import ANOM_SHIFT

    rng = np.random.default_rng(seed)
    us = np.repeat(np.arange(V - 1), 4)
    span = rng.integers(1, 16, len(us))
    vs = np.minimum(us + span, V - 1)
    keep = us < vs
    keys = np.unique(us[keep].astype(np.int64) * V + vs[keep])
    us, vs = keys // V, keys % V
    ws = rng.integers(0, 3000, len(us)).astype(np.int64)
    wa = rng.integers(0, 4, len(us)).astype(np.int64)
    val = (ws | (wa << ANOM_SHIFT)).astype(np.int32)
    ent = np.stack([us * V + vs, val])
    extra = np.array([[V * V, V * V + 1], [V - 1, 0]])
    return np.concatenate([ent, extra], axis=1).astype(np.int32)


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    import os

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--calibrate" not in argv:
        print("usage: python -m alignasm_tpu_torch.runtime.devbench "
              "--calibrate [--out PATH] [N]", file=sys.stderr)
        return 2
    argv.remove("--calibrate")
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        del argv[i:i + 2]
    if out_path is None:
        from alignasm_tpu_torch.runtime.costmodel import CALIBRATION_PATH

        out_path = CALIBRATION_PATH
    n = int(argv[0]) if argv else 20000
    cal = calibrate(n_contigs=n)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(cal, fh, indent=1)
        fh.write("\n")
    os.replace(tmp, out_path)
    _emit({"calibration": cal, "written": out_path})
    return 0


if __name__ == "__main__":
    sys.exit(main())
