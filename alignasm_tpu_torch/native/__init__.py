"""Native host plane: builds and binds the C++ pipeline via ctypes.

The port's own copy of ``alignasm_tpu/native`` (sources and bindings),
so the port imports nothing of the JAX package.  The shared library
compiles on first use (g++ -O3, ~seconds) into ``alignasm_tpu_torch/build/``,
named by a hash of the sources and flags, so a changed source builds
anew; it is never built next to the sources.  It is loaded with the
default ``RTLD_LOCAL``, so it shares no symbols with the JAX package's
library in the same process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "src"
_BUILD = _DIR.parent / "build"
_SOURCES = ["cs.cc", "io.cc", "solver.cc", "api.cc", "export.cc", "heap.cc"]
_FLAGS = ["-std=c++20", "-O3", "-g", "-fPIC", "-shared"]
_lock = threading.Lock()
_lib = None


class NativeError(RuntimeError):
    pass


def library_path() -> pathlib.Path:
    """The library's path: a hash of the sources, headers and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in [_SRC / s for s in _SOURCES] + sorted(_SRC.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / f"libalignasm_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> pathlib.Path:
    with _lock:
        lib_path = library_path()
        if force or not lib_path.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            # compile to a private temp path and os.replace into place:
            # rename is atomic, so a concurrent PROCESS (test workers,
            # parallel CLI runs — the threading lock only covers this
            # process) either dlopens a complete library or builds its
            # own, never a half-written file
            tmp = lib_path.with_suffix(f".so.tmp.{os.getpid()}")
            base = ["g++", *_FLAGS, "-o", str(tmp)] \
                + [str(_SRC / s) for s in _SOURCES] + ["-pthread"]
            # prefer host-tuned codegen; fall back for toolchains/platforms
            # where -march=native is unsupported
            try:
                for extra in (["-march=native"], []):
                    cmd = base[:2] + extra + base[2:]
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                    if proc.returncode == 0:
                        break
                else:
                    raise NativeError(
                        f"native build failed:\n{proc.stderr[-4000:]}")
                os.replace(tmp, lib_path)
            finally:
                if tmp.exists():
                    tmp.unlink()
    return lib_path


class Stats(ctypes.Structure):
    _fields_ = [
        ("read_s", ctypes.c_double),
        ("solve_s", ctypes.c_double),
        ("write_s", ctypes.c_double),
        ("contigs", ctypes.c_longlong),
        ("records", ctypes.c_longlong),
    ]


class ScoringParams(ctypes.Structure):
    """Mirrors AlnScoring in src/api.cc — the runtime scoring knobs of
    AlignasmConfig, so custom configs reach the C++ engine too."""

    _fields_ = [
        ("qry_weight", ctypes.c_longlong),
        ("ref_weight", ctypes.c_longlong),
        ("ref_negative_penalty", ctypes.c_longlong),
        ("sv_baseline", ctypes.c_longlong),
        ("sv_trans_penalty", ctypes.c_longlong),
        ("sv_inv_penalty", ctypes.c_longlong),
        ("sv_front_end_coefficient", ctypes.c_longlong),
        ("max_path_count", ctypes.c_longlong),
        ("upgrade_mode", ctypes.c_longlong),
    ]

    UPGRADE_MODES = {"alt_path": 0, "single_piece": 1, "no_update": 2}

    @classmethod
    def from_config(cls, cfg):
        return cls(cfg.qry_weight, cfg.ref_weight, cfg.ref_negative_penalty,
                   cfg.sv_baseline, cfg.sv_trans_penalty, cfg.sv_inv_penalty,
                   cfg.sv_front_end_coefficient, cfg.max_path_count,
                   cls.UPGRADE_MODES[getattr(cfg, "upgrade_mode", "alt_path")])


def _ensure_lib():
    """Build + dlopen the library and register the numpy-free ABI — the
    fast-start subset (native.run / run_shard / append_shard) used by
    the CLI native path and every multihost rank.  Importing numpy
    costs ~0.26 s of process startup, which multiplied across pod ranks
    dominates small jobs; the shard engine never needs it."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.aln_run_stats2.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(Stats), ctypes.POINTER(ScoringParams),
        ]
        lib.aln_run_stats2.restype = ctypes.c_int
        lib.aln_open2.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ScoringParams),
        ]
        lib.aln_open2.restype = ctypes.c_void_p
        lib.aln_tune_heap.argtypes = []
        lib.aln_tune_heap.restype = None
        lib.aln_drain_teardowns.argtypes = []
        lib.aln_drain_teardowns.restype = None
        lib.aln_close.argtypes = [ctypes.c_void_p]
        lib.aln_num_contigs.argtypes = [ctypes.c_void_p]
        lib.aln_num_contigs.restype = ctypes.c_longlong
        llp = ctypes.POINTER(ctypes.c_longlong)
        lib.aln_alt_counts.argtypes = [ctypes.c_void_p, llp]
        lib.aln_alt_counts.restype = None
        lib.aln_run_shard.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_char_p, llp, llp,
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ScoringParams),
        ]
        lib.aln_run_shard.restype = ctypes.c_int
        lib.aln_append_shard.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_append_shard.restype = ctypes.c_int
        lib.aln_trace.argtypes = [ctypes.c_int]
        lib.aln_trace.restype = None
        lib.aln_trace_slots.argtypes = []
        lib.aln_trace_slots.restype = ctypes.c_int
        lib.aln_trace_name.argtypes = [ctypes.c_int]
        lib.aln_trace_name.restype = ctypes.c_char_p
        lib.aln_trace_read.argtypes = [llp, llp]
        lib.aln_trace_read.restype = None
        _lib = lib
    return _lib


def get_lib():
    lib = _ensure_lib()
    if not getattr(lib, "_np_registered", False):
        import numpy.ctypeslib as npc

        i32p = npc.ndpointer(dtype="int32", flags="C_CONTIGUOUS")
        i64p = npc.ndpointer(dtype="int64", flags="C_CONTIGUOUS")
        lib.aln_write_outputs.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            i64p, i64p, i64p, i64p, i64p, i64p, i64p,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_write_outputs.restype = ctypes.c_int
        i8p = npc.ndpointer(dtype="int8", flags="C_CONTIGUOUS")
        llp = ctypes.POINTER(ctypes.c_longlong)
        lib.aln_meta_bulk.argtypes = [ctypes.c_void_p, i64p]
        lib.aln_meta_bulk.restype = ctypes.c_int
        lib.aln_export_wire.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, i32p, i8p, ctypes.c_int,
        ]
        lib.aln_export_wire.restype = ctypes.c_int
        lib.aln_export_wire_ragged.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, ctypes.c_longlong,
            i64p, ctypes.c_longlong, ctypes.c_longlong, i32p, i8p,
            ctypes.c_int,
        ]
        lib.aln_export_wire_ragged.restype = ctypes.c_int
        u16p = npc.ndpointer(dtype="uint16", flags="C_CONTIGUOUS")
        lib.aln_export_wire16.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, ctypes.c_longlong,
            i64p, ctypes.c_longlong, ctypes.c_longlong, u16p, u16p, i32p,
            ctypes.c_longlong, i8p, ctypes.c_int,
        ]
        lib.aln_export_wire16.restype = ctypes.c_longlong
        i16p = npc.ndpointer(dtype="int16", flags="C_CONTIGUOUS")
        lib.aln_finish_bulk.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, i16p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            llp, llp, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_finish_bulk.restype = ctypes.c_int
        u8p = npc.ndpointer(dtype="uint8", flags="C_CONTIGUOUS")
        lib.aln_finish_bulk8.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, u8p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            llp, llp, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_finish_bulk8.restype = ctypes.c_int
        lib.aln_finish_bulk16.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, i16p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            llp, llp, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_finish_bulk16.restype = ctypes.c_int
        lib.aln_solve_remaining.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            llp, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_solve_remaining.restype = ctypes.c_int
        lib.aln_solve_subset.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_solve_subset.restype = ctypes.c_int
        lib.aln_prepare_results.argtypes = [ctypes.c_void_p]
        lib.aln_prepare_results.restype = ctypes.c_int
        lib.aln_write_results.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_write_results.restype = ctypes.c_int
        lib.aln_store_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, i64p, ctypes.c_longlong,
            ctypes.c_longlong, i64p, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_store_rows.restype = ctypes.c_int
        lib.aln_results_counts.argtypes = [ctypes.c_void_p, i64p]
        lib.aln_results_counts.restype = ctypes.c_longlong
        lib.aln_results_group_sizes.argtypes = [ctypes.c_void_p, i64p]
        lib.aln_results_group_sizes.restype = ctypes.c_int
        lib.aln_results_fill.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
        lib.aln_results_fill.restype = ctypes.c_int
        lib.aln_results_counts_subset.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, i64p,
        ]
        lib.aln_results_counts_subset.restype = ctypes.c_longlong
        lib.aln_results_group_sizes_subset.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, i64p,
        ]
        lib.aln_results_group_sizes_subset.restype = ctypes.c_int
        lib.aln_results_fill_subset.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_longlong, i64p, i64p, i64p, i64p,
        ]
        lib.aln_results_fill_subset.restype = ctypes.c_int
        lib.aln_build_graph_one.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.aln_build_graph_one.restype = ctypes.c_int
        lib.aln_edge_meta.argtypes = [ctypes.c_void_p, ctypes.c_longlong, i64p]
        lib.aln_edge_meta.restype = ctypes.c_int
        lib.aln_export_edges.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, i32p, i32p, i64p, i32p,
            i32p, i32p, i64p,
        ]
        lib.aln_export_edges.restype = ctypes.c_int
        lib.aln_finish_sharded.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, i64p, i64p,
            ctypes.c_longlong, ctypes.c_int, llp, ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.aln_finish_sharded.restype = ctypes.c_int
        lib._np_registered = True
    return lib


def tune_heap() -> None:
    """Raise glibc's mmap/trim/top-pad thresholds so freed parse/graph
    memory stays mapped (idempotent).  The hypervisor taxes every
    demand fault ~50-500x the bulk-populate cost, so pages should fault
    once per process, not once per run — see heap.cc.  The native entry
    points apply this themselves; kept for callers that allocate big
    NumPy/tunnel buffers before first touching the library."""
    _ensure_lib().aln_tune_heap()


def drain_teardowns() -> None:
    """Join every pending background teardown (run()'s Garbage thread,
    GraphExporter.close()'s context delete).  Production callers never
    need this — teardown is deliberately off their path; benchmark
    loops call it BETWEEN reps so a previous rep's free() churn doesn't
    compete with the next rep's timed work."""
    _ensure_lib().aln_drain_teardowns()


def trace(on: bool) -> None:
    """Switch the host plane's counter table on or off (it starts off).
    While it is off the C++ plane reads no clock for it."""
    _ensure_lib().aln_trace(1 if on else 0)


def trace_read() -> dict:
    """The counter table since the last read, then reset: ``{slot:
    (seconds, count)}`` for every slot of ``src/solver.h``'s
    ``TraceSlot``, (0.0, 0) where a slot counted nothing.  Seconds are
    summed over threads, except the wall-time slots ``scan``, ``flush``,
    ``teardown``, ``alt_merge`` and ``alt_build``.  Only an alt PAF counts
    the last two: ``alt_merge`` once a merge (an exporter's open, ``run``,
    a shard), ``alt_build`` once an exporter's open."""
    lib = _ensure_lib()
    k = lib.aln_trace_slots()
    ns = (ctypes.c_longlong * k)()
    n = (ctypes.c_longlong * k)()
    lib.aln_trace_read(ns, n)
    return {lib.aln_trace_name(i).decode(): (ns[i] / 1e9, n[i])
            for i in range(k)}


class GraphExporter:
    """Native-built contig graphs, handed to the device engine as packed
    struct-of-arrays.  Use as a context manager."""

    def __init__(self, paf_path, alt_path=None, alt_baseline=0.5,
                 non_skip_linkable=False, threads=0, max_records=512,
                 config=None):
        import numpy as np

        self._np = np
        lib = get_lib()
        err = ctypes.create_string_buffer(4096)
        scoring = ScoringParams.from_config(config) if config is not None else None
        self._h = lib.aln_open2(
            os.fsencode(paf_path),
            os.fsencode(alt_path) if alt_path else b"",
            alt_baseline, 1 if non_skip_linkable else 0, threads,
            max_records, err, len(err),
            ctypes.byref(scoring) if scoring is not None else None,
        )
        if not self._h:
            raise NativeError(err.value.decode(errors="replace"))
        self._lib = lib

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._h:
            self._lib.aln_close(self._h)
            self._h = None

    def __len__(self):
        return int(self._lib.aln_num_contigs(self._h))

    def alt_counts(self) -> tuple[int, int]:
        """(alt lines read, records appended to contigs) of the alt
        merge; (0, 0) without an alt PAF."""
        out = (ctypes.c_longlong * 2)()
        self._lib.aln_alt_counts(self._h, out)
        return int(out[0]), int(out[1])

    # ---- bulk device-engine path (no per-contig Python) --------------

    def meta_bulk(self):
        """(n, 8) int64 rows: [built, n_records, n_vertices, n_edges,
        src, dest, score_bound, 0]."""
        np = self._np
        meta = np.empty((len(self), 8), np.int64)
        self._lib.aln_meta_bulk(self._h, meta.reshape(-1))
        return meta

    def export_wire(self, idx, V: int, W: int, threads: int = 0):
        """Sparse device wire format for the given contig indices,
        packed in C++: (len(idx), 2, W) int32 — (flat cell index,
        score|anom<<28) pairs + a dest entry, trash-padded (see
        ops/dense.py:dense_solve_wire).  Returns (wire, ok_mask);
        contigs with ok_mask False (parallel edges / packing envelope
        exceeded) must be excluded and solved natively."""
        np = self._np
        idx = np.ascontiguousarray(idx, np.int64)
        B = len(idx)
        wire = np.empty((B, 2, W), np.int32)
        status = np.empty((B,), np.int8)
        rc = self._lib.aln_export_wire(
            self._h, idx, B, V, W, wire.reshape(-1), status, threads,
        )
        if rc != 0:
            raise NativeError("wire export failed")
        return wire, status == 0

    def export_wire_ragged(self, idx, V: int, n_edges, pad_b: int,
                           threads: int = 0):
        """RAGGED device wire (ops/dense.py:_densify_wire_ragged): one
        (2, capN) int32 stream for the whole bucket — global flat cell
        indices b*V*(V+1)+cell and packed score|anom values, contig b's
        entries at [offs[b], offs[b+1]) with offs from ``n_edges`` + 2.
        No per-contig W padding: the transport carries only real edges
        (~2-3x fewer H2D bytes at 50k-contig scale than export_wire's
        (B, 2, W) slabs).  ``pad_b`` (>= len(idx)) is the batch size the
        device program was compiled for; the tail [offs[-1], capN) is
        trash-filled and seeds the padding contigs' dest/src cells so
        their slabs decode as empty well-formed graphs.  Returns
        (wire, ok_mask, capN_used) — contigs with ok_mask False must be
        dropped (rows filtered) before the finish."""
        np = self._np
        idx = np.ascontiguousarray(idx, np.int64)
        B = len(idx)
        assert pad_b >= B
        M = V * (V + 1)
        trash = pad_b * M
        assert trash + M < 2**31, "global flat index exceeds int32"
        offs = np.zeros(B + 1, np.int64)
        np.cumsum(np.asarray(n_edges, np.int64) + 2, out=offs[1:])
        n_real = int(offs[-1])
        # pow2-padded stream length; reserve 2 slots per padding contig
        # for its dest/src seeds
        need = n_real + 2 * (pad_b - B)
        cap = 1 << max(3, (need - 1).bit_length())
        wire = np.empty((2, cap), np.int32)
        status = np.empty((B,), np.int8)
        rc = self._lib.aln_export_wire_ragged(
            self._h, idx, B, V, offs, cap, trash, wire.reshape(-1),
            status, threads,
        )
        if rc != 0:
            raise NativeError("ragged wire export failed")
        wire[0, n_real:] = trash
        wire[1, n_real:] = 0
        if pad_b > B:
            k = np.arange(pad_b - B, dtype=np.int64)
            wire[0, n_real + 2 * k] = (B + k) * M + V * V       # dest -> 0
            wire[0, n_real + 2 * k + 1] = (B + k) * M + V * V + 1  # src -> 0
        return wire, status == 0, cap

    def export_wire16(self, idx, V: int, n_edges, pad_b: int,
                      threads: int = 0):
        """16-bit device wire (ops/dense.py:_densify_wire16) — HALF the
        H2D bytes of the i32 ragged wire: u16 cell deltas (per-contig
        cells are exported sorted) + u16 dictionary indices into an i32
        value table.  Returns (deltas, vidx, table, n_real, seeds,
        ok_mask) or None when 16-bit encoding is unsound for this
        bucket (V > 255, value table overflow) — callers then fall back
        to export_wire_ragged.  ``seeds`` is a (2, S) int32 array of
        extra scatter (cell, value) pairs seeding the padding contigs'
        dest/src cells."""
        np = self._np
        if V > 255:
            return None
        idx = np.ascontiguousarray(idx, np.int64)
        B = len(idx)
        assert pad_b >= B
        M = V * (V + 1)
        trash = pad_b * M
        assert trash + M < 2**31, "global flat index exceeds int32"
        offs = np.zeros(B + 1, np.int64)
        np.cumsum(np.asarray(n_edges, np.int64) + 2, out=offs[1:])
        n_real = int(offs[-1])
        cap = 1 << max(3, (n_real - 1).bit_length())
        deltas = np.zeros(cap, np.uint16)
        vidx = np.zeros(cap, np.uint16)
        table = np.zeros(65536, np.int32)
        status = np.empty((B,), np.int8)
        n_table = self._lib.aln_export_wire16(
            self._h, idx, B, V, offs, cap, trash, deltas, vidx, table,
            65536, status, threads,
        )
        if n_table == -2:
            raise NativeError("wire16 export failed")
        if n_table < 0:
            return None
        tcap = 1 << max(3, (int(n_table) - 1).bit_length())
        # padding contigs' dest/src cells seed empty well-formed slabs
        n_pad = pad_b - B
        S = 1 << max(3, (max(2 * n_pad, 1) - 1).bit_length())
        seeds = np.full((2, S), trash, np.int32)
        seeds[1] = 0
        if n_pad:
            k = np.arange(n_pad, dtype=np.int64)
            seeds[0, 2 * k] = ((B + k) * M + V * V).astype(np.int32)
            seeds[0, 2 * k + 1] = ((B + k) * M + V * V + 1).astype(np.int32)
        return (deltas, vidx, table[:tcap], np.int32(n_real), seeds,
                status == 0)

    def finish_bulk(self, idx, dp, V: int, threads: int = 0,
                    lazy_walks: bool = True):
        """Finish contigs `idx` from their (B, V + 5) int16 device nxt
        rows (ops/dense.py:dense_solve_wire_topo_nxt layout) —
        device-assisted fast finish (path chased from the achieving-
        successor array in C++) or full native solve, decided and
        executed in C++.  Returns (n_fast, n_fallback)."""
        np = self._np
        idx = np.ascontiguousarray(idx, np.int64)
        dp = np.ascontiguousarray(dp, np.int16)
        B, K = dp.shape
        assert K == V + 5 and B == len(idx)
        n_fast = ctypes.c_longlong()
        n_fb = ctypes.c_longlong()
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_finish_bulk(
            self._h, idx, B, dp.reshape(-1), V,
            1 if lazy_walks else 0, threads,
            ctypes.byref(n_fast), ctypes.byref(n_fb), err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))
        return int(n_fast.value), int(n_fb.value)

    def finish_bulk8(self, idx, dp, V: int, threads: int = 0,
                     lazy_walks: bool = True):
        """Finish contigs `idx` from their (B, V + 2) uint8 device rows
        (ops/dense.py:dense_solve_wire_topo_nxt8 layout — achieving-
        successor array + the on-device order-insensitivity gate).
        Returns (n_fast, n_fallback)."""
        np = self._np
        idx = np.ascontiguousarray(idx, np.int64)
        dp = np.ascontiguousarray(dp, np.uint8)
        B, K = dp.shape
        assert K == V + 2 and B == len(idx)
        n_fast = ctypes.c_longlong()
        n_fb = ctypes.c_longlong()
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_finish_bulk8(
            self._h, idx, B, dp.reshape(-1), V,
            1 if lazy_walks else 0, threads,
            ctypes.byref(n_fast), ctypes.byref(n_fb), err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))
        return int(n_fast.value), int(n_fb.value)

    def finish_bulk16(self, idx, dp, V: int, threads: int = 0,
                      lazy_walks: bool = True):
        """Finish contigs `idx` from their (B, V + 2) int16 gate rows
        (ops/dense.py:dense_solve_wire_topo_nxt16 layout — the
        single-chip big-contig path, 256 < V <= 32767).
        Returns (n_fast, n_fallback)."""
        np = self._np
        idx = np.ascontiguousarray(idx, np.int64)
        dp = np.ascontiguousarray(dp, np.int16)
        B, K = dp.shape
        assert K == V + 2 and B == len(idx)
        n_fast = ctypes.c_longlong()
        n_fb = ctypes.c_longlong()
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_finish_bulk16(
            self._h, idx, B, dp.reshape(-1), V,
            1 if lazy_walks else 0, threads,
            ctypes.byref(n_fast), ctypes.byref(n_fb), err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))
        return int(n_fast.value), int(n_fb.value)

    def solve_remaining(self, threads: int = 0, lazy_walks: bool = True) -> int:
        """Full native solve for every contig without a stored result."""
        n = ctypes.c_longlong()
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_solve_remaining(
            self._h, 1 if lazy_walks else 0, threads,
            ctypes.byref(n), err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))
        return int(n.value)

    def write_results(self, out_prefix: str, threads: int = 0) -> None:
        """Write the three output PAFs from the stored bulk results."""
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_write_results(
            self._h, os.fsencode(out_prefix), threads, err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))

    def store_rows(self, contig_idx: int, outs, alts, max_groups) -> None:
        """Store externally-computed results for one contig (e.g. the
        mesh edge-sharded Python solve of an oversize contig), so
        write_results serializes them and solve_remaining skips it.
        ``outs``/``alts`` are PafOutput-like sequences; ``max_groups``
        is a sequence of such sequences (the coverage-tie groups)."""
        np = self._np
        flat = list(outs) + list(alts) + [r for g in max_groups for r in g]
        rows = np.empty((max(len(flat), 1), 6), np.int64)
        for k, r in enumerate(flat):
            rows[k] = (r.ctg_index, r.edited_qry_str, r.edited_qry_end,
                       r.edited_ref_str, r.edited_ref_end,
                       1 if r.is_alt_path else 0)
        gsizes = np.asarray([len(g) for g in max_groups] or [0], np.int64)
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_store_rows(
            self._h, contig_idx, rows.reshape(-1), len(outs), len(alts),
            gsizes, len(max_groups), err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))

    def build_graph_one(self, i: int) -> None:
        """Build contig ``i``'s DAG on demand (graph-axis contigs exceed
        the constructor's max_records build gate); no-op if built."""
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_build_graph_one(self._h, i, err, len(err))
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))

    def edge_meta(self, i: int):
        """(built, V, E, src, dest, n_records) of contig ``i``'s DAG."""
        np = self._np
        out = np.empty((6,), np.int64)
        self._lib.aln_edge_meta(self._h, i, out)
        return tuple(int(v) for v in out)

    def export_edges(self, i: int):
        """u-major full-semiring edge arrays (eu, ev, es, ea, enz, etot,
        erank) of contig ``i``'s built DAG — the mesh-sharded
        relaxation's inputs (layout identical to engine/device.py:
        pack_graph)."""
        np = self._np
        built, V, E, _src, _dest, _n = self.edge_meta(i)
        if not built:
            raise NativeError(f"contig {i} has no built graph")
        eu = np.empty(E, np.int32)
        ev = np.empty(E, np.int32)
        es = np.empty(E, np.int64)
        ea = np.empty(E, np.int32)
        enz = np.empty(E, np.int32)
        etot = np.empty(E, np.int32)
        erank = np.empty(E, np.int64)
        rc = self._lib.aln_export_edges(self._h, i, eu, ev, es, ea, enz,
                                        etot, erank)
        if rc != 0:
            raise NativeError(f"edge export failed for contig {i}")
        return eu, ev, es, ea, enz, etot, erank

    def finish_sharded(self, i: int, d_s, d_a, lazy_walks: bool = True):
        """Finish one mesh-sharded contig from its device (d_s, d_a)
        suffix distances (floor/counts + gate + fast finish or full
        native solve, all in C++); stores the result.  Returns True when
        the device-assisted fast path ran."""
        np = self._np
        d_s = np.ascontiguousarray(d_s, np.int64)
        d_a = np.ascontiguousarray(d_a, np.int64)
        assert d_s.shape == d_a.shape and d_s.ndim == 1
        was_fast = ctypes.c_longlong()
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_finish_sharded(
            self._h, i, d_s, d_a, len(d_s), 1 if lazy_walks else 0,
            ctypes.byref(was_fast), err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))
        return bool(was_fast.value)

    def solve_subset(self, idx, threads: int = 0, lazy_walks: bool = True,
                     format_out: bool = False):
        """Full native solve for an explicit contig index subset (the
        multihost per-rank work; the device engine's non-device set on
        the overlap thread).  ``format_out`` pre-formats output parts
        inline so write_results stays flush-only; rows-only consumers
        leave it off."""
        np = self._np
        idx = np.ascontiguousarray(idx, np.int64)
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_solve_subset(
            self._h, idx, len(idx), 1 if lazy_walks else 0, threads,
            1 if format_out else 0, err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))

    def prepare_results(self) -> None:
        """Pre-size the result store so concurrent finish/solve calls
        from different host threads never race the lazy resize."""
        self._lib.aln_prepare_results(self._h)

    def fetch_results_raw(self):
        """Stored results as flat numpy arrays: (counts (n, 3), gsizes,
        main_rows, alt_rows, max_rows) with 6-column int64 rows — the
        zero-copy wire format for multihost partials and bulk fetches."""
        np = self._np

        n = len(self)
        counts = np.empty((n, 3), np.int64)
        total_groups = int(self._lib.aln_results_counts(self._h, counts.reshape(-1)))
        gsizes = np.empty((max(total_groups, 1),), np.int64)
        if total_groups:
            self._lib.aln_results_group_sizes(self._h, gsizes)
        gsizes = gsizes[:total_groups]
        n_main = int(counts[:, 0].sum())
        n_alt = int(counts[:, 1].sum())
        n_max = int(gsizes.sum()) if total_groups else 0
        main_rows = np.empty((max(n_main, 1) * 6,), np.int64)
        alt_rows = np.empty((max(n_alt, 1) * 6,), np.int64)
        max_rows = np.empty((max(n_max, 1) * 6,), np.int64)
        self._lib.aln_results_fill(self._h, main_rows, alt_rows, max_rows)
        return (counts, gsizes,
                main_rows[: n_main * 6].reshape(n_main, 6),
                alt_rows[: n_alt * 6].reshape(n_alt, 6),
                max_rows[: n_max * 6].reshape(n_max, 6))

    def fetch_results_for(self, idx):
        """Results for just the given contig indices, as lists aligned
        with ``idx`` — chunked consumers (resume) must not pay an
        all-contigs scan per chunk."""
        np = self._np
        from alignasm_tpu_torch.model.records import PafOutput

        idx = np.ascontiguousarray(idx, np.int64)
        k = len(idx)
        counts = np.empty((max(k, 1), 3), np.int64)
        total_groups = int(self._lib.aln_results_counts_subset(
            self._h, idx, k, counts.reshape(-1)))
        counts = counts[:k]
        n_main = int(counts[:, 0].sum()) if k else 0
        n_alt = int(counts[:, 1].sum()) if k else 0
        gsizes = np.empty((max(total_groups, 1),), np.int64)
        if total_groups:
            self._lib.aln_results_group_sizes_subset(self._h, idx, k, gsizes)
        n_max = int(gsizes[:total_groups].sum()) if total_groups else 0
        main_rows = np.empty((max(n_main, 1) * 6,), np.int64)
        alt_rows = np.empty((max(n_alt, 1) * 6,), np.int64)
        max_rows = np.empty((max(n_max, 1) * 6,), np.int64)
        if k:
            self._lib.aln_results_fill_subset(
                self._h, idx, k, gsizes, main_rows, alt_rows, max_rows)

        def conv(flat, total):
            rows = flat[: total * 6].reshape(total, 6).tolist()
            return [PafOutput(r[0], r[1], r[2], r[3], r[4], bool(r[5]))
                    for r in rows]

        mains = conv(main_rows, n_main)
        alts = conv(alt_rows, n_alt)
        maxes = conv(max_rows, n_max)
        outs, alt_outs, max_outs = [], [], []
        m = a = x = g = 0
        for ki in range(k):
            cm, ca, cg = (int(v) for v in counts[ki])
            outs.append(mains[m:m + cm]); m += cm
            alt_outs.append(alts[a:a + ca]); a += ca
            groups = []
            for _j in range(cg):
                sz = int(gsizes[g]); g += 1
                groups.append(maxes[x:x + sz]); x += sz
            max_outs.append(groups)
        return outs, alt_outs, max_outs

    def fetch_results(self):
        """All stored results as (outs, alt_outs, max_outs) PafOutput
        lists — two-pass bulk transfer, then one tight construction loop."""
        np = self._np
        from alignasm_tpu_torch.model.records import PafOutput

        n = len(self)
        counts = np.empty((n, 3), np.int64)
        total_groups = int(self._lib.aln_results_counts(self._h, counts.reshape(-1)))
        gsizes = np.empty((max(total_groups, 1),), np.int64)
        if total_groups:
            self._lib.aln_results_group_sizes(self._h, gsizes)
        n_main = int(counts[:, 0].sum())
        n_alt = int(counts[:, 1].sum())
        n_max = int(gsizes[:total_groups].sum()) if total_groups else 0
        main_rows = np.empty((max(n_main, 1) * 6,), np.int64)
        alt_rows = np.empty((max(n_alt, 1) * 6,), np.int64)
        max_rows = np.empty((max(n_max, 1) * 6,), np.int64)
        self._lib.aln_results_fill(self._h, main_rows, alt_rows, max_rows)

        def rows_to_outputs(flat, total):
            rows = flat[: total * 6].reshape(total, 6).tolist()
            return [PafOutput(r[0], r[1], r[2], r[3], r[4], bool(r[5]))
                    for r in rows]

        mains = rows_to_outputs(main_rows, n_main)
        alts = rows_to_outputs(alt_rows, n_alt)
        maxes = rows_to_outputs(max_rows, n_max)
        outs, alt_outs, max_outs = [], [], []
        m = a = x = g = 0
        for i in range(n):
            cm, ca, cg = (int(v) for v in counts[i])
            outs.append(mains[m:m + cm]); m += cm
            alt_outs.append(alts[a:a + ca]); a += ca
            groups = []
            for _k in range(cg):
                sz = int(gsizes[g]); g += 1
                groups.append(maxes[x:x + sz]); x += sz
            max_outs.append(groups)
        return outs, alt_outs, max_outs

    def write_outputs_flat(self, out_prefix: str, m_rows, m_off, a_rows,
                           a_off, x_rows, x_goff, gcnt_off,
                           threads: int = 0) -> None:
        """Clip + format + write the three PAFs from flat 6-column int64
        row arrays with per-contig (and per-max-group) offsets — the
        multihost rank-0 merge path."""
        np = self._np
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_write_outputs(
            self._h, os.fsencode(out_prefix),
            np.ascontiguousarray(m_rows, np.int64).reshape(-1),
            np.ascontiguousarray(m_off, np.int64),
            np.ascontiguousarray(a_rows, np.int64).reshape(-1),
            np.ascontiguousarray(a_off, np.int64),
            np.ascontiguousarray(x_rows, np.int64).reshape(-1),
            np.ascontiguousarray(x_goff, np.int64),
            np.ascontiguousarray(gcnt_off, np.int64), threads, err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))

    def write_outputs(self, out_prefix: str, outs, alt_outs, max_outs,
                      threads: int = 0) -> None:
        """Write the three output PAFs natively from PafOutput lists
        (the device engine's results) — clip + format + write in C++."""
        np = self._np

        def flat(groups):
            rows = []
            off = [0]
            for g in groups:
                for r in g:
                    rows.append((r.ctg_index, r.edited_qry_str, r.edited_qry_end,
                                 r.edited_ref_str, r.edited_ref_end,
                                 1 if r.is_alt_path else 0))
                off.append(len(rows))
            arr = np.asarray(rows, np.int64).reshape(-1, 6) if rows else \
                np.empty((0, 6), np.int64)
            return arr.reshape(-1), np.asarray(off, np.int64)

        m_rows, m_off = flat(outs)
        a_rows, a_off = flat(alt_outs)
        # max mode: flatten groups with a per-contig group-count index
        all_groups = []
        gcnt_off = [0]
        for groups in max_outs:
            all_groups.extend(groups)
            gcnt_off.append(len(all_groups))
        x_rows, x_goff = flat(all_groups)
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.aln_write_outputs(
            self._h, os.fsencode(out_prefix),
            m_rows, m_off, a_rows, a_off, x_rows, x_goff,
            np.asarray(gcnt_off, np.int64), threads, err, len(err),
        )
        if rc != 0:
            raise NativeError(err.value.decode(errors="replace"))


def run_shard(
    paf_path: str,
    shard_path: str | None,
    rank: int,
    world: int,
    digest: int = 0,
    alt_path: str | None = None,
    alt_baseline: float = 0.5,
    non_skip_linkable: bool = False,
    threads: int = 0,
    lazy_walks: bool = True,
    config=None,
    direct_prefix: str | None = None,
) -> dict:
    """One multihost rank's work: contig-group-sharded parse + solve +
    format over the rank's CONTIGUOUS record-balanced group range.
    Ranks > 0 publish a binary shard file of pre-formatted output text
    (atomic rename); rank 0 passes ``direct_prefix`` instead and its
    slice streams straight into <direct_prefix>.aln[.alt|.all].paf (it
    owns the head of every stream).  Returns
    {'n_total': ..., 'n_local': ...}."""
    lib = _ensure_lib()
    err = ctypes.create_string_buffer(4096)
    n_total = ctypes.c_longlong()
    n_local = ctypes.c_longlong()
    scoring = ScoringParams.from_config(config) if config is not None else None
    rc = lib.aln_run_shard(
        os.fsencode(paf_path),
        os.fsencode(alt_path) if alt_path else b"",
        alt_baseline, 1 if non_skip_linkable else 0, threads,
        1 if lazy_walks else 0, rank, world, digest,
        os.fsencode(shard_path) if shard_path else b"",
        os.fsencode(direct_prefix) if direct_prefix else b"",
        ctypes.byref(n_total), ctypes.byref(n_local), err, len(err),
        ctypes.byref(scoring) if scoring is not None else None,
    )
    if rc != 0:
        raise NativeError(err.value.decode(errors="replace"))
    return {"n_total": int(n_total.value), "n_local": int(n_local.value)}


def append_shard(out_prefix: str, shard_path: str, world: int, rank: int,
                 digest: int = 0, n_expected: int = -1,
                 threads: int = 0) -> None:
    """Rank 0's merge step for ONE landed shard: append its three
    stream blobs onto the output files (pure sequential blob
    concatenation — contiguous ranges make append-in-rank-order the
    whole merge; the three streams copy concurrently)."""
    lib = _ensure_lib()
    err = ctypes.create_string_buffer(4096)
    rc = lib.aln_append_shard(
        os.fsencode(out_prefix), os.fsencode(shard_path), world, rank,
        digest, n_expected, threads, err, len(err),
    )
    if rc != 0:
        raise NativeError(err.value.decode(errors="replace"))


def run(
    paf_path: str,
    alt_path: str | None = None,
    alt_baseline: float = 0.5,
    non_skip_linkable: bool = False,
    threads: int = 0,
    lazy_walks: bool = True,
    out_prefix: str | None = None,
    config=None,
) -> dict:
    """Run the full native pipeline; writes <stem>.aln[.alt|.all].paf.
    ``config`` (an AlignasmConfig) forwards custom scoring constants.
    Returns phase timings and counters."""
    lib = _ensure_lib()
    err = ctypes.create_string_buffer(4096)
    stats = Stats()
    scoring = ScoringParams.from_config(config) if config is not None else None
    rc = lib.aln_run_stats2(
        os.fsencode(paf_path),
        os.fsencode(alt_path) if alt_path else b"",
        alt_baseline,
        1 if non_skip_linkable else 0,
        threads,
        1 if lazy_walks else 0,
        os.fsencode(out_prefix) if out_prefix else b"",
        err,
        len(err),
        ctypes.byref(stats),
        ctypes.byref(scoring) if scoring is not None else None,
    )
    if rc != 0:
        raise NativeError(err.value.decode(errors="replace"))
    return {
        "read_s": stats.read_s,
        "solve_s": stats.solve_s,
        "write_s": stats.write_s,
        "contigs": stats.contigs,
        "records": stats.records,
    }
