"""Build and load the CUDA kernels in ``alignasm_tpu_torch/csrc``.

Each source compiles with its own ``nvcc``, all started together, and
the objects link into one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds).  The library lives in ``alignasm_tpu_torch/build/``, named by a
hash of the sources and flags, so a changed source builds anew and an
unchanged one is reused.  It builds at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
# no fast math: dense_sp.cu's f32 key needs IEEE division
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build, None if reused


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / f"libaln_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with the first failure's
    stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    errs = [p.communicate()[1] for p in procs]  # waits for every one
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{err[-8000:]}")


def _compile(out: pathlib.Path) -> None:
    global build_seconds
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"tmp.{os.getpid()}"
    tmp = out.with_suffix(f".so.{tag}")
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [_BUILD / f"{p.stem}.{out.stem}.{tag}.o" for p in srcs]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                  for p, o in zip(srcs, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent process sees all or none
    finally:
        for f in [tmp, *objs]:
            if f.exists():
                f.unlink()
    build_seconds = time.perf_counter() - t0


def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.aln_densify_scatter.argtypes = [i32, p, p, i64, i64, p, p]
    lib.aln_densify_wire16.argtypes = [i32, p, p, p, i32, i64, i64, i64, p, p]
    lib.aln_topo_scan_nxt8.argtypes = [i32, p, i64, i32, p, p]
    lib.aln_blocked_dp_nxt16.argtypes = [i32, p, i64, i32, i32, p, p, p]
    lib.aln_blocked_dp_scratch_words.argtypes = []
    lib.aln_sweep_dense.argtypes = [i32, p, p, p, i32, i64, i32, i32, p, p]
    lib.aln_relax32.argtypes = [i32, p, p, p, p, p, p, i64, i64, i32, i32,
                                p, p]
    lib.aln_dense_sp.argtypes = [i32, p, p, p, p, p, p, i64, i32, i32, p, p]
    for fn in (lib.aln_densify_scatter, lib.aln_densify_wire16,
               lib.aln_topo_scan_nxt8, lib.aln_blocked_dp_nxt16,
               lib.aln_blocked_dp_scratch_words, lib.aln_sweep_dense,
               lib.aln_relax32, lib.aln_dense_sp):
        fn.restype = ctypes.c_int
    lib.aln_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aln_cuda_error_string.restype = ctypes.c_char_p


def load_library():
    """The loaded kernel library, built first if needed.  Raises if nvcc
    is missing or the build fails (with nvcc's stderr)."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            _bind(lib)
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = _lib.aln_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def require(t, name: str, dtype, ndim: int) -> None:
    """Argument check of a kernel wrapper: a contiguous CUDA tensor of the
    given dtype and rank.  A kernel takes nothing else."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t):
    """(device index, raw handle of PyTorch's current stream) for ``t``."""
    import torch

    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream
