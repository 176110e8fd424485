"""Device ops of the port: plain PyTorch versions (dense.py, relax32.py,
relax.py, dense_sp.py), the host-to-device wire transport (wire.py) and
the CUDA kernel wrappers (cuda_densify.py, cuda_topo.py, cuda_blocked.py,
cuda_sweep.py, cuda_relax32.py, cuda_dense_sp.py; kernels in ../csrc,
built by _build.py)."""

from __future__ import annotations


def _wrappers():
    """Kernel name -> the wrappers that launch it."""
    from alignasm_tpu_torch.ops import (
        cuda_blocked, cuda_dense_sp, cuda_densify, cuda_relax32, cuda_sweep,
        cuda_topo,
    )

    return {
        "densify_wire16": (cuda_densify.densify_wire16,),
        "densify_ragged": (cuda_densify.densify_ragged,),
        "topo_scan": (cuda_topo.topo_scan_nxt8,),
        "blocked_dp": (cuda_blocked.blocked_dp_nxt16,),
        "sweep_dense": (cuda_sweep.sweep_dense_batch,
                        cuda_sweep.sweep_dense_slabs),
        "relax32": (cuda_relax32.relax32,),
        "dense_sp": (cuda_dense_sp.dense_sp,),
    }


def launch_counts() -> dict:
    """Kernel name -> launches counted by its wrappers."""
    return {name: sum(fn.launches for fn in fns)
            for name, fns in _wrappers().items()}


def reset_launch_counts() -> None:
    for fns in _wrappers().values():
        for fn in fns:
            fn.launches = 0
