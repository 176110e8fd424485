"""Device ops of the port: plain PyTorch versions (dense.py), the
host-to-device wire transport (wire.py) and the CUDA kernel wrappers
(cuda_densify.py, cuda_topo.py, cuda_blocked.py; kernels in ../csrc,
built by _build.py)."""

from __future__ import annotations


def _wrappers():
    from alignasm_tpu_torch.ops import cuda_blocked, cuda_densify, cuda_topo

    return {
        "densify_wire16": cuda_densify.densify_wire16,
        "densify_ragged": cuda_densify.densify_ragged,
        "topo_scan": cuda_topo.topo_scan_nxt8,
        "blocked_dp": cuda_blocked.blocked_dp_nxt16,
    }


def launch_counts() -> dict:
    """Kernel name -> launches counted by its wrapper."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
