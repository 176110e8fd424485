"""Host-to-device transport of the native exporter's wires.

The exporter (alignasm_tpu_torch/native, the port's copy of the JAX
package's C++ host plane) writes
numpy arrays; these functions move them to ``device`` as the tensors
ops/dense.py takes.  The u16 streams of the 16-bit wire travel as their
raw 2 bytes (an int16 view, since PyTorch has few uint16 ops), so the
bytes moved equal the JAX path's; the kernels widen them with
``& 0xFFFF`` on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def as_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device that is not available
    raises (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"CUDA device {dev} requested but "
                               f"torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _to(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def wire16_to_device(w16, device):
    """``export_wire16``'s (deltas, vidx, table, n_real, seeds, ok) ->
    (deltas, vidx, table, seeds, n_real) for dense_solve_wire16_topo_nxt8;
    ``ok`` stays on the host."""
    deltas, vidx, table, n_real, seeds, _ok = w16
    dev = as_device(device)
    return (_to(deltas.view(np.int16), dev), _to(vidx.view(np.int16), dev),
            _to(table, dev), _to(seeds, dev), int(n_real))


def ragged_to_device(wire, device):
    """``export_wire_ragged``'s (2, capN) int32 wire -> tensor on ``device``."""
    return _to(wire, as_device(device))
