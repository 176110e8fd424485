"""alignasm_tpu_torch — the device engine of alignasm_tpu on PyTorch and
hand-written CUDA kernels.

It imports nothing of ``alignasm_tpu``: the JAX package's JAX-free
modules live here as copies (import prefixes changed, logic unchanged,
held to the originals by tests/test_torch_python_plane.py):

  config.py, io/ (cs, paf), model/ (records, distance), testing/synth.py,
  engine/ (introsort, graph, kshortest, dial, pqvec, singlepiece, exact,
  device), native/ (the C++ host plane; built into build/ at first use)

and the device path is ported:

  ops/      plain PyTorch versions, wire transport, CUDA kernel wrappers
  csrc/     the CUDA C++ kernels (built with nvcc at first use)
  runtime/  the bucket scheduler around the kernels (solve_dataset_torch):
            the native plane and the Python plane; the routing cost model
            (costmodel.py, a copy) and its calibration on the card
            (devbench.py --calibrate, calibration.json); resume
            (checkpoint.py, a copy); the exact engine's process pool
            (parallel_host.py, a copy)
  cli.py    ``python -m alignasm_tpu_torch.cli in.paf [--engine cuda]``

Every public function takes ``device``: a CPU device runs the plain
versions, a CUDA device the kernels.  The package never imports jax.
"""

__version__ = "0.2.0"
