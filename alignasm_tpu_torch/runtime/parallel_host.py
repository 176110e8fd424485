"""Process pool of the exact engine (``--engine exact -t N``): a copy of
``solve_dataset_parallel``, ``_init_worker`` and ``_solve_one`` of
``alignasm_tpu/runtime/scheduler.py``.

The module imports neither torch nor anything of the device path, so a
worker that imports it to unpickle ``_solve_one`` loads only the exact
engine.  Edit of the copy: the workers start with the ``spawn`` method
(``multiprocessing.get_context``) instead of the platform's default,
since ``fork`` is unsafe in a process that may hold threads (the native
plane's teardown threads, torch's); each worker starts from a fresh
import and gets the config through ``initargs``.
"""

from __future__ import annotations

import multiprocessing as mp
import os

from alignasm_tpu_torch.config import AlignasmConfig
from alignasm_tpu_torch.engine.exact import solve_contig

_WORKER_CFG = None


def _init_worker(cfg):
    global _WORKER_CFG
    _WORKER_CFG = cfg


def _solve_one(args):
    idx, contig = args
    return idx, solve_contig(contig, _WORKER_CFG)


def solve_dataset_parallel(dataset, cfg: AlignasmConfig, n_workers: int):
    """Solve all contigs with a process pool; output order preserved."""
    n = len(dataset.contigs)
    n_workers = max(1, min(n_workers, os.cpu_count() or 1))
    outs = [None] * n
    alt_outs = [None] * n
    max_outs = [None] * n
    # largest contigs first for load balance
    order = sorted(range(n), key=lambda i: -len(dataset.contigs[i]))
    ctx = mp.get_context("spawn")
    with ctx.Pool(n_workers, initializer=_init_worker,
                  initargs=(cfg,)) as pool:
        for idx, (o, a, m) in pool.imap_unordered(
            _solve_one, ((i, dataset.contigs[i]) for i in order), chunksize=1
        ):
            outs[idx] = o
            alt_outs[idx] = a
            max_outs[idx] = m
    return outs, alt_outs, max_outs
