"""The yardstick of ``kernel_roofline_pct``: the card's published rates and
the least work of a pass's dynamic programs, counted from the reference's
DAGs.

The rates and ``PATH_OPS`` are frozen copies of
``alignasm_tpu_torch/runtime/roofline.py``'s (NVIDIA's H100 SXM data
sheet, 700 W).  The work is the benchmark's own count, which no program
change can move: for each contig the device route takes, each edge read
once (its cell and its packed score, 8 bytes), each vertex's gate entry
and the contig's fast flag and src written once (one byte an entry for a
contig of at most 256 vertices, else two), and one reverse-topological
pass of ``PATH_OPS`` operations an edge.
"""

from __future__ import annotations

import numpy as np

MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12 / 2
# Per edge of one pass of the DAG dynamic program: the sum and anomaly
# adds, a lexicographic compare (4) and two selects; the floor's add and
# min; the walk count's add; the min-walk test's two compares, and, add.
PATH_OPS = 15
EDGE_BYTES = 8


def pass_work(n_v, n_e, eligible) -> tuple[int, int]:
    """(bytes, operations) of one pass over the device route's contigs."""
    n_v = np.asarray(n_v, np.int64)[eligible]
    n_e = np.asarray(n_e, np.int64)[eligible]
    entry = np.where(n_v <= 256, 1, 2)
    nbytes = int((EDGE_BYTES * n_e + entry * (n_v + 2)).sum())
    return nbytes, int(n_e.sum()) * PATH_OPS


def least_seconds(nbytes: int, nops: int) -> float:
    """The least time the card could take: the larger of bytes over its
    memory rate and operations over its instruction rate."""
    return max(nbytes / MEM_BYTES_PER_S, nops / OPS_PER_S)
