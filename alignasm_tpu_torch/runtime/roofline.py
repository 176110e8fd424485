"""The card's rates and the least time a kernel could take for its work.

``chip_smoke.py`` and the bench sections of ``runtime/devbench.py`` both
reckon a kernel's bound here, so the same work gets the same bound in
both.  A bound is the larger of two times: the bytes the function must
move (each input read once, each output written once) over the card's
memory rate, and the operations one pass over its inputs needs over the
card's issue rate.  ``mem_peak`` gives the memory rate of the card a run
found, by name, for the bench's share-of-peak fields.
"""

from __future__ import annotations

# The card's rates for the bound (H100 SXM data sheet, 700 W): device
# memory, and the issue rate of 32-bit scalar operations.  Each of an SM's
# four schedulers issues one 32-lane instruction a clock: 132 SMs x 128 a
# clock at the 1.98 GHz of the data sheet's 67 TFLOP/s float32, which
# counts an FMA as two operations, so 33.5e12 a second.  int32 add,
# compare, min and max run at half that (64 a clock per SM on compute
# capability 9.0: CUDA C++ Programming Guide, throughput of the arithmetic
# instructions); the issue rate keeps the bound a lower bound whatever
# the mix.
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12 / 2
# Operations of one pass, the least work of each function: the sweep
# kernels' vectors are DAG dynamic programs that one reverse-topological
# pass computes, however many Jacobi sweeps a kernel runs.  Per edge of
# the five vectors of the sweep solve and the int32 relaxation: the sum
# and anomaly adds, a lexicographic compare (4) and two selects; the
# floor's add and min; the walk count's add; the min-walk test's two
# compares, and, add.
PATH_OPS = 15
# Per edge of dense_sp's cascade: four adds, the f32 key's two
# conversions, clamp, division and negation, the four-key lexicographic
# compare (10), six selects.
DENSE_SP_OPS = 25
# Per edge of the int64 relaxation, one pass: the four sums, the packed
# key (2), the mapq key (3), the three-key lexicographic compare (6), six
# selects, the floor's add and min, the walk count's add and the min-walk
# test (4), 28 int64 operations of two 32-bit issue slots each.
SP64_OPS = 56
SCAN_OPS = 25        # per needed cell: three reduction rounds a row
FOLD_OPS = 15        # blocked solve: per needed cell, folded once

# Device-memory rate by card name, first match wins (NVIDIA data sheets):
# the PCIe and NVL parts, then any other H100 (SXM).  A card not listed
# has no peak here: its share-of-peak fields are null, never a default.
MEM_PEAKS = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))


def mem_peak(kind: str) -> float | None:
    """Memory bytes/s of the card named ``kind``
    (``torch.cuda.get_device_name``), or None for a card not in
    ``MEM_PEAKS`` or the CPU."""
    for pattern, peak in MEM_PEAKS:
        if pattern in kind:
            return peak
    return None


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dp_cells(slabs) -> int:
    """Cells the scan and the blocked solve need: every edge lies in a
    slab's strict upper triangle (u < v) except those into dest, which may
    sit anywhere, so the strict upper triangle and dest's column below the
    diagonal."""
    B, _, V = slabs.shape
    dest = slabs[:, V, 0].long().clamp(0, V - 1)
    return B * V * (V - 1) // 2 + int((V - 1 - dest).sum())


def dp_bytes(slabs, rows) -> int:
    """Bytes the scan and the blocked solve need, each read or written
    once: the needed cells, the trailer row's dest and src, and the output
    rows."""
    return 4 * (dp_cells(slabs) + 2 * slabs.shape[0]) + nbytes_of(rows)


def bound_ms(nbytes: int, nops: int) -> tuple[float, float]:
    """(ms by bytes, ms by operations) of one kernel's work; its bound is
    the larger."""
    return 1e3 * nbytes / MEM_BYTES_PER_S, 1e3 * nops / OPS_PER_S


def densify_work(wire, slabs) -> tuple[int, int]:
    """(bytes, operations) of a densify: the wire tensors read, the slabs
    written (a store a cell, no arithmetic counted)."""
    return nbytes_of(*wire, slabs), 0


def densify_wire_work(wire, slabs) -> tuple[int, int]:
    """(bytes, operations) of the fixed-width densify: the (B, 2, W) wire
    read, the slabs written, one index check a wire entry."""
    return nbytes_of(wire, slabs), wire.shape[0] * wire.shape[2]


def scan_work(slabs, rows) -> tuple[int, int]:
    """(bytes, operations) of the reverse-topological scan."""
    return dp_bytes(slabs, rows), dp_cells(slabs) * SCAN_OPS


def blocked_work(slabs, rows) -> tuple[int, int]:
    """(bytes, operations) of the blocked solve."""
    return dp_bytes(slabs, rows), dp_cells(slabs) * FOLD_OPS


def path_work(tensors, rows, n_edges: int) -> tuple[int, int]:
    """(bytes, operations) of a sweep solve or the int32 relaxation: its
    input tensors and output rows once, one pass over ``n_edges`` valid
    edges."""
    return nbytes_of(*tensors, rows), n_edges * PATH_OPS


def bound(*works) -> dict:
    """The bound of kernels run one after another, each with its (bytes,
    operations): the sum of each kernel's larger time, and which of bytes
    or operations sets the larger share of it."""
    by = [bound_ms(nb, nops) for nb, nops in works]
    return {"bound_ms": sum(max(b, o) for b, o in by),
            "bound_by": "bytes" if sum(b for b, _ in by)
            >= sum(o for _, o in by) else "operations"}
