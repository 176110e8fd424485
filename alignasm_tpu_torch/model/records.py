"""PAF record containers.

Mirrors the reference data model (PafReadData / PafOutputData,
/root/reference/src/paf_data.hpp:51-105) with numpy interval arrays in
place of vectors-of-pairs.  All coordinates are **closed intervals**
after normalization (PAF half-open ends are decremented on read,
re-incremented on write — alignasm.cpp:144,150,429,434), and for
reverse-strand records ``ref_str/ref_end`` are swapped so reference
coordinates always follow increasing query coordinates
(alignasm.cpp:156-159).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from alignasm_tpu_torch.io.cs import CsOps

TYPE_MAIN = 0
TYPE_ALT = 1


@dataclasses.dataclass
class PafRecord:
    paf_index: int = -1
    ctg_index: int = -1
    ctg_sorted_index: int = -1
    cs: CsOps | None = None
    mat_num: int = 0
    aln_len: int = 0
    # (m, 2) closed intervals per match run, query orientation
    qry_overlap_range: np.ndarray | None = None
    ref_overlap_range: np.ndarray | None = None
    qry_total_length: int = 0
    ref_total_length: int = 0
    qry_str: int = 0
    qry_end: int = 0
    ref_str: int = 0
    ref_end: int = 0
    ref_chr: int = -1
    map_qul: int = 0
    aln_fwd: bool = True
    original_cord: tuple[int, int] = (TYPE_MAIN, -1)

    def sort_key(self):
        return (self.qry_str, self.qry_end)

    def qry_contains(self, other: "PafRecord") -> bool:
        return self.qry_str <= other.qry_str and other.qry_end <= self.qry_end


def qry_partial_overlap(lft: PafRecord, rht: PafRecord) -> bool:
    """Partial (non-containment) query overlap — paf_data.hpp:78-86."""
    if lft.qry_str < rht.qry_str:
        return rht.qry_str <= lft.qry_end < rht.qry_end
    if rht.qry_str < lft.qry_str:
        return lft.qry_str <= rht.qry_end < lft.qry_end
    return False


@dataclasses.dataclass
class PafOutput:
    """One output row: a (possibly cut) view of a PafRecord."""

    ctg_index: int
    edited_qry_str: int
    edited_qry_end: int
    edited_ref_str: int
    edited_ref_end: int
    is_alt_path: bool = False

    @classmethod
    def from_record(cls, rec: PafRecord) -> "PafOutput":
        return cls(rec.ctg_index, rec.qry_str, rec.qry_end, rec.ref_str, rec.ref_end)
