"""Synthetic PAF generator.

The reference repo ships no test data (SURVEY.md §4), so we synthesize
contig-vs-reference PAF files with short-form cs tags that exercise the
full solver surface: partial query overlaps (cut points), containment,
gaps, inversions, translocations, reverse strands, mapq-zero records,
and multi-part contigs.  All generated records satisfy the reference's
strict parse-time invariants (cs consumption == PAF coords,
paf_data.cpp:119-122).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_BASES = "acgt"


@dataclasses.dataclass
class SynthRecord:
    qry_name: str
    qry_total: int
    qry_str: int          # half-open file coords
    qry_end: int
    fwd: bool
    ref_name: str
    ref_total: int
    ref_str: int          # half-open file coords
    ref_end: int
    mat_num: int
    aln_len: int
    mapq: int
    cs: str

    def to_line(self) -> str:
        return "\t".join(
            [
                self.qry_name,
                str(self.qry_total),
                str(self.qry_str),
                str(self.qry_end),
                "+" if self.fwd else "-",
                self.ref_name,
                str(self.ref_total),
                str(self.ref_str),
                str(self.ref_end),
                str(self.mat_num),
                str(self.aln_len),
                str(self.mapq),
                "tp:A:P",  # extra tag before cs, exercises tag scanning
                self.cs,
            ]
        )


def _rand_seq(rng: np.random.Generator, n: int) -> str:
    return "".join(_BASES[i] for i in rng.integers(0, 4, size=n))


def _gen_ops(rng: np.random.Generator, approx_len: int):
    """Generate query-oriented cs ops.

    Returns (ops, qry_consumed, ref_consumed, mat_num, aln_len) where ops
    is a list of (kind, text) with kind in ':*+-'.
    """
    ops = []
    qry = ref = mat = aln = 0
    remaining = approx_len
    while remaining > 0:
        run = int(rng.integers(1, max(2, min(remaining, 500))))
        ops.append((":", ":" + str(run)))
        qry += run
        ref += run
        mat += run
        aln += run
        remaining -= run
        if remaining <= 0:
            break
        kind = rng.random()
        if kind < 0.5:
            a, b = rng.integers(0, 4, size=2)
            b = (a + 1 + b % 3) % 4  # different base
            ops.append(("*", "*" + _BASES[a] + _BASES[b]))
            qry += 1
            ref += 1
            aln += 1
            remaining -= 1
        elif kind < 0.75:
            n = int(rng.integers(1, 8))
            ops.append(("+", "+" + _rand_seq(rng, n)))
            qry += n
            aln += n
        else:
            n = int(rng.integers(1, 8))
            ops.append(("-", "-" + _rand_seq(rng, n)))
            ref += n
            aln += n
    # ops must start and end with matches for clean interval structure
    if ops[-1][0] != ":":
        ops.append((":", ":3"))
        qry += 3
        ref += 3
        mat += 3
        aln += 3
    return ops, qry, ref, mat, aln


def _make_record(
    rng: np.random.Generator,
    qry_name: str,
    qry_total: int,
    qry_pos: int,
    approx_len: int,
    ref_name: str,
    ref_total: int,
    ref_pos: int,
    fwd: bool,
    mapq: int,
) -> tuple[SynthRecord, int, int]:
    """Build one record starting at qry_pos/ref_pos; returns (record,
    qry_consumed, ref_consumed)."""
    ops, qlen, rlen, mat, aln = _gen_ops(rng, approx_len)
    texts = [t for _, t in ops]
    if not fwd:
        texts = texts[::-1]
    cs = "cs:Z:" + "".join(texts)
    rec = SynthRecord(
        qry_name=qry_name,
        qry_total=qry_total,
        qry_str=qry_pos,
        qry_end=qry_pos + qlen,
        fwd=fwd,
        ref_name=ref_name,
        ref_total=ref_total,
        ref_str=ref_pos,
        ref_end=ref_pos + rlen,
        mat_num=mat,
        aln_len=aln,
        mapq=mapq,
        cs=cs,
    )
    return rec, qlen, rlen


def generate_paf(
    n_contigs: int = 20,
    seed: int = 0,
    max_records_per_contig: int = 24,
    mean_segment: int = 400,
) -> str:
    """Generate a synthetic PAF as a single string."""
    rng = np.random.default_rng(seed)
    ref_chrs = [(f"chr{i + 1}", int(rng.integers(200_000, 400_000))) for i in range(4)]
    lines: list[str] = []

    for ci in range(n_contigs):
        qry_name = f"ctg{ci:05d}"
        n_rec = int(rng.integers(1, max_records_per_contig + 1))
        qry_total = int(n_rec * mean_segment * 2 + rng.integers(500, 3000))
        qry_pos = int(rng.integers(0, 200))
        ref_i = int(rng.integers(0, len(ref_chrs)))
        ref_name, ref_total = ref_chrs[ref_i]
        ref_pos = int(rng.integers(0, ref_total // 2))
        fwd = True
        recs: list[SynthRecord] = []
        for _ in range(n_rec):
            approx = int(rng.integers(mean_segment // 2, mean_segment * 2))
            mapq = int(rng.choice([0, 1, 20, 60], p=[0.1, 0.1, 0.2, 0.6]))
            event = rng.random()
            if event < 0.12:  # inversion
                fwd = not fwd
                ref_pos += int(rng.integers(0, 50))
            elif event < 0.2:  # translocation
                ref_i = int(rng.integers(0, len(ref_chrs)))
                ref_name, ref_total = ref_chrs[ref_i]
                ref_pos = int(rng.integers(0, ref_total // 2))
                fwd = True
            else:  # plain gap on the reference
                ref_pos += int(rng.integers(0, 120))

            rec, qlen, rlen = _make_record(
                rng, qry_name, qry_total, qry_pos, approx,
                ref_name, ref_total, ref_pos, fwd, mapq,
            )
            recs.append(rec)

            # Occasionally emit a competing overlapping record mapping to a
            # shifted reference location — exercises cut-point machinery.
            if n_rec > 1 and rng.random() < 0.35:
                ov = int(rng.integers(5, max(6, qlen // 2)))
                dup_start = qry_pos + qlen - ov
                dup_ref = ref_pos + int(rng.integers(0, 3000))
                dup, dq, dr = _make_record(
                    rng, qry_name, qry_total, dup_start,
                    int(rng.integers(ov + 20, ov + mean_segment)),
                    ref_name, ref_total, dup_ref, fwd,
                    int(rng.choice([0, 30, 60])),
                )
                recs.append(dup)
                # advance past the competing record with a gap
                qry_pos = dup_start + dq + int(rng.integers(1, 60))
                ref_pos = dup_ref + dr + int(rng.integers(0, 80))
            else:
                qry_pos += qlen + int(rng.integers(1, 80))
                ref_pos += rlen

        tail = max(r.qry_end for r in recs)
        qry_total = max(qry_total, tail + int(rng.integers(1, 500)))
        for r in recs:
            r.qry_total = qry_total
        lines.extend(r.to_line() for r in recs)

    return "\n".join(lines) + "\n"


def generate_hard_paf(
    n_contigs: int = 30,
    seed: int = 0,
    mean_segment: int = 300,
) -> str:
    """Adversarial generator aimed at the alt/max output paths.

    Injects (a) *ambiguous segments*: a query stretch with two competing
    mappings — a cheap translocated one (anomaly) vs an expensive
    same-chromosome one (no anomaly) — so the best path carries more
    anomalies than the floor and the alt-path slope scan fires
    (paf_data.cpp:1613-1649); and (b) *duplicate segments*: identical
    cs/query intervals at different reference offsets, producing
    equal-score equal-coverage path ties for the .all output
    (paf_data.cpp:1595-1611).
    """
    rng = np.random.default_rng(seed)
    ref_chrs = [(f"chr{i + 1}", int(rng.integers(300_000, 500_000))) for i in range(3)]
    lines: list[str] = []

    for ci in range(n_contigs):
        qry_name = f"hctg{ci:05d}"
        n_seg = int(rng.integers(3, 10))
        qry_total = int(n_seg * mean_segment * 3 + 2000)
        qry_pos = int(rng.integers(0, 100))
        ref_i = 0
        ref_name, ref_total = ref_chrs[ref_i]
        ref_pos = int(rng.integers(0, 50_000))
        recs: list[SynthRecord] = []
        for si in range(n_seg):
            approx = int(rng.integers(mean_segment // 2, mean_segment * 2))
            mapq = int(rng.choice([0, 20, 60], p=[0.15, 0.25, 0.6]))
            style = rng.random()
            if style < 0.35:
                # ambiguous segment: same query span mapped twice
                rec_a, qlen, _r = _make_record(
                    rng, qry_name, qry_total, qry_pos, approx,
                    ref_name, ref_total,
                    ref_pos + int(rng.integers(20_000, 60_000)),  # big same-chr gap
                    True, mapq,
                )
                alt_chr_i = (ref_i + 1) % len(ref_chrs)
                alt_name, alt_total = ref_chrs[alt_chr_i]
                ops, q2, r2, mat, aln = _gen_ops(rng, qlen)
                # competing mapping over the same query interval, other chr
                while q2 != qlen:
                    ops, q2, r2, mat, aln = _gen_ops(rng, qlen)
                alt_ref_str = int(rng.integers(0, alt_total // 2))
                rec_b = SynthRecord(
                    qry_name=qry_name, qry_total=qry_total,
                    qry_str=qry_pos, qry_end=qry_pos + q2, fwd=True,
                    ref_name=alt_name, ref_total=alt_total,
                    ref_str=alt_ref_str, ref_end=alt_ref_str + r2,
                    mat_num=mat, aln_len=aln,
                    mapq=int(rng.choice([0, 60])),
                    cs="cs:Z:" + "".join(t for _, t in ops),
                )
                recs.extend([rec_a, rec_b])
                ref_pos = rec_a.ref_end
                qry_pos += qlen + int(rng.integers(1, 60))
            elif style < 0.55:
                # duplicate segment: identical cs, shifted ref, same chr
                rec_a, qlen, rlen = _make_record(
                    rng, qry_name, qry_total, qry_pos, approx,
                    ref_name, ref_total, ref_pos + int(rng.integers(0, 100)),
                    True, mapq,
                )
                shift = int(rng.integers(5_000, 9_000))
                rec_b = dataclasses.replace(
                    rec_a, ref_str=rec_a.ref_str + shift, ref_end=rec_a.ref_end + shift
                )
                recs.extend([rec_a, rec_b])
                ref_pos = rec_a.ref_end
                qry_pos += qlen + int(rng.integers(1, 60))
            else:
                fwd = bool(rng.random() > 0.25)
                rec, qlen, rlen = _make_record(
                    rng, qry_name, qry_total, qry_pos, approx,
                    ref_name, ref_total, ref_pos + int(rng.integers(0, 150)),
                    fwd, mapq,
                )
                recs.append(rec)
                ref_pos = rec.ref_end
                qry_pos += qlen + int(rng.integers(1, 60))

        tail = max(r.qry_end for r in recs)
        qry_total = max(qry_total, tail + int(rng.integers(1, 400)))
        for r in recs:
            r.qry_total = qry_total
        lines.extend(r.to_line() for r in recs)

    return "\n".join(lines) + "\n"


def generate_boundary_paf(
    n_contigs: int = 12,
    seed: int = 0,
) -> str:
    """Boundary-composition generator for the differential campaign.

    Where ``generate_paf``/``generate_hard_paf`` sample *typical* and
    *tie-rich* structure, this one composes degenerate coordinate motifs
    that sit exactly on the reference's decision boundaries: singleton
    contigs (paf_data.cpp:235-239 passthrough), minimal ``:1`` records,
    exact duplicates, zero/one-base query gaps and one-base overlaps
    (closed-interval linkability edges, paf_data.cpp:248-262), full
    containment, mapq values straddling the uint8 wrap (paf_data.hpp:65),
    all-mapq-zero contigs (0/n qul fraction ties), strand flips on the
    first record, and reference gaps straddling SV_BASELINE = 1e6
    (paf_data.hpp:25 translocation threshold).
    """
    rng = np.random.default_rng(seed)
    ref_chrs = [(f"chr{i + 1}", 4_000_000) for i in range(3)]
    lines: list[str] = []

    def mk(qry_name, qry_pos, approx, ref_name, ref_total, ref_pos, fwd, mapq,
           qry_total=10**7):
        rec, qlen, rlen = _make_record(
            rng, qry_name, qry_total, qry_pos, approx,
            ref_name, ref_total, ref_pos, fwd, mapq)
        return rec, qlen, rlen

    def tiny(qry_name, qry_pos, ref_name, ref_total, ref_pos, fwd, mapq, n=1):
        # minimal record: a single ':n' match run
        return SynthRecord(
            qry_name=qry_name, qry_total=10**7,
            qry_str=qry_pos, qry_end=qry_pos + n, fwd=fwd,
            ref_name=ref_name, ref_total=ref_total,
            ref_str=ref_pos, ref_end=ref_pos + n,
            mat_num=n, aln_len=n, mapq=mapq, cs=f"cs:Z::{n}")

    mapq_pool = [0, 1, 254, 255, 256, 300, 60]

    for ci in range(n_contigs):
        qry_name = f"bctg{ci:05d}"
        motif = int(rng.integers(0, 8))
        ref_name, ref_total = ref_chrs[int(rng.integers(0, 3))]
        ref_pos = int(rng.integers(0, ref_total // 4))
        recs: list[SynthRecord] = []

        if motif == 0:
            # singleton, possibly rev, possibly minimal
            if rng.random() < 0.5:
                recs.append(tiny(qry_name, int(rng.integers(0, 3)), ref_name,
                                 ref_total, ref_pos, rng.random() < 0.5,
                                 int(rng.choice(mapq_pool))))
            else:
                r, _q, _r = mk(qry_name, 0, 200, ref_name, ref_total, ref_pos,
                               rng.random() < 0.5, int(rng.choice(mapq_pool)))
                recs.append(r)
        elif motif == 1:
            # exact duplicates (2-4 copies) — full-distance ties
            r, qlen, _ = mk(qry_name, int(rng.integers(0, 50)), 150, ref_name,
                            ref_total, ref_pos, True, int(rng.choice(mapq_pool)))
            recs.extend([r] + [dataclasses.replace(r)
                               for _ in range(int(rng.integers(1, 4)))])
        elif motif == 2:
            # chain with query gaps in {0, 1, 2} half-open (touching /
            # one-base gap) and one-base overlaps
            qry_pos = int(rng.integers(0, 10))
            for _ in range(int(rng.integers(3, 7))):
                r, qlen, rlen = mk(qry_name, qry_pos, int(rng.integers(20, 120)),
                                   ref_name, ref_total, ref_pos, True,
                                   int(rng.choice(mapq_pool)))
                recs.append(r)
                step = int(rng.choice([-1, 0, 1, 2]))  # -1 = 1-base overlap
                qry_pos += qlen + step
                ref_pos += rlen + int(rng.integers(0, 40))
        elif motif == 3:
            # containment: small record strictly inside a big one, mapped
            # elsewhere; occasionally identical query span (exact nesting)
            big, qlen, _ = mk(qry_name, 10, 400, ref_name, ref_total, ref_pos,
                              True, 60)
            inner_start = 10 + int(rng.integers(1, max(2, qlen // 3)))
            inner_len = int(rng.integers(5, max(6, qlen // 3)))
            sm = tiny(qry_name, inner_start, ref_name, ref_total,
                      ref_pos + 2_000_000, True, int(rng.choice(mapq_pool)),
                      n=inner_len)
            recs.extend([big, sm])
        elif motif == 4:
            # all-mapq-zero contig: qul fraction 0/n everywhere
            qry_pos = 0
            for _ in range(int(rng.integers(2, 6))):
                r, qlen, rlen = mk(qry_name, qry_pos, 150, ref_name, ref_total,
                                   ref_pos, rng.random() < 0.3, 0)
                recs.append(r)
                qry_pos += qlen + int(rng.integers(1, 30))
                ref_pos += rlen + int(rng.integers(0, 50))
        elif motif == 5:
            # reference gaps straddling SV_BASELINE (1e6): same-chr jumps
            # of 1e6 + {-2..2} flip the translocation casework
            qry_pos = 0
            for _ in range(int(rng.integers(2, 5))):
                r, qlen, rlen = mk(qry_name, qry_pos, 150, ref_name, ref_total,
                                   ref_pos, True, 60)
                recs.append(r)
                qry_pos += qlen + int(rng.integers(1, 30))
                ref_pos += rlen + 1_000_000 + int(rng.integers(-2, 3))
                ref_pos = min(ref_pos, ref_total - 5_000)
        elif motif == 6:
            # strand flip on the FIRST record, then alternating strands
            qry_pos = int(rng.integers(0, 5))
            fwd = False
            for _ in range(int(rng.integers(2, 6))):
                r, qlen, rlen = mk(qry_name, qry_pos, 120, ref_name, ref_total,
                                   ref_pos, fwd, int(rng.choice(mapq_pool)))
                recs.append(r)
                fwd = not fwd
                qry_pos += qlen + int(rng.integers(0, 20))
                ref_pos += rlen + int(rng.integers(0, 60))
        else:
            # mixed pile: duplicates + containment + tiny records sharing
            # one overlap cluster (stresses the O(n^2) cut machinery on
            # degenerate interval lists)
            base = int(rng.integers(0, 10))
            r, qlen, _ = mk(qry_name, base, 200, ref_name, ref_total, ref_pos,
                            True, 60)
            recs.append(r)
            for _ in range(int(rng.integers(2, 6))):
                start = base + int(rng.integers(0, max(1, qlen - 3)))
                n = int(rng.integers(1, 12))
                rp = min(ref_pos + int(rng.integers(0, 3_000_000)),
                         ref_total - n - 1)
                recs.append(tiny(qry_name, start, ref_name, ref_total,
                                 rp, rng.random() < 0.3,
                                 int(rng.choice(mapq_pool)), n=n))

        tail = max(r.qry_end for r in recs)
        qry_total = tail + int(rng.integers(1, 200))
        for r in recs:
            r.qry_total = qry_total
        lines.extend(r.to_line() for r in recs)

    return "\n".join(lines) + "\n"


def _gen_ops_realistic(rng: np.random.Generator, seg_len: int,
                       sub_rate: float, indel_rate: float):
    """cs ops for one minimap2-style alignment segment: match runs are
    geometric around 1/(sub_rate+indel_rate) (real assembly-vs-reference
    divergence), substitutions dominate, indel lengths are 1-bp-biased
    geometric (homopolymer errors) with an occasional 20-200 bp tail
    (real small SVs minimap2 keeps inside one alignment as long cs
    indels).  Returns (ops, qry, ref, mat, aln)."""
    ops = []
    qry = ref = mat = aln = 0
    event_rate = sub_rate + indel_rate
    remaining = seg_len
    while remaining > 0:
        run = int(min(remaining, 1 + rng.geometric(min(0.999, event_rate))))
        ops.append((":", ":" + str(run)))
        qry += run
        ref += run
        mat += run
        aln += run
        remaining -= run
        if remaining <= 0:
            break
        if rng.random() < sub_rate / event_rate:
            a, b = rng.integers(0, 4, size=2)
            b = (a + 1 + b % 3) % 4
            ops.append(("*", "*" + _BASES[a] + _BASES[b]))
            qry += 1
            ref += 1
            aln += 1
            remaining -= 1
        else:
            if rng.random() < 0.03:  # small-SV tail kept in-alignment
                n = int(rng.integers(20, 200))
            else:  # homopolymer-style: 1-bp dominated geometric
                n = int(min(12, rng.geometric(0.65)))
            if rng.random() < 0.55:  # insertions slightly outnumber dels
                ops.append(("+", "+" + _rand_seq(rng, n)))
                qry += n
                aln += n
            else:
                ops.append(("-", "-" + _rand_seq(rng, n)))
                ref += n
                aln += n
    if ops[-1][0] != ":":
        ops.append((":", ":5"))
        qry += 5
        ref += 5
        mat += 5
        aln += 5
    return ops, qry, ref, mat, aln


def generate_realistic_paf(
    n_contigs: int = 30,
    seed: int = 0,
    mean_segment: int = 8_000,
    sub_rate: float = 0.002,
    indel_rate: float = 0.0006,
    ref_chrs: list | None = None,
) -> str:
    """minimap2-faithful generator (round-3 verdict Next #7): stresses
    the same decision boundaries a real assembly-vs-reference PAF
    would, where ``generate_paf`` samples a *typical* but toy-scaled
    distribution.

    Modeled after real minimap2 asm5/asm10 output:

    * a multi-chromosome genome with human-like relative lengths;
    * alignment segments log-normal around ``mean_segment`` (real
      contig alignments break at SVs every few kb-Mb) with LONG cs
      strings — thousands of ops per record;
    * per-base divergence: substitutions ~0.2%, indels ~0.06% with
      1-bp-biased geometric lengths plus a 20-200 bp small-SV tail
      (paf_data.cpp:90-123 walks every one of these);
    * inter-segment SV spectrum with log-uniform sizes: deletions /
      insertions (50 bp - 100 kb coordinate gaps on one side),
      inversions (strand flip; alignasm.cpp:156-159 rev-strand swap),
      tandem duplications (a competing overlapping record at a nearby
      locus with near-identical identity — the cut-point machinery's
      real workload), and rare translocations (chromosome switch, the
      SV_TRANS_PENALTY path);
    * minimap2's bimodal mapq: mass at 60, a repeat-mapping mass at 0
      (always on duplications), thin middle.
    """
    rng = np.random.default_rng(seed)
    if ref_chrs is None:
        # human-like relative chromosome sizes (scaled down ~1000x)
        rel = [248, 242, 198, 190, 182, 171, 159, 145, 138, 134,
               135, 133, 114, 107, 102, 90, 83, 80, 59, 64, 47, 51, 156, 57]
        ref_chrs = [(f"chr{i + 1}" if i < 22
                     else ("chrX" if i == 22 else "chrY"),
                     int(r * 1_000)) for i, r in enumerate(rel)]

    def pick_mapq() -> int:
        u = rng.random()
        if u < 0.78:
            return 60
        if u < 0.90:
            return 0
        return int(rng.integers(1, 60))

    lines: list[str] = []
    for ci in range(n_contigs):
        qry_name = f"rctg{ci:05d}"
        n_seg = int(rng.integers(1, 14))
        ref_i = int(rng.integers(0, len(ref_chrs)))
        ref_name, ref_total = ref_chrs[ref_i]
        qry_pos = int(rng.integers(0, 2_000))
        ref_pos = int(rng.integers(0, max(1, ref_total - n_seg
                                          * mean_segment * 2)))
        fwd = True
        recs: list[SynthRecord] = []
        qry_total = 1  # fixed up after generation
        for si in range(n_seg):
            seg = int(np.clip(rng.lognormal(np.log(mean_segment), 0.7),
                              200, 80_000))
            ops, qlen, rlen, mat, aln = _gen_ops_realistic(
                rng, seg, sub_rate, indel_rate)
            texts = [t for _, t in ops]
            if not fwd:
                texts = texts[::-1]
            ref_pos = min(ref_pos, max(0, ref_total - rlen - 1))
            rec = SynthRecord(
                qry_name=qry_name, qry_total=qry_total,
                qry_str=qry_pos, qry_end=qry_pos + qlen, fwd=fwd,
                ref_name=ref_name, ref_total=ref_total,
                ref_str=ref_pos, ref_end=ref_pos + rlen,
                mat_num=mat, aln_len=aln, mapq=pick_mapq(),
                cs="cs:Z:" + "".join(texts),
            )
            recs.append(rec)

            # tandem duplication: a competing overlapping record at a
            # nearby locus with near-identical divergence, repeat mapq
            if rng.random() < 0.18:
                ov = int(rng.integers(50, max(51, qlen // 2)))
                dup_start = qry_pos + qlen - ov
                dlen = int(rng.integers(ov + 100, ov + seg // 2 + 200))
                dops, dq, dr, dmat, daln = _gen_ops_realistic(
                    rng, dlen, sub_rate, indel_rate)
                dtexts = [t for _, t in dops]
                dup_ref = rec.ref_str + int(
                    rng.integers(100, min(50_000, max(200, rlen))))
                dup_ref = min(dup_ref, max(0, ref_total - dr - 1))
                recs.append(SynthRecord(
                    qry_name=qry_name, qry_total=qry_total,
                    qry_str=dup_start, qry_end=dup_start + dq, fwd=True,
                    ref_name=ref_name, ref_total=ref_total,
                    ref_str=dup_ref, ref_end=dup_ref + dr,
                    mat_num=dmat, aln_len=daln, mapq=0,
                    cs="cs:Z:" + "".join(dtexts),
                ))
                qry_pos = dup_start + dq + int(rng.integers(1, 200))
                ref_pos = dup_ref + dr
            else:
                qry_pos += qlen
                ref_pos += rlen

            # inter-segment SV (log-uniform size spectrum)
            sv = rng.random()
            size = int(10 ** rng.uniform(np.log10(50), np.log10(100_000)))
            if sv < 0.40:      # deletion: reference jumps ahead
                ref_pos += size
            elif sv < 0.65:    # insertion: query advances alone
                qry_pos += size
            elif sv < 0.85:    # inversion
                fwd = not fwd
                ref_pos += int(rng.integers(0, 500))
            elif sv < 0.97:    # plain adjacency / micro-gap
                qry_pos += int(rng.integers(1, 50))
                ref_pos += int(rng.integers(0, 50))
            else:              # translocation
                ref_i = int(rng.integers(0, len(ref_chrs)))
                ref_name, ref_total = ref_chrs[ref_i]
                ref_pos = int(rng.integers(0, ref_total // 2))
                fwd = True
            ref_pos = max(0, min(ref_pos, ref_total - 1))

        tail = max(r.qry_end for r in recs)
        qry_total = tail + int(rng.integers(1, 5_000))
        for r in recs:
            r.qry_total = qry_total
        lines.extend(r.to_line() for r in recs)

    return "\n".join(lines) + "\n"


def generate_alt_paf(main_paf: str, seed: int = 0, n_groups: int = 12) -> str:
    """Generate an alternative PAF for an existing main PAF.

    Alt query names encode ``<ctg>:<offset1based>-<end>`` fragments
    (alignasm.cpp:209-233).  Some groups contain records passing the
    aln_len/qry_total > baseline threshold; others fail entirely so the
    flush-best-ratio fallback fires (alignasm.cpp:244-252).
    """
    rng = np.random.default_rng(seed + 77)
    # contig name -> qry_total from the main PAF
    totals: dict[str, int] = {}
    order: list[str] = []
    for line in main_paf.splitlines():
        f = line.split("\t")
        if f[0] not in totals:
            order.append(f[0])
        totals[f[0]] = int(f[1])

    ref_name, ref_total = "chr1", 500_000
    lines: list[str] = []
    chosen = [order[int(i)] for i in rng.choice(len(order), size=min(n_groups, len(order)), replace=False)]
    chosen.sort()  # groups arrive contig-sorted like a real pipeline
    for ctg in chosen:
        qry_total = totals[ctg]
        offset0 = int(rng.integers(0, max(1, qry_total // 2)))
        frag_len = int(rng.integers(300, 1200))
        frag_len = min(frag_len, qry_total - offset0 - 1)
        if frag_len < 50:
            continue
        name = f"{ctg}:{offset0 + 1}-{offset0 + frag_len}"
        passing_group = rng.random() < 0.6
        for _ in range(int(rng.integers(1, 4))):
            if passing_group:
                seg = int(rng.integers(frag_len // 2 + 1, frag_len))
            else:
                seg = int(rng.integers(10, max(11, frag_len // 3)))
            start = int(rng.integers(0, max(1, frag_len - seg)))
            ops, qlen, rlen, mat, aln = _gen_ops(rng, seg)
            if start + qlen > frag_len:
                continue
            ref_pos = int(rng.integers(0, ref_total // 2))
            rec = SynthRecord(
                qry_name=name, qry_total=frag_len,
                qry_str=start, qry_end=start + qlen, fwd=True,
                ref_name=ref_name, ref_total=ref_total,
                ref_str=ref_pos, ref_end=ref_pos + rlen,
                mat_num=mat, aln_len=aln,
                mapq=int(rng.choice([0, 60])),
                cs="cs:Z:" + "".join(t for _, t in ops),
            )
            lines.append(rec.to_line())
    return "\n".join(lines) + "\n" if lines else ""


def write_paf(path: str, **kwargs) -> None:
    with open(path, "w") as fh:
        fh.write(generate_paf(**kwargs))


# ---------------------------------------------------------------------------
# Named evaluation configs (BASELINE.json `configs`).  Real genomes are not
# fetchable in this environment, so each config is a parameterized synthetic
# with the same shape characteristics: contig counts, record densities, SV
# richness, and coordinate scales.
# ---------------------------------------------------------------------------

def config_synth50() -> str:
    """configs[0]: synthetic 50-contig PAF, exact CPU-runnable oracle."""
    return generate_paf(n_contigs=50, seed=7)


def _rename(part: str, prefix: str) -> list[str]:
    out = []
    for line in part.splitlines():
        f = line.split("\t")
        f[0] = prefix + f[0]
        out.append("\t".join(f))
    return out


def config_ecoli() -> str:
    """configs[1]: ~100 contigs against a single 4.6 Mb reference —
    minimap2-faithful divergence/SV spectrum on one chromosome
    (round-4 realism pass: generate_realistic_paf)."""
    return generate_realistic_paf(
        n_contigs=100, seed=101, mean_segment=3_000,
        ref_chrs=[("U00096.3", 4_600_000)])


def config_yeast() -> str:
    """configs[2]: 16-chromosome genome — realistic contigs (true yeast
    chromosome proportions) blended with ambiguous/duplicate hard
    contigs that drive the alt-path and .all tie outputs."""
    sizes = [230, 813, 316, 1532, 577, 270, 1091, 562,
             440, 746, 667, 1078, 924, 784, 1091, 948]  # kb, sacCer3
    chrs = [(f"chr{i + 1:02d}", kb * 1_000) for i, kb in enumerate(sizes)]
    real = generate_realistic_paf(n_contigs=40, seed=202,
                                  mean_segment=4_000, ref_chrs=chrs)
    hard = generate_hard_paf(n_contigs=24, seed=203, mean_segment=500)
    return "\n".join(_rename(real, "y_") + _rename(hard, "yh_")) + "\n"


def config_chr20() -> str:
    """configs[3]: SV-rich single-chromosome cancer assembly —
    realistic long-segment contigs on one 64 Mb chromosome (heavy
    inversion/duplication spectrum) plus hard contigs with deep
    k-shortest alternatives."""
    real = generate_realistic_paf(
        n_contigs=60, seed=303, mean_segment=6_000,
        ref_chrs=[("chr20", 64_000_000)])
    parts = [generate_hard_paf(n_contigs=40, seed=s, mean_segment=350)
             for s in (304, 305)]
    out = _rename(real, "c20_")
    for i, part in enumerate(parts):
        out += _rename(part, f"c20h{i}_")
    return "\n".join(out) + "\n"


def config_karyotype(n_contigs: int = 10_000) -> str:
    """configs[4]: full-karyotype scale (~10k contigs)."""
    blocks = []
    per = 1000
    for b in range(n_contigs // per):
        chunk = generate_paf(n_contigs=per, seed=1000 + b,
                             max_records_per_contig=24)
        for line in chunk.splitlines():
            f = line.split("\t")
            f[0] = f"b{b}_{f[0]}"
            blocks.append("\t".join(f))
    return "\n".join(blocks) + "\n"


EVAL_CONFIGS = {
    "synth50": config_synth50,
    "ecoli": config_ecoli,
    "yeast": config_yeast,
    "chr20": config_chr20,
}


def _chain_contig(n_segments: int, seed: int = 5) -> str:
    """One long contig ("bigctg") of ``n_segments`` chained alignments,
    about a third with an overlapping duplicate beside them (copy of
    ``tests/test_scale.py:_chain_contig``): the repo's big-contig case."""
    rng = np.random.default_rng(seed)
    lines = []
    qry_pos, ref_pos = 10, 1000
    for _ in range(n_segments):
        rec, qlen, rlen = _make_record(
            rng, "bigctg", 10**9, qry_pos, int(rng.integers(150, 400)),
            "chr1", 3 * 10**8, ref_pos, True, 60,
        )
        lines.append(rec.to_line())
        if rng.random() < 0.3:
            ov = int(rng.integers(5, max(6, qlen // 2)))
            dup, dq, dr = _make_record(
                rng, "bigctg", 10**9, qry_pos + qlen - ov,
                int(rng.integers(ov + 20, ov + 300)),
                "chr1", 3 * 10**8, ref_pos + int(rng.integers(2000, 8000)),
                True, 60,
            )
            lines.append(dup.to_line())
            qry_pos += qlen + dq - ov + int(rng.integers(1, 50))
            ref_pos += rlen + dr
        else:
            qry_pos += qlen + int(rng.integers(1, 50))
            ref_pos += rlen + int(rng.integers(0, 100))
    total = qry_pos + 1000
    fixed = []
    for line in lines:
        f = line.split("\t")
        f[1] = str(total)
        fixed.append("\t".join(f))
    return "\n".join(fixed) + "\n"
