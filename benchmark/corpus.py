"""The benchmark's corpus generator: PAF text from a traffic file, the
configuration's reference genome and a seed.

The shapes are those of ``alignasm_tpu_torch/testing/synth.py``
(``generate_paf``, ``config_karyotype``, ``_chain_contig``): the same
record counts per contig, events (inversions 12 %, translocations 8 %,
gaps), overlapping competitors (35 % of records; 30 % on chains), mapq
mix and cs operations (match runs of 1-499 bases, each followed by a
substitution 50 %, an insertion or a deletion of 1-7 bases 25 % each).
The widths are a genome's, where synth's are a toy's: the contigs align
to the configuration's reference chromosomes at their published lengths,
records are as long as the traffic says (``mean_segment``, chosen so the
contigs add up to the genome), and the reference gap at an alignment
break is a structural variant's, log-uniform over ``sv_gap`` bases (the
deletion spectrum of ``synth.py:generate_realistic_paf``).

A record's cs string is put together from pieces drawn from a pool made
from the seed (one piece a match run and the event after it, or sixteen
such pairs), so a genome's worth of alignments takes seconds.
``benchmark/tests/test_bench_corpus.py`` holds the result to synth's
statistics.

A traffic file (``benchmark/traffic/<name>.json``) names a ``family``:

* ``assembly``: the configuration's ``contigs`` contigs of 1 to
  ``max_records_per_contig`` records, each on a chromosome drawn by length,
  with segments of about ``mean_segment`` bases (``generate_paf``'s
  contigs);
* ``chains``: one chain contig per entry of ``segments`` (``_chain_contig``),
  named ``chain<k>``, spanning ``span_share`` of the chromosome named by
  the same entry of the configuration's ``chromosomes``.

A traffic may also carry an ``alt`` block: then ``generate_alt`` makes the
alt PAF (``-a``) of the main corpus, in the shape of synth's
``generate_alt_paf`` at the genome's widths.  Groups of re-aligned contig
fragments, query names ``<ctg>:<start + 1>-<end>``, come out contig-sorted:

* ``contig_share`` of the contigs get ``groups`` [lo, hi] groups each, of
  ``records_per_group`` [lo, hi] records;
* a group's fragment is log-uniform over ``fragment`` [lo, hi] bases, and
  lies in the contig's unaligned query span past its last record (reaching
  back into the records where that span is too short for the groups);
* ``pass_share`` of the groups have only records whose ``aln_len /
  qry_total`` exceeds the configuration's ``alt_baseline``, so every one
  joins its contig; the others only records with a positive ratio at or
  below it, so the merge appends the best of them;
* ``near_share`` of the records align on the chromosome and strand of the
  contig's last record, a log-uniform ``sv_gap`` past its reference end,
  where they can join a path; the rest on a chromosome drawn by length.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.config import DEFAULT_CONFIG

_BASES = np.frombuffer(b"acgt", np.uint8)
_RUN_HI = 500          # match runs of 1 to _RUN_HI - 1 bases
_BIG = 16              # pairs in a big piece
_POOL = 4096           # pieces of each size in the pool


class _Draws:
    """Uniform draws in blocks: ``u()`` a float in [0, 1), ``int(lo, hi)``
    an integer in [lo, hi), ``log(lo, hi)`` a log-uniform integer."""

    def __init__(self, seed, block: int = 1 << 16):
        self._rng = np.random.default_rng(seed)
        self._block = block
        self._u = self._rng.random(block).tolist()
        self._k = 0

    def u(self) -> float:
        if self._k == len(self._u):
            self._u = self._rng.random(self._block).tolist()
            self._k = 0
        x = self._u[self._k]
        self._k += 1
        return x

    def int(self, lo: int, hi: int) -> int:
        return lo + int(self.u() * (hi - lo))

    def log(self, lo: int, hi: int) -> int:
        return int(lo * math.exp(self.u() * math.log(hi / lo)))


class _Pieces:
    """The cs pool of one corpus: pieces of one (match run, event) pair and
    of ``_BIG`` pairs, each with its (query, reference, match, alignment)
    lengths, and a stream of draws of them (from ``draws``, else from the
    pool's own ``rng``)."""

    def __init__(self, rng: np.random.Generator,
                 draws: np.random.Generator | None = None):
        self._rng = rng if draws is None else draws
        n = _POOL * (1 + _BIG)
        runs = rng.integers(1, _RUN_HI, n)
        kind = rng.random(n)
        sub = kind < 0.5
        ins = (kind >= 0.5) & (kind < 0.75)
        ev = rng.integers(1, 8, n)
        a = rng.integers(0, 4, n)
        b = (a + 1 + rng.integers(0, 3, n)) % 4
        seq = _BASES[rng.integers(0, 4, 8 * n)].tobytes().decode()
        pairs = []
        for k in range(n):
            if sub[k]:
                e = "*" + "acgt"[a[k]] + "acgt"[b[k]]
            else:
                e = ("+" if ins[k] else "-") + seq[8 * k:8 * k + ev[k]]
            pairs.append(":" + str(runs[k]) + e)
        ev = np.where(sub, 1, ev)
        lens = np.stack([runs + np.where(sub | ins, ev, 0),
                         runs + np.where(sub | ~ins, ev, 0),
                         runs, runs + ev], 1).astype(np.int64)
        self.small, self.small_len = pairs[:_POOL], lens[:_POOL]
        big = lens[_POOL:].reshape(_POOL, _BIG, 4).sum(1)
        self.big = ["".join(pairs[_POOL + _BIG * k:_POOL + _BIG * (k + 1)])
                    for k in range(_POOL)]
        self.big_len = big
        self.big_aln = float(big[:, 3].mean())
        self._fill()

    def _fill(self):
        self._si = self._rng.integers(0, _POOL, 1 << 18)
        self._sc = np.concatenate([[0], np.cumsum(self.small_len[self._si, 3])])
        self._bi = self._rng.integers(0, _POOL, 1 << 16)
        self._sp = self._bp = 0

    def record(self, aln: int):
        """(cs ops text, query, reference, match, alignment lengths) of a
        record of exactly ``aln`` alignment columns, ending in a match run."""
        n_big = max(0, int((aln - 1500) / self.big_aln))
        if self._bp + n_big > len(self._bi) or \
                self._sp + aln >= len(self._si):
            self._fill()
        bi = self._bi[self._bp:self._bp + n_big]
        self._bp += n_big
        lens = self.big_len[bi].sum(0)
        while n_big and lens[3] >= aln:  # rare: the big pieces ran long
            n_big -= 1
            lens = lens - self.big_len[bi[n_big]]
            bi = bi[:n_big]
        rest = aln - int(lens[3])
        base = self._sc[self._sp]
        k = int(np.searchsorted(self._sc, base + rest - 1, side="right")) \
            - 1 - self._sp
        si = self._si[self._sp:self._sp + k]
        self._sp += k
        lens = lens + self.small_len[si].sum(0)
        tail = aln - int(lens[3])
        text = "".join([self.big[i] for i in bi.tolist()]
                       + [self.small[i] for i in si.tolist()]
                       + [":" + str(tail)])
        q, r, m, a = (int(x) for x in lens)
        return text, q + tail, r + tail, m + tail, a + tail


def _record(p: _Pieces, out, qry_name, qry_pos, approx, ref_name, ref_total,
            ref_pos, fwd, mapq):
    """Append one record as [fields without qry_total] to ``out``; returns
    (query bases, reference bases)."""
    ops, qlen, rlen, mat, aln = p.record(max(1, approx))
    out.append([qry_name, str(qry_pos), str(qry_pos + qlen),
                "+" if fwd else "-", ref_name, str(ref_total), str(ref_pos),
                str(ref_pos + rlen), str(mat), str(aln), str(mapq), "tp:A:P",
                "cs:Z:" + ops])
    return qlen, rlen


def _line(rec, qry_total: int) -> str:
    return "\t".join([rec[0], str(qry_total)] + rec[1:])


def _mapq(d: _Draws, values, cum) -> int:
    x = d.u()
    for v, c in zip(values, cum):
        if x < c:
            return v
    return values[-1]


def _by_length(d: _Draws, chrs, cum):
    x = d.u() * cum[-1]
    return chrs[int(np.searchsorted(cum, x, side="right"))]


def _assembly(d: _Draws, s: _Draws, p: _Pieces, chrs, n_contigs: int,
              tr: dict, lines: list) -> None:
    """``n_contigs`` of ``generate_paf``'s contigs on the genome ``chrs``;
    ``s`` draws the shape (records a contig, events, competitors), ``d``
    the rest."""
    cum = np.cumsum([n for _c, n in chrs]).astype(np.float64)
    mean = int(tr["mean_segment"])
    gap_lo, gap_hi = tr["sv_gap"]
    max_rec = int(tr["max_records_per_contig"])
    for ci in range(n_contigs):
        name = f"ctg{ci:05d}"
        n_rec = s.int(1, max_rec + 1)
        qry_total = n_rec * mean * 2 + d.int(500, 3000)
        qry_pos = d.int(0, 200)
        ref_name, ref_total = _by_length(d, chrs, cum)
        ref_pos = d.int(0, ref_total // 2)
        fwd = True
        recs = []
        for _ in range(n_rec):
            approx = d.int(mean // 2, mean * 2)
            mapq = _mapq(d, (0, 1, 20, 60), (0.1, 0.2, 0.4, 1.0))
            event = s.u()
            if event < 0.12:  # inversion
                fwd = not fwd
                ref_pos += d.int(0, 50)
            elif event < 0.2:  # translocation
                ref_name, ref_total = _by_length(d, chrs, cum)
                ref_pos = d.int(0, ref_total // 2)
                fwd = True
            else:  # a structural variant's gap on the reference
                ref_pos += d.log(gap_lo, gap_hi)
            qlen, rlen = _record(p, recs, name, qry_pos, approx, ref_name,
                                 ref_total, ref_pos, fwd, mapq)
            if n_rec > 1 and s.u() < 0.35:  # an overlapping competitor
                ov = d.int(5, max(6, qlen // 2))
                dup_start = qry_pos + qlen - ov
                dup_ref = ref_pos + d.int(0, 3000)
                dq, dr = _record(p, recs, name, dup_start,
                                 d.int(ov + 20, ov + mean), ref_name,
                                 ref_total, dup_ref, fwd,
                                 _mapq(d, (0, 30, 60), (1 / 3, 2 / 3, 1.0)))
                qry_pos = dup_start + dq + d.int(1, 60)
                ref_pos = dup_ref + dr + d.int(0, 80)
            else:
                qry_pos += qlen + d.int(1, 80)
                ref_pos += rlen
        tail = max(int(r[2]) for r in recs)
        qry_total = max(qry_total, tail + d.int(1, 500))
        lines.extend(_line(r, qry_total) for r in recs)


def _chain(d: _Draws, s: _Draws, p: _Pieces, name: str, n_segments: int,
           chrom, tr: dict, lines: list) -> None:
    """One chain contig (``_chain_contig``) over ``span_share`` of the
    chromosome ``chrom``; ``s`` draws which segments have a competitor,
    ``d`` the rest."""
    ref_name, ref_total = chrom
    gap_lo, gap_hi = tr["sv_gap"]
    mean_gap = (gap_hi - gap_lo) / math.log(gap_hi / gap_lo)
    # a segment advances the chain on the reference by its own length and
    # either a gap (70 %) or its competitor's length (30 %, about 3/4 of a
    # segment): 1.225 segments and 0.7 gaps in all
    seg = max(1000, int((tr["span_share"] * ref_total / n_segments
                         - 0.7 * mean_gap) / 1.225))
    lo, hi = int(seg * 0.55), int(seg * 1.45)
    recs = []
    qry_pos, ref_pos = 10, 1000
    for _ in range(n_segments):
        qlen, rlen = _record(p, recs, name, qry_pos, d.int(lo, hi), ref_name,
                             ref_total, ref_pos, True, 60)
        if s.u() < 0.3:
            ov = d.int(5, max(6, qlen // 2))
            dq, dr = _record(p, recs, name, qry_pos + qlen - ov,
                             d.int(ov + 20, ov + seg), ref_name, ref_total,
                             ref_pos + d.int(2000, 8000), True, 60)
            qry_pos += qlen + dq - ov + d.int(1, 50)
            ref_pos += rlen + dr
        else:
            qry_pos += qlen + d.int(1, 50)
            ref_pos += rlen + d.log(gap_lo, gap_hi)
    lines.extend(_line(r, qry_pos + 1000) for r in recs)


def generate(traffic: dict, seed: int, deployment: dict) -> str:
    """The corpus of ``traffic`` for ``seed`` in the configuration
    ``deployment`` (its ``reference_genome``, and its ``contigs`` or
    ``chromosomes``; a traffic's own ``contigs`` cuts the count), as PAF
    text.  The shape (records a contig, events, competitors) comes from the
    traffic's own ``shape_seed``, so every seed gives the same sizes;
    positions, lengths and cs strings come from ``seed``."""
    chrs = [(str(c), int(n))
            for c, n in deployment["reference_genome"]["chromosomes"]]
    shape = traffic["shape_seed"]
    pieces = _Pieces(np.random.default_rng([seed, 0xC5]))
    lines: list = []
    if traffic["family"] == "assembly":
        _assembly(_Draws([seed, 0]), _Draws([shape, 0]), pieces, chrs,
                  int(traffic.get("contigs", deployment["contigs"])),
                  traffic, lines)
    elif traffic["family"] == "chains":
        named = dict(chrs)
        for k, (n, c) in enumerate(zip(traffic["segments"],
                                       deployment["chromosomes"])):
            _chain(_Draws([seed, k]), _Draws([shape, k]), pieces,
                   f"chain{k}", n, (c, named[c]), traffic, lines)
    else:
        raise ValueError(f"unknown traffic family {traffic['family']!r}")
    return "\n".join(lines) + "\n"


def _last_records(text: str) -> list:
    """Per contig of the main PAF, in file order: (name, query length as
    its last record gives it, the fields of the record whose query end is
    largest)."""
    out = []
    for line in text.splitlines():
        f = line.split("\t")
        if not out or out[-1][0] != f[0]:
            out.append([f[0], 0, f])
        last = out[-1]
        last[1] = int(f[1])
        if int(f[3]) > int(last[2][3]):
            last[2] = f
    return out


def _share(rng: np.random.Generator, n: int, share: float) -> list:
    """``n`` flags, ``round(share * n)`` of them set, in a random order."""
    flags = [k < round(share * n) for k in range(n)]
    rng.shuffle(flags)
    return flags


def _alt_plan(shape: int, n_contigs: int, alt: dict) -> list:
    """Which contigs get groups, and each group's (passes, near flag a
    record), from the traffic's shape seed alone."""
    rng = np.random.default_rng([shape, 0xA1])
    chosen = sorted(rng.choice(n_contigs, round(alt["contig_share"]
                                                * n_contigs), replace=False))
    g_lo, g_hi = alt["groups"]
    r_lo, r_hi = alt["records_per_group"]
    sizes = [[int(r) for r in rng.integers(r_lo, r_hi + 1,
                                           int(rng.integers(g_lo, g_hi + 1)))]
             for _ in chosen]
    passes = iter(_share(rng, sum(map(len, sizes)), alt["pass_share"]))
    near = iter(_share(rng, sum(map(sum, sizes)), alt["near_share"]))
    return [(int(ci), [(next(passes), [next(near) for _ in range(n)])
                       for n in groups])
            for ci, groups in zip(chosen, sizes)]


def _ratio_bounds(frag: int, baseline: float) -> tuple[int, int]:
    """The largest alignment length whose ratio to ``frag`` is at most
    ``baseline``, and the least whose ratio exceeds it (as the merge
    divides)."""
    low = int(baseline * frag)
    while low > 0 and low / frag > baseline:
        low -= 1
    while (low + 1) / frag <= baseline:
        low += 1
    return low, low + 1


def generate_alt(traffic: dict, seed: int, deployment: dict,
                 main_text: str) -> str:
    """The alt PAF of ``traffic``'s ``alt`` block (see the module's
    docstring) for the main corpus ``main_text`` of the same traffic, seed
    and configuration.  Which contigs get groups, how many groups and
    records, which groups pass and which records lie near come from the
    traffic's ``shape_seed``; fragments, positions, lengths and cs strings
    from ``seed``."""
    alt = traffic["alt"]
    baseline = float(deployment.get("settings", {}).get(
        "alt_baseline", DEFAULT_CONFIG.alt_baseline))
    f_lo, f_hi = alt["fragment"]
    chrs = [(str(c), int(n))
            for c, n in deployment["reference_genome"]["chromosomes"]]
    cum = np.cumsum([n for _c, n in chrs]).astype(np.float64)
    gap_lo, gap_hi = traffic["sv_gap"]
    contigs = _last_records(main_text)
    d = _Draws([seed, 0xA2])
    # the main corpus's pool of pieces, drawn from in a stream of its own
    pieces = _Pieces(np.random.default_rng([seed, 0xC5]),
                     np.random.default_rng([seed, 0xA3]))
    lines: list = []
    for ci, groups in _alt_plan(traffic["shape_seed"], len(contigs), alt):
        name, qry_total, last = contigs[ci]
        g = len(groups)
        # a slot of at least f_lo bases a group, in the unaligned tail
        lo = max(0, min(int(last[3]), qry_total - g * f_lo))
        slot = (qry_total - lo) // g
        for k, (passes, near) in enumerate(groups):
            off = lo + k * slot + d.int(0, slot // 2 + 1)
            frag = min(d.log(f_lo, f_hi), qry_total - off)
            at_most, above = _ratio_bounds(frag, baseline)
            if at_most < 1 or above > frag:
                raise ValueError(f"{name}: a fragment of {frag} bases holds "
                                 f"no record on both sides of {baseline}")
            qry_name = f"{name}:{off + 1}-{off + frag}"
            for is_near in near:
                aln = d.int(above, frag + 1) if passes \
                    else d.int(max(1, at_most // 4), at_most + 1)
                ref_name, ref_total = last[5], int(last[6])
                fwd = last[4] == "+"
                gap = d.log(gap_lo, gap_hi)
                ref_pos = int(last[8]) + gap if fwd \
                    else int(last[7]) - gap - aln
                if not is_near or not 0 <= ref_pos <= ref_total - aln:
                    ref_name, ref_total = _by_length(d, chrs, cum)
                    fwd = d.u() < 0.5
                    ref_pos = d.int(0, ref_total - aln)
                recs: list = []
                _record(pieces, recs, qry_name, d.int(0, frag - aln + 1), aln,
                        ref_name, ref_total, ref_pos, fwd,
                        _mapq(d, (0, 1, 20, 60), (0.1, 0.2, 0.4, 1.0)))
                lines.append(_line(recs[0], frag))
    return "\n".join(lines) + "\n" if lines else ""
