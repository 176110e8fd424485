"""The generator copy against synth's statistics, at a small size, and its
widths against the configuration's genome."""

import re
import statistics

import pytest

from alignasm_tpu_torch.testing.realism_stats import measure_realism_stats
from alignasm_tpu_torch.testing.synth import _chain_contig, generate_paf
from benchmark import run
from benchmark.corpus import generate

KARYOTYPE = run.load_cell("karyotype-small")["config"]
CHAINS = run.load_cell("chromscale-chains")["config"]
# records of 15-60 kb, where synth's match runs are seldom cut short by the
# record's end (its last ~500 bases hold ~6 events where elsewhere ~2 do)
ASSEMBLY = dict(family="assembly", contigs=200, max_records_per_contig=24,
                mean_segment=30000, sv_gap=[50, 100_000], shape_seed=7)
# (statistic, relative tolerance): both generators draw the same
# distributions, 200 contigs each.  Not compared: mean_chrs_per_contig,
# which the genome's 24 chromosomes raise over synth's four
STATS = [("sub_per_base", 0.1), ("indel_to_sub_ratio", 0.1),
         ("frac_1bp_indels", 0.15), ("ins_to_del_ratio", 0.15),
         ("mapq60_mass", 0.1), ("mapq0_mass", 0.2),
         ("median_segment_len", 0.1), ("rev_strand_frac", 0.25)]


def _records_per_contig(text):
    counts = {}
    for line in text.splitlines():
        name = line.split("\t", 1)[0]
        counts[name] = counts.get(name, 0) + 1
    return statistics.mean(counts.values())


@pytest.fixture(scope="module")
def both_stats():
    return (measure_realism_stats(generate(ASSEMBLY, 11, KARYOTYPE)),
            measure_realism_stats(generate_paf(
                n_contigs=200, seed=11, max_records_per_contig=24,
                mean_segment=ASSEMBLY["mean_segment"])))


@pytest.mark.parametrize("stat,tol", STATS)
def test_assembly_statistics_match_synth(stat, tol, both_stats):
    ours, theirs = both_stats
    assert ours[stat] == pytest.approx(theirs[stat], rel=tol)


def test_records_per_contig_match_synth():
    ours = _records_per_contig(generate(
        dict(ASSEMBLY, max_records_per_contig=180), 5, KARYOTYPE))
    theirs = _records_per_contig(generate_paf(
        n_contigs=400, seed=5, max_records_per_contig=180))
    assert ours == pytest.approx(theirs, rel=0.1)


def test_chain_records_match_synth():
    ours = generate(dict(family="chains", segments=[1200], span_share=0.05,
                         sv_gap=[50, 100_000], shape_seed=3), 8, CHAINS)
    theirs = _chain_contig(1200, seed=8)
    assert ours.count("\n") == pytest.approx(theirs.count("\n"), rel=0.05)


def test_a_seed_gives_one_corpus_and_every_seed_the_same_sizes():
    a, b, c = (generate(dict(ASSEMBLY, contigs=50), s, KARYOTYPE)
               for s in (1, 1, 2**31 + 9))
    assert a == b and a != c
    sizes = [[ln.split("\t", 1)[0] for ln in t.splitlines()] for t in (a, c)]
    assert sizes[0] == sizes[1]


@pytest.mark.parametrize("workload", ["karyotype-small", "chromscale-chains"])
def test_a_cell_has_the_genome_widths(workload):
    """At a cell's own traffic: the contigs add up to the genome (assembly)
    or span 90 % of their chromosomes (chains), every record lies on its
    chromosome at its published length, and the cs strings say what the
    coordinates do."""
    spec = run.load_cell(workload)
    tr, cfg = spec["traffic"], spec["config"]
    if tr["family"] == "assembly":
        tr = dict(tr, contigs=cfg["contigs"] // 10)
    text = generate(tr, 2**31 + 99, cfg)
    genome = dict(cfg["reference_genome"]["chromosomes"])
    total, seen, ends = 0, set(), {}
    for line in text.splitlines():
        f = line.split("\t")
        assert int(f[6]) == genome[f[5]]
        assert 0 <= int(f[7]) < int(f[8]) <= genome[f[5]]
        ops = re.findall(r":(\d+)|\*[a-z]{2}|\+([a-z]+)|-([a-z]+)", f[-1][5:])
        qry = sum(int(m) if m else 1 if not (i or d) else len(i)
                  for m, i, d in ops)
        assert qry == int(f[3]) - int(f[2])
        if f[0] not in seen:
            seen.add(f[0])
            total += int(f[1])
        ends[f[0]] = max(ends.get(f[0], 0), int(f[8]))
    if tr["family"] == "assembly":
        assert total * 10 == pytest.approx(sum(genome.values()), rel=0.1)
    else:
        for k, c in enumerate(cfg["chromosomes"]):
            assert ends[f"chain{k}"] == pytest.approx(
                tr["span_share"] * genome[c], rel=0.1)
