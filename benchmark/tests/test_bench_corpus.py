"""The generator copy against synth's statistics, at a small size, and its
widths against the configuration's genome."""

import hashlib
import re
import statistics

import pytest

from alignasm_tpu_torch.testing.realism_stats import measure_realism_stats
from alignasm_tpu_torch.testing.synth import _chain_contig, generate_paf
from benchmark import run
from benchmark.corpus import generate, generate_alt
from benchmark.reference.config import DEFAULT_CONFIG
from benchmark.tests._small import ALT, alt_traffic, config, small_traffic

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


# sha256 of each cell's corpus at _small.py's sizes and seed 2**31 + 5, as
# the generator made them before it had the alt block
PINNED = {
    "karyotype-small":
        "0013d93ddc9cfd239415a35c25706791df79d4c424b77e51343e53d0e1ee6190",
    "chromscale-chains":
        "139b490f803db645fbd56654c8ff010ea7d37969eb35caae9c3a06c60246aefa",
}


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_a_cell_corpus_is_pinned(workload):
    text = generate(small_traffic(workload), 2**31 + 5, config(workload))
    assert hashlib.sha256(text.encode()).hexdigest() == PINNED[workload]


def _alt_groups(workload, seed):
    """The main corpus's contigs {name: (order, query length)} and the alt
    PAF's groups [(contig, offset, fragment, records as field lists)]."""
    tr, cfg = alt_traffic(workload), config(workload)
    main = generate(tr, seed, cfg)
    contigs = {}
    for line in main.splitlines():
        f = line.split("\t")
        contigs[f[0]] = (contigs.get(f[0], (len(contigs),))[0], int(f[1]))
    groups = []
    for line in generate_alt(tr, seed, cfg, main).splitlines():
        f = line.split("\t")
        if not groups or groups[-1][4] != f[0]:
            ctg, span = f[0].split(":")
            start, end = (int(x) for x in span.split("-"))
            groups.append((ctg, start - 1, end - start + 1, [], f[0]))
        groups[-1][3].append(f)
    return contigs, groups


def test_the_alt_generator_has_its_shape():
    """Contig-sorted groups inside their contigs, each with a record of a
    positive ratio, ``pass_share`` of them passing, and the same counts for
    every seed."""
    baseline = DEFAULT_CONFIG.alt_baseline
    genome = dict(config("karyotype-small")["reference_genome"]
                  ["chromosomes"])
    shapes = []
    for seed in (2**31 + 5, 17):
        contigs, groups = _alt_groups("karyotype-small", seed)
        order = [contigs[g[0]][0] for g in groups]
        assert order == sorted(order)
        assert len(set(order)) == round(ALT["contig_share"] * len(contigs))
        passing = 0
        for ctg, off, frag, recs, _name in groups:
            assert 0 <= off and off + frag <= contigs[ctg][1]
            ratios = [int(f[10]) / int(f[1]) for f in recs]
            assert max(ratios) > 0
            passing += max(ratios) > baseline
            for f in recs:
                assert int(f[1]) == frag
                assert 0 <= int(f[2]) < int(f[3]) <= frag
                assert int(f[6]) == genome[f[5]]
                assert 0 <= int(f[7]) < int(f[8]) <= genome[f[5]]
        assert passing / len(groups) == pytest.approx(ALT["pass_share"],
                                                      abs=0.15)
        shapes.append([(g[0], len(g[3])) for g in groups])
    assert shapes[0] and shapes[0] == shapes[1]


def test_some_alt_records_lie_near_their_contig():
    """``near_share`` of the records follow the contig's last record on its
    chromosome and strand, within ``sv_gap`` past its reference end."""
    tr, cfg = alt_traffic("karyotype-small"), config("karyotype-small")
    main = generate(tr, 3, cfg)
    last = {}
    for line in main.splitlines():
        f = line.split("\t")
        if f[0] not in last or int(f[3]) > int(last[f[0]][3]):
            last[f[0]] = f
    gap_lo, gap_hi = tr["sv_gap"]
    near = total = 0
    for line in generate_alt(tr, 3, cfg, main).splitlines():
        f = line.split("\t")
        m = last[f[0].split(":")[0]]
        total += 1
        if f[5] == m[5] and f[4] == m[4]:
            gap = int(f[7]) - int(m[8]) if f[4] == "+" \
                else int(m[7]) - int(f[8])
            near += gap_lo <= gap <= gap_hi
    assert near / total == pytest.approx(ALT["near_share"], abs=0.1)
