"""The port's copy of ``testing/realism_stats.py``
(``alignasm_tpu_torch/testing/realism_stats.py``): a mirror of
tests/test_realism_stats.py on the copy (the generator's statistics stay
inside the literature envelope, the gate detects drift, every bound has
its anchor), and the copy's statistics equal the original's on the same
corpus.  tests/test_torch_python_plane.py holds the copy's text to the
original's.
"""

from alignasm_tpu.testing import realism_stats as jrealism
from alignasm_tpu_torch.testing.realism_stats import (
    ENVELOPE, check_envelope, measure_realism_stats,
)
from alignasm_tpu_torch.testing.synth import generate_realistic_paf


def test_generator_in_envelope():
    stats = measure_realism_stats(
        generate_realistic_paf(n_contigs=300, seed=4242))
    assert check_envelope(stats) == [], stats


def test_envelope_stable_across_seeds():
    """The in-envelope property is a distributional fact, not a lucky
    seed: three disjoint seeds at moderate scale."""
    for seed in (1, 77, 20260820):
        stats = measure_realism_stats(
            generate_realistic_paf(n_contigs=150, seed=seed))
        bad = check_envelope(stats)
        assert bad == [], (seed, bad)


def test_envelope_detects_drift():
    """A generator whose divergence knob drifts 10x must violate:
    otherwise the gate is decoration."""
    stats = measure_realism_stats(
        generate_realistic_paf(n_contigs=60, seed=3, sub_rate=0.02))
    bad = check_envelope(stats)
    assert any("sub_per_base" in v for v in bad), bad


def test_envelope_has_anchors():
    """Every bound carries its literature anchor and an honest
    lit/design classification."""
    for key, (lo, hi, kind, anchor) in ENVELOPE.items():
        assert lo < hi
        assert kind in ("lit", "design"), key
        assert len(anchor) > 10, key


def test_copy_measures_as_the_original():
    text = generate_realistic_paf(n_contigs=80, seed=11)
    stats = measure_realism_stats(text)
    assert stats == jrealism.measure_realism_stats(text)
    assert check_envelope(stats) == jrealism.check_envelope(stats)
    assert ENVELOPE == jrealism.ENVELOPE
