"""Frozen copy of ``alignasm_tpu_torch/model/distance.py`` for the benchmark's plain
reference; only its imports point into ``benchmark.reference``.

The PafDistance scoring semiring.

Parity target: src/paf_data.hpp:115-189.

A distance is a 5-tuple ``(qry_score, ref_score, anom, qul_nonzero,
qul_total)`` of ints.  Two comparison modes exist:

  * CALC_SUM  — compare ``qry+ref`` sum, then ``anom``, then the mapq
    fraction ``qul_nonzero/qul_total`` (larger fraction = smaller
    distance), compared by cross-multiplication (paf_data.hpp:146-158).
  * QRY_SCORE — compare ``qry`` then ``ref`` lexicographically, then the
    same ``anom``/fraction tail (paf_data.hpp:149-151).

The reference selects the mode through a thread_local static; here the
mode is an explicit argument — pure functions, no hidden state.  Sort
*keys* (tuples safe for heapq) encode exactly ``operator<`` of the
chosen mode; the fraction tail is a normalized ``Fraction`` so rational
comparison is exact.
"""

from __future__ import annotations

from fractions import Fraction

# modes
CALC_SUM = 0
QRY_SCORE = 1

# dist tuple layout
Q, R, A, NZ, TOT = range(5)

IDENTITY = (0, 0, 0, 0, 0)
# PafDistance::max() sentinel (paf_data.hpp:136-138)
MAX_DIST = (-1, -1, -1, -1, 0)

_INF = float("inf")


def is_max(d) -> bool:
    return d is MAX_DIST or d == MAX_DIST


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2], a[3] + b[3], a[4] + b[4])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2], a[3] - b[3], a[4] - b[4])


def _qul_key(d) -> Fraction:
    """Descending mapq fraction as an ascending sort key."""
    return Fraction(-d[NZ], d[TOT] if d[TOT] else 1)


def key(d, mode: int):
    """Total-order sort key equivalent to PafDistance::operator< in ``mode``.

    MAX sorts after everything (reference: ``*this == max()`` is never
    less; anything else is less than max).
    """
    if is_max(d):
        return (_INF, 0, 0, 0)
    if mode == CALC_SUM:
        return (d[Q] + d[R], d[A], _qul_key(d), 0)
    return (d[Q], d[R], d[A], _qul_key(d))


def less(a, b, mode: int) -> bool:
    return key(a, mode) < key(b, mode)


def eq(a, b) -> bool:
    """PafDistance::operator== — componentwise, fraction cross-multiplied
    (paf_data.hpp:163-168).  Mode-independent."""
    ta = a[TOT] if a[TOT] else 1
    tb = b[TOT] if b[TOT] else 1
    return (
        a[Q] == b[Q]
        and a[R] == b[R]
        and a[A] == b[A]
        and a[NZ] * tb == b[NZ] * ta
    )


def score_sum(d) -> int:
    return d[Q] + d[R]


def eq_sum_anom(a, b) -> bool:
    """is_equal_paf_distance (paf_data.cpp:1581-1583)."""
    return score_sum(a) == score_sum(b) and a[A] == b[A]
