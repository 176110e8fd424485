"""libstdc++-exact std::sort replication.

The reference sorts contig records with ``std::sort`` keyed on
``(qry_str, qry_end)`` (paf_data.cpp:241, paf_data.hpp:69-73).  For
ranges longer than 16 this is introsort, which is *unstable*: records
with identical keys (exact duplicate alignments) land in an order
determined by the partition mechanics.  Every downstream tie-break
(vertex numbering, edge order, walk enumeration) inherits that order,
so byte-identical output requires replicating the exact element
movement of libstdc++'s (GCC 12) __introsort_loop + final insertion
sort, including median-of-three pivot selection and the heapsort
depth-limit fallback.
"""

from __future__ import annotations

_THRESHOLD = 16


def _lg(n: int) -> int:
    return n.bit_length() - 1


def libstdcxx_sort(a: list, lt) -> None:
    """In-place sort of ``a`` with strict-weak ``lt``, byte-exact in
    element movement to GCC 12 ``std::sort``."""
    n = len(a)
    if n == 0:
        return
    _introsort_loop(a, 0, n, 2 * _lg(n), lt)
    _final_insertion_sort(a, 0, n, lt)


def _introsort_loop(a, first, last, depth_limit, lt):
    while last - first > _THRESHOLD:
        if depth_limit == 0:
            _heap_sort(a, first, last, lt)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, lt)
        _introsort_loop(a, cut, last, depth_limit, lt)
        last = cut


def _move_median_to_first(a, result, x, y, z, lt):
    if lt(a[x], a[y]):
        if lt(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif lt(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif lt(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif lt(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a, first, last, pivot, lt):
    while True:
        while lt(a[first], a[pivot]):
            first += 1
        last -= 1
        while lt(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, lt):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, lt)
    return _unguarded_partition(a, first + 1, last, first, lt)


def _final_insertion_sort(a, first, last, lt):
    if last - first > _THRESHOLD:
        _insertion_sort(a, first, first + _THRESHOLD, lt)
        _unguarded_insertion_sort(a, first + _THRESHOLD, last, lt)
    else:
        _insertion_sort(a, first, last, lt)


def _insertion_sort(a, first, last, lt):
    if first == last:
        return
    for i in range(first + 1, last):
        if lt(a[i], a[first]):
            val = a[i]
            a[first + 1:i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, lt)


def _unguarded_insertion_sort(a, first, last, lt):
    for i in range(first, last):
        _unguarded_linear_insert(a, i, lt)


def _unguarded_linear_insert(a, last, lt):
    val = a[last]
    nxt = last - 1
    while lt(val, a[nxt]):
        a[last] = a[nxt]
        last = nxt
        nxt -= 1
    a[last] = val


# --- heapsort fallback (__partial_sort over the whole range) -----------

def _heap_sort(a, first, last, lt):
    _make_heap(a, first, last, lt)
    for cur in range(last, first + 1, -1):
        # __pop_heap(first, cur-1, cur-1): move max to cur-1
        value = a[cur - 1]
        a[cur - 1] = a[first]
        _adjust_heap(a, first, 0, cur - 1 - first, value, lt)


def _make_heap(a, first, last, lt):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, lt)
        if parent == 0:
            return
        parent -= 1


def _adjust_heap(a, first, hole, length, value, lt):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if lt(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if length & 1 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    # __push_heap back up
    parent = (hole - 1) // 2
    while hole > top and lt(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value
