"""libstdc++-exact binary-heap replica of the reference's PQVec.

Parity target: /root/reference/src/priority_queue_vector.hpp — a
``std::priority_queue`` subclass whose RAW heap array (``getVector``)
is iterated directly by the single-piece upgrade's candidate loops
(paf_data.cpp:966, 1123, 1352).  The candidate chosen on equal scores
is the FIRST in that array, so byte-identity requires reproducing the
exact array layout libstdc++'s heap algorithms produce — the same kind
of replication engine/introsort.py does for std::sort.

The reference instantiates ``PQVec<pair<i64,i64>, vector, greater<>>``
(a min-heap on (qry_end, sorted_idx)) and uses only push (emplace),
pop, top, empty.  libstdc++ internals replicated here:

  * push_heap  -> __push_heap: sift the hole up while comp(parent, v)
    (bits/stl_heap.h:__push_heap);
  * pop_heap   -> move back value to a hole at the top, then
    __adjust_heap: sift the hole DOWN TO A LEAF (always taking the
    larger-by-comp child), then __push_heap back up — which yields a
    different array layout than the textbook sift-down
    (bits/stl_heap.h:__adjust_heap).

``comp(a, b)`` is the heap's strict-weak order parameter; for
``greater<>`` it is ``a > b``.
"""

from __future__ import annotations


class PQVec:
    """Min-heap on tuples via std::greater<> semantics, libstdc++ layout."""

    def __init__(self):
        self.c: list = []

    # comp = std::greater<>{}: comp(a, b) == a > b
    @staticmethod
    def _comp(a, b) -> bool:
        return a > b

    def empty(self) -> bool:
        return not self.c

    def top(self):
        return self.c[0]

    def _push_heap(self, hole: int, top: int, value) -> None:
        c = self.c
        parent = (hole - 1) // 2
        while hole > top and self._comp(c[parent], value):
            c[hole] = c[parent]
            hole = parent
            parent = (hole - 1) // 2
        c[hole] = value

    def push(self, value) -> None:
        self.c.append(value)
        self._push_heap(len(self.c) - 1, 0, value)

    def _adjust_heap(self, hole: int, length: int, value) -> None:
        c = self.c
        top = hole
        second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if self._comp(c[second], c[second - 1]):
                second -= 1
            c[hole] = c[second]
            hole = second
        if (length & 1) == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            c[hole] = c[second - 1]
            hole = second - 1
        self._push_heap(hole, top, value)

    def pop(self) -> None:
        c = self.c
        if len(c) > 1:
            value = c[-1]
            c[-1] = c[0]
            c.pop()
            self._adjust_heap(0, len(c), value)
        else:
            c.pop()

    def vector(self):
        """The raw heap array (PQVec::getVector)."""
        return self.c

    def sorted_vector(self):
        """Priority-queue order copy (PQVec::getSortedVector):
        sort_heap under greater<> (descending) then reverse — i.e.
        ascending; elements are distinct pairs so plain sort matches."""
        return sorted(self.c)
