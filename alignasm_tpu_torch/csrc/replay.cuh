// The checked history-replay pass's row: the distance part of the int64
// relaxation, shared by csrc/relax64.cu (each contig of a Python-plane
// int64 bucket, with its floor and counts) and csrc/shard_relax.cu (the
// graph axis's one contig, the distance alone).
//
// Both compute n_sweeps Jacobi sweeps of the same recurrence: per vertex
// the lexicographic distance to dest over (k1, k2, erank), k1 = sum << 16 |
// anom, k2 = QUL_ONE - (nz << 30) // tot (the mapq mediant, floor
// division, not monotone), erank the first-improvement tie-break, a vertex
// keeping its incumbent unless a candidate is strictly better.  They differ
// only in the winner a better row takes (the Rule below): relax64.cu the
// lowest edge index among the reached edges whose erank is m3
// (ops/relax.py), shard_relax.cu the minimum of each payload field over the
// edges whose whole key ties (parallel/mesh.py's rounds), taken only below
// INF.
//
// Why one pass is exact.  Write the update as u(t) = F(u(t-1), S(t-1)), S
// the states of u's successors.  The minima (m1, m2, m3) and the winner
// depend on S alone and a row takes the winner only when it is better, so
// F(F(x, S), S) = F(x, S): a second evaluation under the same S finds the
// winner not better or takes the same payload again.  So u can change at
// sweep t only when t = 1 or a successor changed at sweep t-1.  In reverse
// topological order each vertex's change history (sweep, s, a, nz, tot)
// therefore follows from its successors' histories alone: the row
// evaluates F at sweep 1 and at each sweep after a successor's change, up
// to the limit, reading each successor's latest state before that sweep,
// and appends an entry when its (s, a, nz, tot) changes (its own rank stays
// in registers).  That is exact at any n_sweeps, ties and the non-monotone
// mediant included.  Before the first sweep after some successor is
// reached every candidate is INF and F keeps the initial state, so the row
// starts there (a chain's row then evaluates once).  A vertex with a
// longest path of L(u) edges changes at sweep L(u) at the latest, so no
// change comes after sweep V.
//
// The fold.  A row folds its edges in one pass into the literal m1, m2
// over the m1-achievers and m3 over the m2-achievers (Fold; the mapq key, a
// 64-bit division, only where a comparison needs its value), each seeded
// with segment_min's identity (INF when an invalid edge leaves the vertex,
// else INT64_MAX), and keeps every sum, shift and pack on uint64_t (the
// JAX and PyTorch int64 arithmetic wraps, signed overflow in C++ does
// not).  Each edge keeps a cursor into its head's history across the
// row's evaluations.  A row runs on a group of G lanes: the warp (its
// lanes over the row's edges, the fold on the shuffled candidates) or, for
// a row of at most one edge, G = 1 in every lane alike, the leader alone
// writing.  The history is a list per vertex in a pool with one cursor; an
// entry past the pool's capacity is dropped and the cursor past it tells
// the caller that the pass failed.
//
// I is the type of CSR and pool indices: int32_t in relax64.cu (V <= 8192,
// shared memory), int64_t in shard_relax.cu (V < 2^31, device memory).
// L places a pool entry's fields: an array a field in relax64.cu's shared
// memory (SoA), one 64-byte record an entry in shard_relax.cu's device
// memory (AoS<8>), so that the walk down a successor's list and its state
// read one cache line an entry.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace replay {

constexpr int64_t kInf = int64_t(1) << 62;  // ops/relax.py INF
constexpr int64_t kSegMax = INT64_MAX;      // segment_min of no element
constexpr int kAnomBits = 16;
constexpr int kQulBits = 30;
constexpr int64_t kQulOne = int64_t(1) << kQulBits;
constexpr int32_t kNoTime = 0x7fffffff;  // no further change
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t add64(int64_t x, int64_t y) {
  return (int64_t)((uint64_t)x + (uint64_t)y);
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ int64_t pack_k1(int64_t s, int64_t a) {
  return (int64_t)(((uint64_t)s << kAnomBits) | (uint64_t)a);
}

// Floor division, as torch.div(rounding_mode="floor") and jnp's //.  Both
// operands below 2^52 are exact in double, and the correctly rounded
// quotient is then within 1/2 of x / y: one correction step gives the floor.
__device__ __forceinline__ int64_t floor_div(int64_t x, int64_t y) {
  constexpr int64_t kExact = int64_t(1) << 52;
  if (x >= 0 && x < kExact && y > 0 && y < kExact) {
    const int64_t q = (int64_t)((double)x / (double)y);
    const int64_t r = x - q * y;
    return r < 0 ? q - 1 : (r >= y ? q + 1 : q);
  }
  if (y == -1) return (int64_t)(0 - (uint64_t)x);
  const int64_t q = x / y;
  return (x % y != 0 && ((x < 0) != (y < 0))) ? q - 1 : q;
}

// _qul_key: QUL_ONE - (nz << 30) // tot, tot == 0 taken as 1.
__device__ __forceinline__ int64_t qul_key(int64_t nz, int64_t tot) {
  const int64_t num = (int64_t)((uint64_t)nz << kQulBits);
  return (int64_t)((uint64_t)kQulOne -
                   (uint64_t)floor_div(num, tot == 0 ? 1 : tot));
}

// A mapq key below INF without dividing: nz in [0, 2^33) and tot > 0 make
// nz << 30 a non-negative int64, so the key is at most QUL_ONE.
__device__ __forceinline__ bool key_below_inf(int64_t nz, int64_t tot) {
  return nz >= 0 && nz < (int64_t(1) << 33) && tot > 0;
}

// The visible state of a vertex: what its predecessors' candidates read.
struct St {
  int64_t s, a, nz, tot;
};

__device__ __forceinline__ St init_state(int32_t v, int32_t dest) {
  return St{v == dest ? 0 : kInf, 0, 0, 0};
}

__device__ __forceinline__ bool differs(const St& x, const St& y) {
  return x.s != y.s || x.a != y.a || x.nz != y.nz || x.tot != y.tot;
}

// The literal minima of one sweep at a row, in one pass over its edges in
// any order: m1 over every edge (INF for an unreached one), m2 over the
// m1-achievers, m3 over the m2-achievers, each a segment min that every
// other edge of the row feeds INF, seeded with the identity (INF when an
// invalid edge leaves the vertex, else INT64_MAX).  x1: an edge off m1;
// a1 / b1: the least k2 among the m1-achievers and the least erank among
// those at a1; y1: an m1-achiever above a1.  a1 is kept as its (nz, tot)
// and divided out only when a comparison needs its value (a second
// m1-achiever, or a tie with the incumbent's k1): a row that improves
// k1 never divides.
struct Fold {
  int64_t ident, m1, a1, anz, atot, b1;
  bool aval, seen, x1, any1, y1;

  __device__ explicit Fold(int64_t id)
      : ident(id), m1(id), a1(kSegMax), anz(0), atot(0), b1(kSegMax),
        aval(true), seen(false), x1(false), any1(false), y1(false) {}

  __device__ __forceinline__ int64_t a1_value() {
    if (!aval) {
      a1 = qul_key(anz, atot);
      aval = true;
    }
    return a1;
  }

  __device__ __forceinline__ void take(int64_t nz, int64_t tot, int64_t r) {
    anz = nz;
    atot = tot;
    aval = false;
    b1 = r;
  }

  __device__ __forceinline__ void push(bool ok, int64_t k1, int64_t nz,
                                       int64_t tot, int64_t r) {
    const int64_t c1 = ok ? k1 : kInf;
    if (c1 < m1) {  // the edges before are off m1 now
      x1 = seen || !ok;
      m1 = c1;
      any1 = ok;
      y1 = false;
      if (ok) {
        take(nz, tot, r);
      } else {
        a1 = b1 = kSegMax;
        aval = true;
      }
    } else if (c1 == m1 && ok) {
      if (!any1) {
        any1 = true;
        take(nz, tot, r);
      } else {
        const int64_t k2 = qul_key(nz, tot), a = a1_value();
        if (k2 < a) {
          y1 = true;
          take(nz, tot, r);
          a1 = k2;
          aval = true;
        } else if (k2 == a) {
          b1 = min64(b1, r);
        } else {
          y1 = true;
        }
      }
    } else {
      x1 = true;
    }
    seen = true;
  }

  // m1 and m3; m2 comes from m2_value(), only when needed.
  __device__ __forceinline__ void mins(int64_t& o1, int64_t& o3) {
    if (!seen) {
      o1 = o3 = ident;
      return;
    }
    o1 = m1;
    if (any1 && a1_is_m2())
      o3 = min64(min64(ident, x1 || y1 ? kInf : kSegMax), b1);
    else
      o3 = min64(ident, kInf);
  }

  __device__ __forceinline__ int64_t floor2() const {
    return min64(ident, x1 ? kInf : kSegMax);
  }

  // a1 == m2 (any1): a1 below INF is below floor2, which is at least INF.
  __device__ __forceinline__ bool a1_is_m2() {
    if (!aval && key_below_inf(anz, atot)) return true;
    return a1_value() <= floor2();
  }

  __device__ __forceinline__ int64_t m2_value() {
    if (!seen) return ident;
    return min64(floor2(), any1 ? a1_value() : kSegMax);
  }
};

template <int G>
__device__ __forceinline__ int64_t group_min(int64_t x) {
  if constexpr (G > 1)
    for (int o = 16; o; o >>= 1) x = min64(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <int G>
__device__ __forceinline__ int64_t group_sum(int64_t x) {
  if constexpr (G > 1)
    for (int o = 16; o; o >>= 1) x = add64(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <int G>
__device__ __forceinline__ int32_t group_min32(int32_t x) {
  if constexpr (G > 1) x = __reduce_min_sync(kFull, x);
  return x;
}

// Where a pool entry's fields lie, as strides in their own units: one
// array a field, or records of W int64 words (s, a, nz, tot, next, then
// the sweep as an int32; I = int64_t).
struct SoA {
  static constexpr int k64 = 1, k32 = 1, kI = 1;
};
template <int W>
struct AoS {
  static constexpr int k64 = W, k32 = 2 * W, kI = W;
};

// What a row reads and writes: the contig's CSR of valid edges by tail
// (each edge's head and fields in CSR order), the
// per-vertex invalid-edge flag, and the history: the pool (`cap` entries:
// s, a, nz, tot, the sweep of the change and the next entry of the same
// vertex), each vertex's first entry (`head`, -1: none) and, per edge, the
// head's latest entry at the row's last evaluation (`cp`, -1: its initial
// state) and whether that state is reached (`cok`).
template <typename I, typename L = SoA>
struct Hist {
  const int32_t *ev, *ea, *enz, *etot, *inv;
  const int64_t *es, *erank;
  I *cp, *hnext, *head;
  int32_t *cok, *htime;
  int64_t *hs, *ha, *hnz, *htot;  // entry p's fields at [p * L::k64] ...
  I* cursor;  // the pool's next entry (the leader's)
  I cap;
  int32_t dest, limit;  // limit: the last sweep evaluated

  __device__ __forceinline__ int64_t& s(I p) const { return hs[p * L::k64]; }
  __device__ __forceinline__ int64_t& a(I p) const { return ha[p * L::k64]; }
  __device__ __forceinline__ int64_t& nz(I p) const {
    return hnz[p * L::k64];
  }
  __device__ __forceinline__ int64_t& tot(I p) const {
    return htot[p * L::k64];
  }
  __device__ __forceinline__ int32_t& time(I p) const {
    return htime[p * L::k32];
  }
  __device__ __forceinline__ I& next(I p) const { return hnext[p * L::kI]; }
};

// Vertex v's state at pool entry p (-1: its initial state).
template <typename I, typename L>
__device__ __forceinline__ St state_of(const Hist<I, L>& h, int32_t v, I p) {
  if (p < 0) return init_state(v, h.dest);
  return St{h.s(p), h.a(p), h.nz(p), h.tot(p)};
}

// The candidate of the edge at CSR slot k through a head in state v.
template <typename I, typename L>
__device__ __forceinline__ St cand_of(const Hist<I, L>& h, I k,
                                      const St& v) {
  return St{add64(v.s, h.es[k]), add64(v.a, h.ea[k]), add64(v.nz, h.enz[k]),
            add64(v.tot, h.etot[k])};
}

// The candidate of the edge at CSR slot k at the row's last evaluation.
template <typename I, typename L>
__device__ __forceinline__ St cached_cand(const Hist<I, L>& h, I k) {
  return cand_of(h, k, state_of(h, h.ev[k], h.cp[k]));
}

// Appends u's entry of sweep t (the leader alone); an entry past the pool
// is dropped, and the cursor past the capacity fails the pass.
template <typename I, typename L>
__device__ __forceinline__ void append(const Hist<I, L>& h, int32_t u,
                                       int32_t t, const St& x, I& tail) {
  const I i = (*h.cursor)++;
  if (i >= h.cap) return;
  h.s(i) = x.s;
  h.a(i) = x.a;
  h.nz(i) = x.nz;
  h.tot(i) = x.tot;
  h.time(i) = t;
  h.next(i) = -1;
  if (tail < 0)
    h.head[u] = i;
  else
    h.next(tail) = i;
  tail = i;
}

// Row u's distance history (its edges at CSR slots lo .. lo + n - 1), by a
// group of G lanes (lane: the thread's lane in it, 0 for G = 1).  `rule`
// is the caller's part of the row:
//   rule.edge(k, v): each edge (CSR slot k, head v) once, before the
//     evaluations (relax64.cu folds the floor and the walk count there);
//   rule.template pick<G>(h, lo, n, lane, f, m1, m3, one, one_ok, nx, nr):
//     after a better evaluation, the new state nx and rank nr, or false
//     for no update; `one`, `one_ok`: a G = 1 row's last candidate and
//     whether its head was reached.
// Returns the row's final state; `rank` its rank, `tail` its last entry.
// The cache of a lane's edge in the row's first G (every edge of a row of
// at most G) stays in a register between evaluations; cp is still written
// for the rule's pick.
template <int G, typename I, typename L, typename Rule>
__device__ __forceinline__ St replay_row(const Hist<I, L>& h, int32_t u,
                                         I lo, I n, int lane, bool leader,
                                         Rule& rule, int64_t& rank, I& tail) {
  St x = init_state(u, h.dest);
  rank = u == h.dest ? -1 : kInf;  // x's rank
  tail = -1;
  const int64_t ident = h.inv[u] ? kInf : kSegMax;
  // Before the first sweep after a successor is reached every candidate is
  // INF and the row keeps its initial state: start there.
  int32_t t0 = kNoTime;
  for (I j = lane; j < n; j += G) {
    const I k = lo + j;
    const int32_t v = h.ev[k];
    I q = init_state(v, h.dest).s < kInf ? -2 : h.head[v];
    while (q >= 0 && h.s(q) >= kInf) q = h.next(q);
    if (q != -1) t0 = min(t0, q == -2 ? 1 : h.time(q) + 1);
    h.cp[k] = -1;
    rule.edge(k, v);
  }
  St one{};  // a one-edge row's candidate at its last evaluation (G = 1)
  bool one_ok = false;
  I p0 = -1;  // the cache of the lane's edge in the first G
  for (int32_t t = group_min32<G>(t0); t <= h.limit;) {
    Fold f(ident);
    int32_t nxt = kNoTime;
    for (I j0 = 0; j0 < n; j0 += G) {
      const I j = j0 + lane;
      bool ok = false;
      int64_t k1 = 0, nz = 0, tot = 0, r = 0;
      if (j < n) {  // the head's latest entry before sweep t, from the cache
        const I k = lo + j;
        const int32_t v = h.ev[k];
        I p = j0 == 0 ? p0 : h.cp[k];
        I q = p < 0 ? h.head[v] : h.next(p);
        while (q >= 0 && h.time(q) < t) {
          p = q;
          q = h.next(q);
        }
        nxt = min(nxt, q >= 0 ? h.time(q) + 1 : kNoTime);
        const St sv = state_of(h, v, p), cd = cand_of(h, k, sv);
        ok = sv.s < kInf;
        one = cd;
        one_ok = ok;
        k1 = pack_k1(cd.s, cd.a);
        nz = cd.nz;
        tot = cd.tot;
        r = h.erank[k];
        h.cp[k] = p;
        h.cok[k] = ok;
        if (j0 == 0) p0 = p;
      }
      if constexpr (G == 1) {
        f.push(ok, k1, nz, tot, r);
      } else {
        const int m = (int)(n - j0 < G ? n - j0 : G);
        for (int k = 0; k < m; ++k)
          f.push(__shfl_sync(kFull, (int)ok, k) != 0,
                 __shfl_sync(kFull, k1, k), __shfl_sync(kFull, nz, k),
                 __shfl_sync(kFull, tot, k), __shfl_sync(kFull, r, k));
      }
    }
    nxt = group_min32<G>(nxt);
    int64_t m1, m3;
    f.mins(m1, m3);
    const int64_t cur1 = x.s < kInf ? pack_k1(x.s, x.a) : kInf;
    bool better = m1 < cur1;
    if (m1 == cur1) {  // ties on k1: the mapq keys decide
      const int64_t m2 = f.m2_value(), k2x = qul_key(x.nz, x.tot);
      better = m2 < k2x || (m2 == k2x && m3 < rank);
    }
    if (better) {
      if constexpr (G > 1) __syncwarp();  // the lanes' cache entries
      St nx;
      int64_t nr;
      if (rule.template pick<G>(h, lo, n, lane, f, m1, m3, one, one_ok, nx,
                                nr)) {
        if (leader && differs(nx, x)) append(h, u, t, nx, tail);
        x = nx;
        rank = nr;
      }
      if constexpr (G > 1) __syncwarp();  // read before the next fold writes
    }
    t = nxt;
  }
  return x;
}

}  // namespace replay
