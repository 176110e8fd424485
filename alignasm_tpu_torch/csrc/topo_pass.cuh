// The checked reverse-topological pass of the Python plane's two solve
// kernels, csrc/sweep_dense.cu and csrc/relax32.cu, around the shared step
// of topo_step.cuh.
//
// Both kernels compute _solve_one's four Jacobi loops (alignasm_tpu/ops/
// dense.py:581, and ops/relax32.py:37 on edge lists), each n_sweeps sweeps.
// The host passes a hint, order[t] = the vertex at topological position t
// (pos[order[t]] = t), and the kernel takes one pass over the rows, t = V-1
// down to 0, applying the sweeps' own update forms to the successors' final
// values, only when it can show per contig that the pass equals the
// n_sweeps Jacobi result:
//   (a) the hint is a permutation of 0..V-1 and every edge (u, v) has
//       pos[v] > pos[u], or v == dest while dest's own row holds no edge
//       (then dest's four values are their anchors at every sweep);
//   (b) the longest path L, in edges (L[u] = max over edges of L[v] + 1, 0
//       with no edge), is at most n_sweeps;
//   (c) every edge packs into a cell of [0, INF32): score in [0, 2^28),
//       anomaly in [0, 3].  Then no int32 sum the sweeps form can wrap: d_s
//       stays in [0, INF32] (a row takes a new sum only below INF32), so
//       ws + d_s < 2^28 + 2^30 + 1; d_a is an anomaly sum along a path of
//       fewer than V <= 8192 edges, below 2^15; floor_a stays in [0, INF32]
//       and ws + floor_a <= INF32 + 3; the counts are at most COUNT_SAT
//       each, a row's sum below 8192 * 10001 < 2^27.
// Why that suffices: without a wrap every update is monotone in the
// successors' values (a lexicographic minimum, a minimum, a saturated sum of
// non-negative terms) and the sweeps' values only fall (s, a, fa) or rise
// (the counts) from the initial vectors.  By induction on L(u), after any k
// >= L(u) sweeps the values at u are the update applied to its successors'
// final values: a vertex without edges keeps its initial values, and a
// candidate of an earlier sweep is never better than the last one.  Under
// (b) every vertex is final after n_sweeps, and under (a) the pass visits
// every successor of u before u.  The count of min walks reads the final
// (s, a) of loop 1 in both forms.  Under (a), when dest's row holds an edge
// no successor of dest reaches dest (every edge climbs in pos, and none may
// enter dest from above), so the update leaves dest's anchors; the pass
// keeps them.
//
// The row's update is topo::topo_step with no seed (or chained seeds over
// the row's chunks) and these edits: d_s, d_a = better ? (m1, m2) : init
// (the step's `reach` for init (INF32, 0)); floor_a clamped at INF32 per
// row (the sweep's min with its INF32 initial value; the step's own fa is
// not clamped); the counts saturated at COUNT_SAT; the count of min walks
// over the sweep's literal `ach`.  Columns that are not final for a row
// (pos not above it) are masked to INF32 after the checks read them.
//
// A contig that fails a check is flagged (flags[b] = 1, and counted in the
// caller's `jacobi` word when one is given) and the kernel's Jacobi branch,
// the four literal loops, solves it in the launch that follows the pass.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "topo_step.cuh"

namespace topo {

constexpr int32_t kCountSat = 10001;
constexpr int32_t kBad = -1;  // an edge cell that violates (c)

// The packed cell of an edge (ws, wa) of the batch or edge-list entries:
// INF32 for no edge, kBad where (c) fails.
__device__ __forceinline__ int32_t pack_edge(bool edge, int32_t ws,
                                             int32_t wa) {
  if (!edge) return kInf;
  return (uint32_t)ws <= (uint32_t)kScoreMask && (uint32_t)wa <= 3u
             ? ws | (wa << kAnomShift)
             : kBad;
}

// A slab cell: INF32 is no edge; any other value is an edge whose packed
// form must lie in [0, INF32).
__device__ __forceinline__ int32_t check_cell(int32_t x) {
  return x == kInf || (x >= 0 && x < kInf) ? x : kBad;
}

// An edge cell's term of the row's longest path: L + 1 into a final column,
// kBadLen where (a) or (c) fails (above any limit: a path has < V edges).
constexpr int32_t kBadLen = 0x7fffffff;
// The dest rule of (a) as a position: when dest's row holds no edge, the
// callers give dest's column this position, above every row's.
constexpr int32_t kAlwaysReady = 0x7fffffff;
__device__ __forceinline__ int32_t path_term(int32_t cell, bool ready,
                                             int32_t len) {
  if (cell == kInf) return 0;
  return cell < 0 || !ready ? kBadLen : len + 1;
}

// A row's values over the columns stepped so far, as the seed of its next
// chunk (the step's own fold: mins, saturated sums).
__device__ __forceinline__ Seed seed_of(const Row& r) {
  return Seed{r.s, r.a, r.cm, kNone, r.fa, r.ct};
}

// Per-vertex vectors of the pass in a workspace (shared or global memory):
// pos, L and the five values, each V words.
struct Work {
  int32_t *pos, *len, *s, *a, *fa, *ct, *cm;
};

__device__ __forceinline__ Work work_at(int32_t* base, int32_t V) {
  return Work{base, base + V, base + 2 * V, base + 3 * V, base + 4 * V,
              base + 5 * V, base + 6 * V};
}

// Fill pos from the hint (identity when order is null), by `n` threads from
// thread `tid`.  Returns false in a thread that saw the hint fail to be a
// permutation of 0..V-1 (pos must hold -1 everywhere before).
__device__ __forceinline__ bool fill_pos(int32_t* pos,
                                         const int32_t* __restrict__ order,
                                         int32_t V, int tid, int n) {
  bool ok = true;
  for (int32_t t = tid; t < V; t += n) {
    const int32_t v = order ? order[t] : t;
    if (v < 0 || v >= V || atomicExch(&pos[v], t) != -1) ok = false;
  }
  return ok;
}

// The five values and L with their initial values, by `n` threads from
// thread `tid`.
__device__ __forceinline__ void init_work(const Work& w, int32_t V,
                                          int32_t dest, int tid, int n) {
  for (int32_t v = tid; v < V; v += n) {
    const bool d = v == dest;
    w.len[v] = 0;
    w.s[v] = d ? 0 : kInf;
    w.a[v] = 0;
    w.fa[v] = d ? 0 : kInf;
    w.ct[v] = d ? 1 : 0;
    w.cm[v] = w.ct[v];
  }
}

// One chunk of a row at position t: lane slot k holds column col[k] (-1
// for none) and its cell; a column is final when its pos (kAlwaysReady for
// dest under the dest rule) is above t.  Gathers the columns' state from
// the workspace,
// folds their path terms into `len`, masks the columns that are not final
// and steps, seeded with the row's earlier chunks.
template <int NC>
__device__ __forceinline__ Row work_step(const Work& w,
                                         const int32_t (&col)[NC],
                                         const int32_t (&cell)[NC], int32_t t,
                                         const Seed& seed, int32_t& len) {
  Cols<NC> c;
  int32_t m[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int32_t v = col[k];
    const bool has = v >= 0;
    c.s[k] = has ? w.s[v] : kInf;
    c.a[k] = has ? w.a[v] : 0;
    c.fa[k] = has ? w.fa[v] : kInf;
    c.ct[k] = has ? w.ct[v] : 0;
    c.cm[k] = has ? w.cm[v] : 0;
    c.nxt[k] = -1;
    const bool ready = has && w.pos[v] > t;
    len = max(len, path_term(cell[k], ready, has ? w.len[v] : 0));
    m[k] = ready && cell[k] >= 0 ? cell[k] : kInf;
  }
  return topo_step<NC, kCountSat>(m, c, 0, seed);
}

// Lane 0 flags contig b for the Jacobi branch: flags[b] = 1, and counts it
// in *jacobi unless that is null.
__device__ __forceinline__ void to_jacobi(int32_t* flags, int32_t* jacobi,
                                          int64_t b) {
  if (lane_id() == 0) {
    flags[b] = 1;
    if (jacobi) atomicAdd(jacobi, 1);
  }
}

// Lane 0 stores row u's final values (dest keeps its anchors) and L.
__device__ __forceinline__ void store_row(const Work& w, int32_t u,
                                          int32_t dest, const Row& r,
                                          int32_t len) {
  if ((threadIdx.x & 31) != 0) return;
  if (u != dest) {
    w.s[u] = r.s;
    w.a[u] = r.a;
    w.fa[u] = min(r.fa, kInf);
    w.ct[u] = r.ct;
    w.cm[u] = r.cm;
  }
  w.len[u] = len;
}

}  // namespace topo
