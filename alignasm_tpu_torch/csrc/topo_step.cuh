// The reverse-topological step shared by the two DP kernels of the native
// plane, csrc/topo_scan.cu (V <= 256) and csrc/blocked_dp.cu (V > 256).
//
// One warp computes one row u of _topo_scan (alignasm_tpu/ops/dense.py:
// 134-164) over a run of columns whose DP state is final.  The state sits in
// the lanes' registers: lane l holds columns first + l + 32 k in slot k of a
// Cols<NC>, so NC = V/32 (scan) or Bk/32 (blocked) columns a lane.  A step
// produces, for row u,
//   s, a    the lexicographic minimum of (ws + s[c], wa + a[c]) over edges,
//   fa      min (wa + fa[c]) over edges (the anomaly floor),
//   ct, cm  the walk count and the count of min walks, saturated at SAT
//           (COUNT_SAT = 10001 for the scan, 2 for the blocked rows),
//   nxt     the lowest achieving column (-1 if none),
// in the three rounds of the scan (m1; m2 over the score-achieving edges;
// cm and nxt over the achieving ones, literally _topo_scan's `ach`; fa and
// ct beside round 1).
// Each round is one warp reduction instruction (redux.sync, compute
// capability 8.0 and up) after a min or sum over the lane's own columns:
// no __syncthreads, no shared-memory round trip and no divergent branch
// per step.
//
// A seed carries the row's values over columns outside the run (the blocked
// solve's tail fold): the lexicographic minimum over tail edges to reachable
// columns with its cm sum and lowest column, and the tail's fa minimum and
// ct sum.  The scan passes no_seed().
//
// int32 literalness, as both kernels document: ws + s with s = INF32 stays
// below 2^31 (ws < 2^28), fa may exceed INF32 by an unreachable suffix's
// anomaly sum, a row with no edge gets fa = INF32, an edge into a reachable
// column with ws + s == INF32 exactly and wa + a == 0 achieves an
// unreachable row (cm and nxt count it), and count sums stay far below 2^31
// before saturation.  Every packed cell lies in [0, 2^30], so >>
// is exact.  The caller guards dest's row (it keeps its anchors) and passes
// the cells a row may use, INF32 elsewhere.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topo {

constexpr int32_t kInf = 1 << 30;
constexpr int kAnomShift = 28;
constexpr int32_t kScoreMask = (1 << kAnomShift) - 1;
constexpr int32_t kNone = 0x7fffffff;  // min identity: no edge, no column
constexpr unsigned kFull = 0xffffffffu;

// Final DP state of the columns one lane holds (slot k: column
// first + lane + 32 k), and their nxt.
template <int NC>
struct Cols {
  int32_t s[NC], a[NC], fa[NC], ct[NC], cm[NC], nxt[NC];
};

// A row's values over columns outside the warp's run.
struct Seed {
  int32_t s, a, cm, low, fa, ct;
};

__device__ __forceinline__ Seed no_seed() {
  return Seed{kInf, kInf, 0, kNone, kNone, 0};
}

struct Row {
  int32_t s, a, fa, ct, cm, nxt;
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// min / sum of a lane's N values as a balanced tree (log2 N deep).
template <int N>
__device__ __forceinline__ int32_t tree_min(const int32_t (&x)[N]) {
  int32_t y[N];
#pragma unroll
  for (int k = 0; k < N; ++k) y[k] = x[k];
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < N; k += 2 * w) y[k] = min(y[k], y[k + w]);
  }
  return y[0];
}

template <int N>
__device__ __forceinline__ int32_t tree_sum(const int32_t (&x)[N]) {
  int32_t y[N];
#pragma unroll
  for (int k = 0; k < N; ++k) y[k] = x[k];
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < N; k += 2 * w) y[k] += y[k + w];
  }
  return y[0];
}

// The scan's initial state: dest's column holds the DP anchors (s = a =
// fa = 0, ct = cm = 1); every other column is unreachable until its step.
template <int NC>
__device__ __forceinline__ void init_cols(Cols<NC>& c, int32_t first,
                                          int32_t dest) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool d = first + lane_id() + 32 * k == dest;
    c.s[k] = d ? 0 : kInf;
    c.a[k] = 0;
    c.fa[k] = d ? 0 : kInf;
    c.ct[k] = d ? 1 : 0;
    c.cm[k] = c.ct[k];
    c.nxt[k] = -1;
  }
}

// One row's step.  cell[k] is the row's cell in the lane's column k
// (INF32 where there is no edge or the column may not be used).  All 32
// lanes must call it.
template <int NC, int32_t SAT>
__device__ __forceinline__ Row topo_step(const int32_t (&cell)[NC],
                                         const Cols<NC>& c, int32_t first,
                                         const Seed& seed) {
  // round 1: m1 = min (ws + s); beside it fa and ct
  int32_t cs[NC], wa[NC], x1[NC], x2[NC], x3[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool e = cell[k] != kInf;
    wa[k] = cell[k] >> kAnomShift;
    cs[k] = e ? (cell[k] & kScoreMask) + c.s[k] : kInf;
    x2[k] = e ? wa[k] + c.fa[k] : kNone;
    x3[k] = e ? c.ct[k] : 0;
  }
  const int32_t m1 = min(__reduce_min_sync(kFull, tree_min(cs)), seed.s);
  const int32_t fa = min(__reduce_min_sync(kFull, tree_min(x2)), seed.fa);
  const int32_t ct = __reduce_add_sync(kFull, tree_sum(x3)) + seed.ct;
  const bool reach = m1 < kInf;

  // round 2: m2 = min (wa + a) over the score-achieving edges (a
  // non-edge has cs = INF32, an edge to an unreachable column cs >= INF32)
#pragma unroll
  for (int k = 0; k < NC; ++k) x1[k] = cs[k] == m1 ? wa[k] + c.a[k] : kInf;
  int32_t m2 = __reduce_min_sync(kFull, tree_min(x1));
  if (seed.s == m1) m2 = min(m2, seed.a);
  Row r;
  r.s = reach ? m1 : kInf;
  r.a = reach ? m2 : 0;

  // round 3: cm and the lowest column over the achieving edges, as
  // _topo_scan's `ach`: edges into reachable columns with (ws + s, wa + a)
  // equal to the row's (s, a).  An unreachable row has (INF32, 0), which
  // an edge with ws + s == INF32 exactly still achieves.
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool ach = cell[k] != kInf && c.s[k] < kInf && cs[k] == r.s &&
                     wa[k] + c.a[k] == r.a;
    x2[k] = ach ? c.cm[k] : 0;
    x3[k] = ach ? first + lane_id() + 32 * k : kNone;
  }
  int32_t cm = __reduce_add_sync(kFull, tree_sum(x2));
  int32_t low = __reduce_min_sync(kFull, tree_min(x3));
  if (seed.s == r.s && seed.a == r.a) {  // never for no_seed()
    cm += seed.cm;
    low = min(low, seed.low);
  }
  r.fa = fa == kNone ? kInf : fa;
  r.ct = min(ct, SAT);
  r.cm = min(cm, SAT);
  r.nxt = low == kNone ? -1 : low;
  return r;
}

// Store row u's result in the slot of the lane that holds column u.
template <int NC>
__device__ __forceinline__ void set_col(Cols<NC>& c, int32_t first,
                                        int32_t u, const Row& r) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool hit = first + lane_id() + 32 * k == u;
    c.s[k] = hit ? r.s : c.s[k];
    c.a[k] = hit ? r.a : c.a[k];
    c.fa[k] = hit ? r.fa : c.fa[k];
    c.ct[k] = hit ? r.ct : c.ct[k];
    c.cm[k] = hit ? r.cm : c.cm[k];
    c.nxt[k] = hit ? r.nxt : c.nxt[k];
  }
}

// The order-insensitivity gate at column `src`, as a warp-uniform bool:
//   fast = cm == 1 && !(ct >= 2 && a != fa)
// (false when no lane holds src).
template <int NC>
__device__ __forceinline__ bool gate_at(const Cols<NC>& c, int32_t first,
                                        int32_t src) {
  bool g = false;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (first + lane_id() + 32 * k == src)
      g = c.cm[k] == 1 && !(c.ct[k] >= 2 && c.a[k] != c.fa[k]);
  }
  return __ballot_sync(kFull, g) != 0;
}

// body(u, cells) for u = n-1 down to 0, with cells[k] the lane's cell k of
// row u as load(u, cells) fills it; the loads of the next D-1 rows are in
// flight while a row steps (a ring of rows in registers, static indices).
template <int NC, int D, class Load, class Body>
__device__ __forceinline__ void reverse_rows(int32_t n, Load load, Body body) {
  int32_t ring[D][NC];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (n - 1 - d >= 0) load(n - 1 - d, ring[d]);
  }
  for (int32_t u0 = n - 1; u0 >= 0; u0 -= D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int32_t u = u0 - d;
      if (u >= 0) {
        int32_t cur[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) cur[k] = ring[d][k];
        if (u - D >= 0) load(u - D, ring[d]);
        body(u, cur);
      }
    }
  }
}

}  // namespace topo
