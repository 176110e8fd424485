// Dense shortest-path fixed point with the full PafDistance tie-break: five
// (B, V, V) int32 edge matrices + a (B, 1, V) dest row -> six (B, 1, V) int32
// state rows [s, a, nz, tot, rank, win].
//
// Replaces the TPU kernel alignasm_tpu/ops/pallas_relax.py:dense_sp_pallas
// (pallas_call at :160, body _kernel :109, one sweep _sweep :61), a library
// entry point with no caller on the engine's paths.
//
// The function is n_sweeps Jacobi sweeps of _sweep: per row u, masked row
// minima in cascade over the columns v -- m1 of the score sums over the
// valid edges (ws < INF32 and s[v] < INF32), m2 of the anomaly sums over
// those achieving m1, m3 of the f32 mapq key -(cnz / max(ctot, 1)) over
// those achieving m2, m4 of the arrival rank over those achieving m3 --
// then, over the cells achieving m4, the minima of cnz and ctot and the
// lowest column (V if none); the row takes them when they beat its state in
// the same lexicographic order.  Every column off a mask contributes
// INF32 (+inf for the key, V for the column).  The f32 key uses IEEE
// division (__fdiv_rn) and round-to-nearest conversions, never fast math,
// so it equals the CPU's bit for bit; keys compare with < and == as in JAX
// (-0.0 == 0.0).  Sums wrap as int32 (add32).
//
// What bounds it: device memory.  The fixed point is a DAG dynamic program
// that one reverse-topological pass computes; the five matrices (20 B V^2
// bytes a contig) are read once.  A row, though, can only be solved after
// its successors, so a contig costs its rows' chain of dependent steps.
//
// Design: a checked pass that replays the Jacobi sweeps without sweeping,
// as csrc/relax64.cu's.  Write a row's update as u(t) = F(u(t-1), S(t-1)),
// S the (s, a, nz, tot) of u's successors after sweep t-1.  The candidates
// (m1..m4, nz, tot, win) depend on S alone and the row takes them or keeps
// its state, so F(F(x, S), S) = F(x, S), whether or not ranks tie, whatever
// the int32 sums wrap to, and although the mapq key is not monotone: u can
// change at sweep t only when t = 1 or a successor changed at sweep t-1.
// In reverse topological order each vertex's change history therefore
// follows from its successors' histories alone, exactly at any n_sweeps.
// One CTA a contig:
//   1. compact: its warps read ws row by row, coalesced; cells with ws <
//      INF32 (negative scores included) are edges, kept in a CSR by row in
//      column order with their wa, wnz, wtot and wrank copied beside them,
//      so that a row of the pass reads no device memory;
//   2. order: warp 0 runs Kahn's algorithm from the sources over the CSR, a
//      frontier a round.  Check (a): the order reaches every vertex, so the
//      valid edges form a DAG (a self-loop or a cycle fails);
//   3. replay: warp 0 takes the rows in reverse order, each from its own
//      initial state (dest compared lane by lane, as _init_state does, so
//      a dest row with several dest lanes is exact).  A row is evaluated at
//      the first sweep after a successor is reached (before it every column
//      is off and F keeps the state) and at each sweep after a successor's
//      change, up to n_sweeps: its lanes take its edges, each keeping a
//      cursor into its head's history, and fold their candidates into the
//      cascade in one pass (Fold: the cascade is a lexicographic minimum
//      whose every level starts from the off value, because a DAG's row
//      holds at most V - 1 edges and so always has an off column); a
//      shuffle tree merges the lanes' folds.  Lane 0 appends an entry to
//      the vertex's history when its (s, a, nz, tot), the words its
//      predecessors read, change; its rank and winner stay in registers.
//      Check (d): the workspace holds the CSR and every history entry.
// A contig that fails (a) or (d) is flagged and the Jacobi branch, the
// literal sweeps, solves it in the launch after the pass; each flagged
// contig is counted in the caller's `jacobi` word when one is given.
// The workspace (per vertex: row starts, Kahn's counts and order, the
// dest flag and the history's run; per edge: the column, the five values
// and the cursor; the history pool) lives in shared memory up to V = 1024
// (one or two CTAs an SM), its pool running on into a global spill pool
// of kSpillPerV entries a vertex, else in a global workspace of kWorkPerV
// words a vertex.
//
// Jacobi branch: one CTA per flagged contig; the double-buffered state (6
// vectors x 2) in shared memory, 12V words; one warp per row u at a time,
// its lanes on the columns, five passes over the row (the cascade), each a
// shuffle reduction.  The loop stops once a sweep changes no state word,
// which equals running all n_sweeps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int32_t kI32Max = 0x7fffffff;
constexpr int32_t kNoTime = 0x7fffffff;  // no further change
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxV = 4096;  // the branch: 12V words of shared memory
constexpr int kMaxWarps = 16;
constexpr int kPassThreads = 256;
// The pass's shared-memory budgets: two CTAs an SM (228 KB less 1 KB
// reserved a CTA, halved) up to kSmemTwoV, one (the 227 KB opt-in limit)
// up to kSmemOneV, each less the kernel's static shared words; above, a
// global workspace of kWorkPerV words a vertex.
constexpr int64_t kSmemTwo = 113 * 1024 - 64;
constexpr int64_t kSmemOne = 227 * 1024 - 64;
constexpr int kSmemTwoV = 256;
constexpr int kSmemOneV = 1024;
constexpr int64_t kWorkPerV = 100;
constexpr int kEntry = 5;          // words of a history entry
constexpr int64_t kSpillPerV = 16;  // global history entries a vertex

__device__ __forceinline__ int32_t add32(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

__device__ __forceinline__ int32_t warp_min(int32_t x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// min by `<` as XLA's reduction: the keys are never NaN (the divisor >= 1)
__device__ __forceinline__ float warp_minf(float x) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ float qkey(int32_t nz, int32_t tot) {
  return -__fdiv_rn(__int2float_rn(nz), __int2float_rn(max(tot, 1)));
}

// ----------------------------------------------------------------------
// The checked pass.

// Words of a contig's workspace: shared memory by V's tier, else global.
__host__ __device__ inline int64_t pass_words(int32_t V) {
  if (V <= kSmemTwoV) return kSmemTwo / 4;
  if (V <= kSmemOneV) return kSmemOne / 4;
  return kWorkPerV * V + 8;
}

// Global words a contig needs: a spill pool of kSpillPerV history entries
// a vertex beside a shared-memory workspace, else the whole workspace.
__host__ __device__ inline int64_t global_words(int32_t V) {
  return V <= kSmemOneV ? kEntry * kSpillPerV * V : pass_words(V);
}

// A contig's pass workspace.  Per vertex: the CSR's row starts (V + 1),
// Kahn's in-degree counts (then each history's end), the order, the dest
// flag and the history's first entry; per edge, in CSR order: the column,
// ws, wa, wnz, wtot, wrank and the cursor (the head's latest entry at the
// row's last evaluation, -1: its initial state); the history pool, whose
// entries (s, a, nz, tot and the sweep of the change) run on into the
// spill pool in global memory.  A vertex's entries are appended while its
// row is replayed, so they lie in one run [head, end) of the pool.
struct Pass {
  int32_t *start, *indeg, *ord, *isd, *head;
  int32_t *ev, *es, *ea, *enz, *etot, *erank, *cp;
  int32_t *pool, *spill;
  int32_t cap, cap2;  // pool entries (cap < 0: the CSR does not fit)

  __device__ __forceinline__ int32_t* entry(int32_t p) const {
    return p < cap ? pool + (int64_t)kEntry * p
                   : spill + (int64_t)kEntry * (p - cap);
  }
};

__device__ inline int64_t fixed_words(int32_t V) { return 5 * (int64_t)V + 1; }

__device__ Pass pass_at(int32_t* base, int32_t V, int32_t E, int64_t words,
                        int32_t* spill, int64_t cap2) {
  Pass w;
  w.start = base;
  w.indeg = base + V + 1;
  w.ord = w.indeg + V;
  w.isd = w.ord + V;
  w.head = w.isd + V;
  int32_t* e = w.head + V;
  w.ev = e;
  w.es = e + E;
  w.ea = e + 2 * (int64_t)E;
  w.enz = e + 3 * (int64_t)E;
  w.etot = e + 4 * (int64_t)E;
  w.erank = e + 5 * (int64_t)E;
  w.cp = e + 6 * (int64_t)E;
  const int64_t rest = words - fixed_words(V) - 7 * (int64_t)E;
  w.cap = rest < 0 ? -1 : (int32_t)(rest / kEntry);
  w.pool = e + 7 * (int64_t)E;
  w.spill = spill;
  w.cap2 = (int32_t)cap2;
  return w;
}

// The visible state of a vertex: what its predecessors' candidates read.
struct St {
  int32_t s, a, nz, tot;
};

// The cascade's minima over a set of columns: m1..m4 lexicographic, each
// level's minimum over the columns that achieve the levels before it and
// the off value (INF32, INF32, +inf, INF32); nz, tot and w the minima over
// the columns achieving all four, and the off values INF32, INF32, V.  The
// identity is the off values; merging two sets takes the lexicographically
// smaller (m1..m4) whole, or on a tie the minima of nz, tot and w.
struct Fold {
  int32_t m1, m2;
  float m3;
  int32_t m4, nz, tot, w;

  __device__ __forceinline__ void merge(const Fold& b) {
    bool take;  // b below this, lexicographically
    if (b.m1 != m1) {
      take = b.m1 < m1;
    } else if (b.m2 != m2) {
      take = b.m2 < m2;
    } else if (b.m3 < m3 || m3 < b.m3) {
      take = b.m3 < m3;
    } else if (b.m4 != m4) {
      take = b.m4 < m4;
    } else {
      nz = min(nz, b.nz);
      tot = min(tot, b.tot);
      w = min(w, b.w);
      return;
    }
    if (take) *this = b;
  }

  // One reached column: it stays on while each key is at most the level's
  // off value (a larger key leaves it off there and below).
  __device__ __forceinline__ void push(int32_t cs, int32_t ca, int32_t cnz,
                                       int32_t ctot, int32_t r, int32_t v,
                                       int32_t V) {
    if (cs > kInf) return;
    Fold c{cs, kInf, INFINITY, kInf, kInf, kInf, V};
    if (ca <= kInf) {
      c.m2 = ca;
      c.m3 = qkey(cnz, ctot);  // finite: below +inf
      if (r <= kInf) {
        c.m4 = r;
        c.nz = min(cnz, kInf);
        c.tot = min(ctot, kInf);
        c.w = v;
      }
    }
    merge(c);
  }

  __device__ __forceinline__ Fold down(int o) const {
    return Fold{__shfl_down_sync(kFull, m1, o), __shfl_down_sync(kFull, m2, o),
                __shfl_down_sync(kFull, m3, o), __shfl_down_sync(kFull, m4, o),
                __shfl_down_sync(kFull, nz, o), __shfl_down_sync(kFull, tot, o),
                __shfl_down_sync(kFull, w, o)};
  }
};

// No column: the off values.
__device__ __forceinline__ Fold off_fold(int32_t V) {
  return Fold{kInf, kInf, INFINITY, kInf, kInf, kInf, V};
}

// The fold of the edge at CSR slot k through a head in state sv.
__device__ __forceinline__ Fold column(const Pass& w, int32_t k, const St& sv,
                                       int32_t V) {
  Fold f = off_fold(V);
  if (sv.s < kInf)
    f.push(add32(w.es[k], sv.s), add32(w.ea[k], sv.a),
           add32(w.enz[k], sv.nz), add32(w.etot[k], sv.tot), w.erank[k],
           w.ev[k], V);
  return f;
}

// Sends contig b to the Jacobi branch and counts it.
__device__ __forceinline__ void to_branch(int* flags, int32_t* jacobi,
                                          int64_t b) {
  flags[b] = 1;
  if (jacobi) atomicAdd(jacobi, 1);
}

// Exclusive scan of n int32 counts in place, by the 32 lanes of a warp, a
// chunk a lane.
__device__ void warp_scan(int32_t* c, int32_t n) {
  const int lane = threadIdx.x & 31;
  const int32_t per = (n + 31) / 32;
  const int32_t lo = min(lane * per, n), hi = min(lo + per, n);
  int32_t sum = 0;
  for (int32_t i = lo; i < hi; ++i) sum += c[i];
  int32_t incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int32_t run = incl - sum;
  for (int32_t i = lo; i < hi; ++i) {
    const int32_t x = c[i];
    c[i] = run;
    run += x;
  }
}

__global__ void __launch_bounds__(kPassThreads)
dense_sp_pass_kernel(const int32_t* __restrict__ ws_all,
                     const int32_t* __restrict__ wa_all,
                     const int32_t* __restrict__ wnz_all,
                     const int32_t* __restrict__ wtot_all,
                     const int32_t* __restrict__ wrank_all,
                     const int32_t* __restrict__ dest_all, int32_t V,
                     int32_t n_sweeps, int* __restrict__ flags,
                     int32_t* __restrict__ jacobi, int32_t* __restrict__ work,
                     int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  __shared__ int tail;
  const int64_t b = blockIdx.x;
  const int64_t VV = (int64_t)V * V;
  const int32_t* ws = ws_all + b * VV;
  const int32_t* dest = dest_all + b * V;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nw = kPassThreads / 32;
  const int64_t words = pass_words(V);
  const bool global = V > kSmemOneV;
  int32_t* base = global ? work + b * words : sm;
  int32_t* spill = global ? nullptr : work + b * global_words(V);
  const int64_t plane = (int64_t)gridDim.x * V;  // one (B, 1, V) output
  int32_t* o = out + b * V;

  // --- initial states, and each row's edge count -------------------------
  int32_t* start = base;
  int32_t* indeg = base + V + 1;
  int32_t* isd = indeg + 2 * V;
  for (int32_t v = tid; v < V; v += kPassThreads) {
    const bool d = v == dest[v];
    isd[v] = d;
    indeg[v] = 0;
    o[v] = d ? 0 : kInf;
    o[plane + v] = o[2 * plane + v] = o[3 * plane + v] = 0;
    o[4 * plane + v] = d ? -1 : kInf;
    o[5 * plane + v] = -1;
  }
  __syncthreads();
  for (int32_t u = warp; u < V; u += nw) {
    int32_t n = 0;
    for (int32_t c = 0; c < V; c += 32) {
      const int32_t v = c + lane;
      const bool e = v < V && ws[(int64_t)u * V + v] < kInf;
      n += __popc(__ballot_sync(kFull, e));
      if (e) atomicAdd(&indeg[v], 1);
    }
    if (lane == 0) start[u] = n;
  }
  __syncthreads();
  if (warp == 0) warp_scan(start, V + 1);
  __syncthreads();
  const int32_t E = start[V];
  const Pass w = pass_at(base, V, E, words, spill,
                         global ? 0 : kSpillPerV * V);
  if (w.cap < 0) {  // check (d): the CSR does not fit
    if (tid == 0) to_branch(flags, jacobi, b);
    return;
  }

  // --- the CSR: each row's edges in column order -------------------------
  const int64_t cb = b * VV;
  for (int32_t u = warp; u < V; u += nw) {
    int32_t k = w.start[u];
    for (int32_t c = 0; c < V; c += 32) {
      const int32_t v = c + lane;
      const int64_t cell = (int64_t)u * V + v;
      const int32_t x = v < V ? ws[cell] : kInf;
      const unsigned m = __ballot_sync(kFull, x < kInf);
      if (x < kInf) {
        const int32_t j = k + __popc(m & ((1u << lane) - 1));
        w.ev[j] = v;
        w.es[j] = x;
        w.ea[j] = wa_all[cb + cell];
        w.enz[j] = wnz_all[cb + cell];
        w.etot[j] = wtot_all[cb + cell];
        w.erank[j] = wrank_all[cb + cell];
        w.cp[j] = -1;
      }
      k += __popc(m);
    }
  }
  for (int32_t v = tid; v < V; v += kPassThreads) w.head[v] = -1;
  __syncthreads();
  if (warp) return;

  // --- Kahn's order from the sources; check (a) --------------------------
  int32_t done = 0, end = 0;
  for (int32_t c = 0; c < V; c += 32) {
    const int32_t v = c + lane;
    const bool z = v < V && w.indeg[v] == 0;
    const unsigned m = __ballot_sync(kFull, z);
    if (z) w.ord[end + __popc(m & ((1u << lane) - 1))] = v;
    end += __popc(m);
  }
  if (lane == 0) tail = end;
  __syncwarp();
  while (done < end) {
    for (int32_t i = done + lane; i < end; i += 32) {
      const int32_t u = w.ord[i];
      for (int32_t k = w.start[u]; k < w.start[u + 1]; ++k) {
        const int32_t v = w.ev[k];
        if (atomicSub(&w.indeg[v], 1) == 1) w.ord[atomicAdd(&tail, 1)] = v;
      }
    }
    __syncwarp();
    done = end;
    end = *(volatile int*)&tail;
    __syncwarp();
  }
  if (end != V) {  // a cycle
    if (lane == 0) to_branch(flags, jacobi, b);
    return;
  }

  // --- the rows in reverse order: each vertex's change history ----------
  const int32_t limit = min(n_sweeps, V + 1);  // no change after sweep L + 1
  int32_t used = 0;  // pool entries (lane 0)
  for (int32_t i = V - 1; i >= 0; --i) {
    const int32_t u = w.ord[i], lo = w.start[u], n = w.start[u + 1] - lo;
    if (n == 0) continue;  // its initial state, already written
    // the first sweep after a successor is reached
    int32_t t = kNoTime;
    for (int32_t j = lane; j < n; j += 32) {
      const int32_t v = w.ev[lo + j], h = w.head[v];
      t = min(t, w.isd[v] ? 1 : h >= 0 ? w.entry(h)[4] + 1 : kNoTime);
    }
    t = __reduce_min_sync(kFull, t);
    const bool d = w.isd[u];
    St x{d ? 0 : kInf, 0, 0, 0};
    float xq = qkey(0, 0);  // x's mapq key
    int32_t rank = d ? -1 : kInf, win = -1;
    const int32_t first = used;
    // A row of at most 32 edges keeps each in its lane's registers, with
    // the cursor and the column's fold of the head's state, refolded only
    // when the cursor moves; a wider row reads its edges each evaluation.
    const bool cached = n <= 32;
    int32_t k = lo + lane, cp = -1, h = -1, hend = 0;
    Fold col = off_fold(V);
    if (cached && lane < n) {
      const int32_t v = w.ev[k];
      h = w.head[v];
      hend = h < 0 ? 0 : w.indeg[v];  // the run's end
      col = column(w, k, St{w.isd[v] ? 0 : kInf, 0, 0, 0}, V);
    }
    while (t <= limit) {
      Fold f = off_fold(V);
      int32_t nxt = kNoTime;
      if (cached) {
        if (lane < n) {  // the head's latest entry before sweep t
          int32_t q = cp < 0 ? h : cp + 1;
          const int32_t p0 = cp;
          while (q >= 0 && q < hend && w.entry(q)[4] < t) cp = q++;
          if (q >= 0 && q < hend) nxt = w.entry(q)[4] + 1;
          if (cp != p0) {
            const int32_t* e = w.entry(cp);
            col = column(w, k, St{e[0], e[1], e[2], e[3]}, V);
          }
          f = col;
        }
      } else {
        for (int32_t j = lane; j < n; j += 32) {
          const int32_t kk = lo + j, v = w.ev[kk], hv = w.head[v];
          const int32_t ev_end = hv < 0 ? 0 : w.indeg[v];
          int32_t p = w.cp[kk], q = p < 0 ? hv : p + 1;
          while (q >= 0 && q < ev_end && w.entry(q)[4] < t) p = q++;
          w.cp[kk] = p;
          if (q >= 0 && q < ev_end) nxt = min(nxt, w.entry(q)[4] + 1);
          St sv{w.isd[v] ? 0 : kInf, 0, 0, 0};
          if (p >= 0) {
            const int32_t* e = w.entry(p);
            sv = St{e[0], e[1], e[2], e[3]};
          }
          f.merge(column(w, kk, sv, V));
        }
      }
      for (int off = 16; off; off >>= 1)
        if (off < n) f.merge(f.down(off));
      nxt = __reduce_min_sync(kFull, nxt);
      if (lane == 0) {
        bool better = f.m1 < x.s ||
            (f.m1 == x.s && (f.m2 < x.a ||
                             (f.m2 == x.a && (f.m3 < xq ||
                                              (f.m3 == xq && f.m4 < rank)))));
        if (better && f.m1 < kInf) {
          const St nx{f.m1, f.m2, f.nz, f.tot};
          if (nx.s != x.s || nx.a != x.a || nx.nz != x.nz ||
              nx.tot != x.tot) {
            if (used < w.cap + w.cap2) {
              int32_t* e = w.entry(used);
              e[0] = nx.s;
              e[1] = nx.a;
              e[2] = nx.nz;
              e[3] = nx.tot;
              e[4] = t;
            }
            ++used;
            xq = qkey(nx.nz, nx.tot);
          }
          x = nx;
          rank = f.m4;
          win = f.w;
        }
      }
      t = nxt;
    }
    if (lane == 0) {
      if (used > first) {  // the row's run of entries
        w.head[u] = first;
        w.indeg[u] = used;
      }
      o[u] = x.s;
      o[plane + u] = x.a;
      o[2 * plane + u] = x.nz;
      o[3 * plane + u] = x.tot;
      o[4 * plane + u] = rank;
      o[5 * plane + u] = win;
    }
    if (__shfl_sync(kFull, used, 0) > w.cap + w.cap2) break;  // check (d)
    __syncwarp();  // the row's history, for the rows before it
  }
  if (lane == 0 && used > w.cap + w.cap2) to_branch(flags, jacobi, b);
}

// ----------------------------------------------------------------------
// The Jacobi branch.

struct State {
  int32_t* s;
  int32_t* a;
  int32_t* nz;
  int32_t* tot;
  int32_t* rank;
  int32_t* win;
};

__global__ void __launch_bounds__(32 * kMaxWarps)
dense_sp_kernel(const int32_t* __restrict__ ws_all,
                const int32_t* __restrict__ wa_all,
                const int32_t* __restrict__ wnz_all,
                const int32_t* __restrict__ wtot_all,
                const int32_t* __restrict__ wrank_all,
                const int32_t* __restrict__ dest_all, int32_t V,
                int32_t n_sweeps, const int* __restrict__ flags,
                int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  const int64_t b = blockIdx.x;
  if (!flags[b]) return;  // the pass solved this contig
  State st[2];
  for (int k = 0; k < 2; ++k) {
    int32_t* p = sm + k * 6 * V;
    st[k] = State{p, p + V, p + 2 * V, p + 3 * V, p + 4 * V, p + 5 * V};
  }
  const int64_t VV = (int64_t)V * V;
  const int32_t* ws = ws_all + b * VV;
  const int32_t* wa = wa_all + b * VV;
  const int32_t* wnz = wnz_all + b * VV;
  const int32_t* wtot = wtot_all + b * VV;
  const int32_t* wrank = wrank_all + b * VV;
  const int32_t* dest = dest_all + b * V;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;

  for (int v = tid; v < V; v += blockDim.x) {
    const bool is_dest = v == dest[v];
    st[0].s[v] = is_dest ? 0 : kInf;
    st[0].a[v] = 0;
    st[0].nz[v] = 0;
    st[0].tot[v] = 0;
    st[0].rank[v] = is_dest ? -1 : kInf;
    st[0].win[v] = -1;
  }
  __syncthreads();

  int cur = 0, it = 0;
  while (it < n_sweeps) {
    const State d = st[cur];
    const State n = st[cur ^ 1];
    bool changed = false;
    for (int32_t u = warp; u < V; u += nw) {
      const int64_t row = (int64_t)u * V;
      // m1: score sums over the valid edges
      int32_t m1 = kI32Max;
      for (int32_t v = lane; v < V; v += 32) {
        const int32_t w = ws[row + v], sv = d.s[v];
        const bool valid = w < kInf && sv < kInf;
        m1 = min(m1, valid ? add32(w, sv) : kInf);
      }
      m1 = warp_min(m1);
      // m2: anomaly sums over the cells achieving m1
      int32_t m2 = kI32Max;
      for (int32_t v = lane; v < V; v += 32) {
        const int32_t w = ws[row + v], sv = d.s[v];
        const bool on = w < kInf && sv < kInf && add32(w, sv) == m1;
        m2 = min(m2, on ? add32(wa[row + v], d.a[v]) : kInf);
      }
      m2 = warp_min(m2);
      // m3: the mapq key over the cells achieving m2; m4: the rank
      float m3 = INFINITY;
      for (int32_t v = lane; v < V; v += 32) {
        const int32_t w = ws[row + v], sv = d.s[v];
        const bool on = w < kInf && sv < kInf && add32(w, sv) == m1 &&
                        add32(wa[row + v], d.a[v]) == m2;
        if (on) {
          const float q = qkey(add32(wnz[row + v], d.nz[v]),
                               add32(wtot[row + v], d.tot[v]));
          m3 = q < m3 ? q : m3;
        }
      }
      m3 = warp_minf(m3);
      int32_t m4 = kI32Max;
      for (int32_t v = lane; v < V; v += 32) {
        const int32_t w = ws[row + v], sv = d.s[v];
        bool on = w < kInf && sv < kInf && add32(w, sv) == m1 &&
                  add32(wa[row + v], d.a[v]) == m2;
        on = on && qkey(add32(wnz[row + v], d.nz[v]),
                        add32(wtot[row + v], d.tot[v])) == m3;
        m4 = min(m4, on ? wrank[row + v] : kInf);
      }
      m4 = warp_min(m4);
      // the winners' nz / tot minima and lowest column
      int32_t nzv = kI32Max, totv = kI32Max, wv = kI32Max;
      for (int32_t v = lane; v < V; v += 32) {
        const int32_t w = ws[row + v], sv = d.s[v];
        const int32_t cnz = add32(wnz[row + v], d.nz[v]);
        const int32_t ctot = add32(wtot[row + v], d.tot[v]);
        const bool on = w < kInf && sv < kInf && add32(w, sv) == m1 &&
                        add32(wa[row + v], d.a[v]) == m2 &&
                        qkey(cnz, ctot) == m3 && wrank[row + v] == m4;
        nzv = min(nzv, on ? cnz : kInf);
        totv = min(totv, on ? ctot : kInf);
        wv = min(wv, on ? v : V);
      }
      nzv = warp_min(nzv);
      totv = warp_min(totv);
      wv = warp_min(wv);
      if (lane == 0) {
        // the masked minima over all V columns, as JAX takes them: a column
        // off the mask contributes INF32 (or V, or +inf for the key)
        const int32_t su = d.s[u], au = d.a[u], ru = d.rank[u];
        const float inc_q = qkey(d.nz[u], d.tot[u]);
        bool better = m1 < su ||
            (m1 == su && (m2 < au ||
                          (m2 == au && (m3 < inc_q ||
                                        (m3 == inc_q && m4 < ru)))));
        better = better && m1 < kInf;
        const int32_t ns = better ? m1 : su, na = better ? m2 : au;
        const int32_t nnz = better ? nzv : d.nz[u];
        const int32_t ntot = better ? totv : d.tot[u];
        const int32_t nr = better ? m4 : ru;
        const int32_t nwn = better ? wv : d.win[u];
        n.s[u] = ns;
        n.a[u] = na;
        n.nz[u] = nnz;
        n.tot[u] = ntot;
        n.rank[u] = nr;
        n.win[u] = nwn;
        changed |= ns != su || na != au || nnz != d.nz[u] ||
                   ntot != d.tot[u] || nr != ru || nwn != d.win[u];
      }
    }
    ++it;
    if (!__syncthreads_or(changed)) break;
    cur ^= 1;
  }
  const State f = st[cur];
  const int64_t plane = (int64_t)gridDim.x * V;  // one (B, 1, V) output
  for (int v = tid; v < V; v += blockDim.x) {
    const int64_t i = b * V + v;
    out[i] = f.s[v];
    out[plane + i] = f.a[v];
    out[2 * plane + i] = f.nz[v];
    out[3 * plane + i] = f.tot[v];
    out[4 * plane + i] = f.rank[v];
    out[5 * plane + i] = f.win[v];
  }
}

}  // namespace

// int32 words of global workspace the entry point needs per contig: the
// spill pool beside a shared-memory workspace, or the whole workspace.
extern "C" int64_t aln_dense_sp_work_words(int32_t V) {
  return global_words(V);
}

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launches.  `out` is (6, B, 1, V)
// int32.  `flags` holds B int32 zeros: the pass sets flags[b] for each
// contig the Jacobi branch must solve and adds their number to the one
// int32 at `jacobi` unless that is null.  `work` holds
// aln_dense_sp_work_words(V) * B int32.
extern "C" int aln_dense_sp(int device, const int32_t* ws, const int32_t* wa,
                            const int32_t* wnz, const int32_t* wtot,
                            const int32_t* wrank, const int32_t* dest,
                            int64_t B, int32_t V, int32_t n_sweeps,
                            int* flags, int32_t* jacobi, int32_t* work,
                            int32_t* out, void* stream) {
  if (V < 1 || V > kMaxV || n_sweeps < 0 || B < 0 || B > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t psmem =
      V > kSmemOneV ? 0 : (size_t)pass_words(V) * sizeof(int32_t);
  if (psmem > 48 * 1024) {
    rc = cudaFuncSetAttribute(dense_sp_pass_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)psmem);
    if (rc != cudaSuccess) return (int)rc;
  }
  dense_sp_pass_kernel<<<(unsigned)B, kPassThreads, psmem, st>>>(
      ws, wa, wnz, wtot, wrank, dest, V, n_sweeps, flags, jacobi, work, out);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const size_t smem = (size_t)12 * V * sizeof(int32_t);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(dense_sp_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int warps = V < kMaxWarps ? V : kMaxWarps;
  dense_sp_kernel<<<(unsigned)B, 32 * warps, smem, st>>>(
      ws, wa, wnz, wtot, wrank, dest, V, n_sweeps, flags, out);
  return (int)cudaGetLastError();
}
