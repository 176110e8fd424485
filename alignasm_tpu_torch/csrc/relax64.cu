// int64 sparse relaxation over the full PafDistance semiring: (B, E) edge
// lists -> per vertex of a contig the lexicographic distance to dest (d_s,
// d_a, d_nz, d_tot, the reference's arrival rank and the winning edge
// d_eid), the anomaly floor floor_a and the walk counts cnt_tot, cnt_min.
//
// Replaces the XLA kernel alignasm_tpu/ops/relax.py:solve_graph_batch (:73),
// which the Python plane runs for its buckets holding a contig whose path
// sums may pass int32 (scheduler._fits32 false: long query gaps).
//
// The function is four loops in order, each n_sweeps Jacobi sweeps, as in
// the JAX function: the distance over (k1, k2, erank), k1 = sum << 16 |
// anom, k2 = QUL_ONE - (nz << 30) // tot (the mapq mediant, floor
// division), erank the first-improvement tie-break, with a vertex keeping
// its incumbent unless a candidate is strictly better; the anomaly floor;
// the walk count and the count of min walks (the k1-achieving edges),
// saturated at COUNT_SAT after every sweep.
//
// What bounds it: dependent steps.  Each loop is a DAG dynamic program over
// the edge lists (36 bytes an edge, read once: ~0.01 ms a bucket), but a
// row can be solved only after its successors, so a contig costs its rows'
// latency, not its bytes.
//
// Design: a checked pass that replays the Jacobi loops without sweeping,
// the distance of each row by csrc/replay.cuh's replay_row (why one pass
// is exact at any n_sweeps, ties and the non-monotone mediant included, is
// written there; csrc/shard_relax.cu runs the same row on the graph axis).
// Its Rule here picks the winner as the lowest edge index among the
// reached edges whose erank equals m3.  The floor and the counts are
// monotone and cannot wrap (the floor sums int32 anomalies along fewer
// than 8192 edges, a count is at most COUNT_SAT times the degree), so, as
// in topo_pass.cuh, one pass over the successors' final values equals
// their n_sweeps loops once the longest path L <= n_sweeps; the same row
// computes them.  Per contig the pass checks:
//   (a) the host's hint (order[t] = the vertex at position t; null: the
//       identity) is a permutation of 0..V-1, every valid edge lies in
//       [0, V)^2, and every valid edge (u, v) has pos[v] > pos[u], or v is
//       dest while dest's own row holds no edge (dest then never changes);
//   (b) L <= n_sweeps (the floor and the counts only);
//   (c) the contig is deep: 4 L >= 3 R, R its rows (vertices with a valid
//       out-edge).  The pass costs R dependent rows, the Jacobi loops
//       about 4 (L + 1) sweeps that spread a row a thread, so a wide DAG
//       runs faster there (PERF.md: querysparse2000's chains, L = R, 2.5x
//       faster in the pass; the seeded V = 512 DAGs, L ~ 0.45 R, 4.6x
//       faster in the loops);
//   (d) the history pool (at least kPool * V entries a contig) holds
//       every entry.
// A contig that fails (a), (c) or (d) is flagged 1 and the Jacobi branch,
// the four literal loops, solves it in the launch that follows the pass;
// one that fails (b) alone is flagged 2 and the branch runs the floor and
// the counts from the pass's distance.  Each flagged contig is counted in
// the caller's `jacobi` word when one is given.
//
// The pass: one CTA per contig counting-sorts the valid edges by eu into a
// CSR, copying each edge's fields into the workspace in CSR order (a row
// reads no device memory); an invalid edge only flags its tail, whose
// three minima then start at INF (the padding edge feeds them INF in JAX).
// What a row costs is its chain of dependent instructions (PERF.md has the
// cycles a row by phase).  One warp steps the rows in reverse hint order
// twice: first each vertex's longest path (int32, for (b) and (c)), then
// the rows (replay_row, then the floor and the counts).  The workspace
// (pool, per-vertex vectors, CSR) lives in shared memory when it fits one
// CTA's (kSmemOne), the pool taking what two CTAs an SM (kSmemTwo), or
// else one, leave; else a global workspace.
//
// Jacobi branch: one CTA per flagged contig, the literal loops.  Its
// threads build the same CSR, then each sweep gives each thread whole
// vertices: three passes over the out-edges (m1, m2, m3), the winner, the
// new state into the other of two buffers; then the floor and both counts.
// A loop stops once a sweep changes no word of the contig (the next state
// is a function of the current one only, so the result equals the full
// n_sweeps).  Its state and CSR live in shared memory when they fit
// kSmemBytes, else in the global workspace.

#include <cuda_runtime.h>
#include <stdint.h>

#include "replay.cuh"

namespace {

using namespace replay;

constexpr int64_t kCountSat = 10001;
constexpr int kMaxV = 8192;
constexpr int kThreads = 256;      // the Jacobi branch
constexpr int kPassThreads = 128;  // the pass
constexpr int64_t kSmemBytes = 96 * 1024;
// The pass's shared-memory budgets: two CTAs an SM (228 KB less 1 KB
// reserved a CTA, halved) or one (the 227 KB opt-in limit), each less
// the kernel's static shared words.
constexpr int64_t kSmemTwo = 113 * 1024 - 64;
constexpr int64_t kSmemOne = 227 * 1024 - 64;
constexpr int kPool = 4;                  // least history entries a vertex

// Exclusive scan of n int32 counts in place, by the 32 lanes of warp 0, a
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

// ----------------------------------------------------------------------
// The checked pass.

// A contig's pass workspace: the history pool (`cap` entries: s, a, nz,
// tot, the sweep of the change and the next entry of the same vertex); per
// vertex the floor, the list's head and last entry, pos (then the rows'
// order), L, the invalid-edge flag and the two counts; the CSR's row
// starts (V + 1) and, in
// CSR order, each valid edge's index and fields (a row reads its edges from
// the workspace, never from device memory) and the row's cache of it: the
// head's latest entry at the row's last evaluation (-1: its initial
// state) and whether that state is reached.
struct Pass {
  int64_t *hs, *ha, *hnz, *htot, *fa, *es, *erank;
  int32_t *htime, *hnext, *head, *last, *pos, *len, *inv, *ct, *cm, *start,
      *eidx, *ev, *ea, *enz, *etot, *cp, *cok;
};

__host__ __device__ int64_t pass_bytes(int32_t V, int64_t E, int64_t P) {
  const int64_t bytes =
      8 * (4 * P + V + 2 * E) + 4 * (2 * P + 8 * (int64_t)V + 1 + 7 * E);
  return (bytes + 7) / 8 * 8;
}

// The pool's capacity, at least kPool * V entries: the rest of two CTAs'
// shared memory an SM when that holds them, else the rest of one CTA's,
// else kPool * V in the global workspace.  (A chain changes each vertex
// about once; a wide DAG's vertices a few times: PERF.md.)
int64_t pool_entries(int32_t V, int64_t E) {
  const int64_t least = (int64_t)kPool * V, fixed = pass_bytes(V, E, 0);
  if (pass_bytes(V, E, least) <= kSmemTwo) return (kSmemTwo - fixed) / 40;
  if (pass_bytes(V, E, least) <= kSmemOne) return (kSmemOne - fixed) / 40;
  return least;
}

bool pass_in_smem(int32_t V, int64_t E) {
  return pass_bytes(V, E, pool_entries(V, E)) <= kSmemOne;
}

__device__ Pass pass_at(int64_t* base, int32_t V, int64_t E, int64_t P) {
  Pass w;
  w.hs = base;
  w.ha = base + P;
  w.hnz = base + 2 * P;
  w.htot = base + 3 * P;
  w.fa = base + 4 * P;
  w.es = w.fa + V;
  w.erank = w.es + E;
  int32_t* q = (int32_t*)(w.erank + E);
  w.htime = q;
  w.hnext = q + P;
  w.head = q + 2 * P;
  w.last = w.head + V;
  w.pos = w.last + V;
  w.len = w.pos + V;
  w.inv = w.len + V;
  w.ct = w.inv + V;
  w.cm = w.ct + V;
  w.start = w.cm + V;
  w.eidx = w.start + V + 1;
  w.ev = w.eidx + E;
  w.ea = w.ev + E;
  w.enz = w.ea + E;
  w.etot = w.enz + E;
  w.cp = w.etot + E;
  w.cok = w.cp + E;
  return w;
}

// What a row reads: the contig's workspace, its view for replay_row, and
// its outputs.
struct Ctx {
  Pass w;
  Hist<int32_t> h;
  int64_t* out;  // the contig's d_s; the other outputs BV apart
  int64_t BV;
  int32_t* out_eid;
};

__device__ Hist<int32_t> hist_of(const Pass& w, int* cursor, int32_t cap,
                                 int32_t dest, int32_t limit) {
  Hist<int32_t> h;
  h.ev = w.ev;
  h.ea = w.ea;
  h.enz = w.enz;
  h.etot = w.etot;
  h.inv = w.inv;
  h.es = w.es;
  h.erank = w.erank;
  h.cp = w.cp;
  h.hnext = w.hnext;
  h.head = w.head;
  h.cok = w.cok;
  h.htime = w.htime;
  h.hs = w.hs;
  h.ha = w.ha;
  h.hnz = w.hnz;
  h.htot = w.htot;
  h.cursor = cursor;
  h.cap = cap;
  h.dest = dest;
  h.limit = limit;
  return h;
}

// replay_row's Rule here: the floor and the walk count from the
// successors' final values, folded as the row starts, and the winner, the
// lowest edge index among the reached edges whose erank equals m3.
struct Row64 {
  const Pass& w;
  int64_t fm = kInf, cts = 0;
  int32_t eid = -1;

  __device__ explicit Row64(const Pass& pw) : w(pw) {}

  __device__ __forceinline__ void edge(int32_t k, int32_t v) {
    const int64_t fv = w.fa[v];
    fm = min64(fm, fv < kInf ? add64(fv, w.ea[k]) : kInf);
    cts = add64(cts, w.ct[v]);
  }

  template <int G>
  __device__ __forceinline__ bool pick(const Hist<int32_t>& h, int32_t lo,
                                       int32_t n, int lane, Fold&, int64_t,
                                       int64_t m3, const St& one, bool one_ok,
                                       St& nx, int64_t& nr) {
    int32_t mine = kNoTime, k = kNoTime;  // and its CSR slot
    if (G == 1 && n == 1) {  // the fold's own candidate
      if (one_ok && w.erank[lo] == m3) {
        mine = w.eidx[lo];
        k = lo;
      }
    } else {
      for (int32_t j = lane; j < n; j += G) {
        const int32_t e = w.eidx[lo + j];
        if (w.cok[lo + j] && w.erank[lo + j] == m3 && e < mine) {
          mine = e;
          k = lo + j;
        }
      }
    }
    const int32_t win = group_min32<G>(mine);
    k = group_min32<G>(mine == win ? k : kNoTime);
    if (win == kNoTime) return false;
    nx = G == 1 && n == 1 ? one : cached_cand(h, k);
    nr = w.erank[k];
    eid = win;
    return true;
  }
};

// Row u, by a group of G threads (the warp, or G = 1 in every lane alike
// for a row of at most one edge, the leader alone writing): its distance
// history (replay_row), then its floor and counts from the successors'
// final values.
template <int G>
__device__ __forceinline__ void solve_row(const Ctx& c, int32_t u,
                                          bool leader) {
  const int lane = G == 1 ? 0 : (int)(threadIdx.x & 31);
  const Pass& w = c.w;
  const int32_t lo = w.start[u], n = w.start[u + 1] - lo;
  const bool is_dest = u == c.h.dest;
  Row64 row(w);
  int64_t rank;
  int32_t tail;
  const St x = replay_row<G>(c.h, u, lo, n, lane, leader, row, rank, tail);

  // the count of min walks over the successors' final values
  const int64_t du = x.s < kInf ? pack_k1(x.s, x.a) : kInf;
  int64_t cms = 0;
  for (int32_t j = lane; j < n; j += G) {
    const int32_t k = lo + j, v = w.ev[k];
    const int32_t lv = w.last[v];
    const St sv = lv >= 0 ? St{w.hs[lv], w.ha[lv], 0, 0}
                          : init_state(v, c.h.dest);
    if (sv.s < kInf &&
        pack_k1(add64(sv.s, w.es[k]), add64(sv.a, w.ea[k])) == du)
      cms = add64(cms, w.cm[v]);
  }
  const int64_t fm = group_min<G>(row.fm);
  const int64_t cts = group_sum<G>(row.cts);
  cms = group_sum<G>(cms);
  if (leader) {
    const int64_t fa = min64(is_dest ? 0 : kInf, fm);
    const int32_t ct = (int32_t)min64(add64(is_dest, cts), kCountSat);
    const int32_t cm = (int32_t)min64(add64(is_dest, cms), kCountSat);
    w.fa[u] = fa;
    w.ct[u] = ct;
    w.cm[u] = cm;
    w.last[u] = tail;
    int64_t* o = c.out + u;
    o[0] = x.s;
    o[c.BV] = x.a;
    o[2 * c.BV] = x.nz;
    o[3 * c.BV] = x.tot;
    o[4 * c.BV] = fa;
    o[5 * c.BV] = ct;
    o[6 * c.BV] = cm;
    c.out_eid[u] = row.eid;
  }
}

// Sends contig b to the Jacobi branch (flag 1: all of it, 2: the floor and
// the counts) and counts it.
__device__ __forceinline__ void to_branch(int* flags, int32_t* jacobi,
                                          int64_t b, int f) {
  flags[b] = f;
  if (jacobi) atomicAdd(jacobi, 1);
}

__global__ void __launch_bounds__(kPassThreads)
relax64_pass_kernel(const int32_t* __restrict__ eu_all,
                    const int32_t* __restrict__ ev_all,
                    const int64_t* __restrict__ es_all,
                    const int32_t* __restrict__ ea_all,
                    const int32_t* __restrict__ enz_all,
                    const int32_t* __restrict__ etot_all,
                    const int64_t* __restrict__ erank_all,
                    const uint8_t* __restrict__ evalid_all,
                    const int32_t* __restrict__ dest_all,
                    const int32_t* __restrict__ order_all, int64_t B,
                    int64_t E, int32_t V, int32_t n_sweeps, int32_t cap,
                    int* __restrict__ flags, int32_t* __restrict__ jacobi,
                    int64_t* __restrict__ work, int64_t* __restrict__ out,
                    int32_t* __restrict__ out_eid) {
  extern __shared__ int64_t sm[];
  __shared__ int bad, cursor;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int32_t* eu = eu_all + b * E;
  const int32_t* ev = ev_all + b * E;
  const uint8_t* evalid = evalid_all + b * E;
  const int32_t* order = order_all ? order_all + b * V : nullptr;
  const int32_t dest = dest_all[b];
  Ctx c;
  c.w = pass_at(work ? work + b * (pass_bytes(V, E, cap) / 8) : sm, V, E,
                cap);
  // no change comes after sweep L + 1
  c.h = hist_of(c.w, &cursor, cap, dest, min(n_sweeps, V + 1));
  c.out = out + b * V;
  c.BV = B * V;
  c.out_eid = out_eid + b * V;
  const Pass& w = c.w;

  // --- the CSR of the valid edges by eu, and check (a) -------------------
  if (tid == 0) {
    bad = 0;
    cursor = 0;
  }
  for (int32_t v = tid; v <= V; v += kPassThreads) w.start[v] = 0;
  for (int32_t v = tid; v < V; v += kPassThreads) {
    w.pos[v] = -1;
    w.inv[v] = 0;
  }
  __syncthreads();
  bool ok = true;
  for (int32_t t = tid; t < V; t += kPassThreads) {
    const int32_t v = order ? order[t] : t;
    if (v < 0 || v >= V || atomicExch(&w.pos[v], t) != -1) ok = false;
  }
  for (int64_t e = tid; e < E; e += kPassThreads) {
    const int32_t u = eu[e], v = ev[e];
    if (!evalid[e]) {
      if (u >= 0 && u < V) w.inv[u] = 1;  // JAX's segment ops drop the rest
    } else if (u < 0 || u >= V || v < 0 || v >= V) {
      ok = false;
    } else {
      atomicAdd(&w.start[u], 1);
    }
  }
  if (!ok) bad = 1;
  __syncthreads();
  if (bad) {
    if (tid == 0) to_branch(flags, jacobi, b, 1);
    return;
  }
  if (tid < 32) warp_scan(w.start, V + 1);
  __syncthreads();
  for (int32_t v = tid; v < V; v += kPassThreads) w.last[v] = w.start[v];
  __syncthreads();
  // dest's row holds no edge: an edge may enter it from any position
  const bool dest_free =
      dest >= 0 && dest < V && w.start[dest + 1] == w.start[dest];
  for (int64_t e = tid; e < E; e += kPassThreads) {
    if (!evalid[e]) continue;
    const int32_t u = eu[e], v = ev[e];
    if (!(v == dest && dest_free) && w.pos[v] <= w.pos[u]) ok = false;
    const int32_t k = atomicAdd(&w.last[u], 1);
    w.eidx[k] = (int32_t)e;
    w.ev[k] = v;
    w.es[k] = es_all[b * E + e];
    w.ea[k] = ea_all[b * E + e];
    w.enz[k] = enz_all[b * E + e];
    w.etot[k] = etot_all[b * E + e];
    w.erank[k] = erank_all[b * E + e];
  }
  if (!ok) bad = 1;
  __syncthreads();
  if (bad) {
    if (tid == 0) to_branch(flags, jacobi, b, 1);
    return;
  }
  for (int32_t v = tid; v < V; v += kPassThreads) {
    const bool d = v == dest;
    w.pos[v] = order ? order[v] : v;  // the rows' order
    w.head[v] = w.last[v] = -1;
    w.len[v] = 0;
    w.fa[v] = d ? 0 : kInf;
    w.ct[v] = w.cm[v] = d;
    // a row without edges keeps its initial values and is not visited
    int64_t* o = c.out + v;
    o[0] = o[4 * c.BV] = d ? 0 : kInf;
    o[c.BV] = o[2 * c.BV] = o[3 * c.BV] = 0;
    o[5 * c.BV] = o[6 * c.BV] = d;
    c.out_eid[v] = -1;
  }
  __syncthreads();

  if (tid >= 32) return;

  // --- L in reverse hint order; checks (c) and (b) ----------------------
  // Every lane writes the same L[u], so that each reads back its own
  // writes without a barrier; a chain's successor is the row just done,
  // whose L stays in a register.
  int32_t top = 0, rows = 0, pu = -1, pl = 0;
  for (int32_t t = V - 1; t >= 0; --t) {
    const int32_t u = w.pos[t], lo = w.start[u], n = w.start[u + 1] - lo;
    if (n == 0) continue;
    int32_t l = 0;
    if (n == 1) {  // every lane alike
      const int32_t v = w.ev[lo];
      l = (v == pu ? pl : w.len[v]) + 1;
    } else {
      for (int32_t j = lane; j < n; j += 32)
        l = max(l, w.len[w.ev[lo + j]] + 1);
      l = __reduce_max_sync(kFull, l);
    }
    w.len[u] = l;
    pu = u;
    pl = l;
    top = max(top, l);
    ++rows;
  }
  if (4 * (int64_t)top < 3 * (int64_t)rows) {
    if (lane == 0) to_branch(flags, jacobi, b, 1);
    return;
  }

  // --- the rows in reverse hint order ------------------------------------
  for (int32_t t = V - 1; t >= 0; --t) {
    const int32_t u = w.pos[t], n = w.start[u + 1] - w.start[u];
    if (n == 0) continue;
    if (n > 1)
      solve_row<32>(c, u, lane == 0);
    else
      solve_row<1>(c, u, lane == 0);
    __syncwarp();
  }
  if (lane == 0 && (cursor > cap || top > n_sweeps))
    to_branch(flags, jacobi, b, cursor > cap ? 1 : 2);
}

// ----------------------------------------------------------------------
// The Jacobi branch.

// One buffer of the distance loop's state.
struct State {
  int64_t *s, *a, *nz, *tot, *rank;
  int32_t* eid;
};

// A contig's workspace: two state buffers, then the CSR.
struct Work {
  State st[2];
  int32_t* start;  // V + 1 row starts
  int32_t* inv;    // V flags: an invalid edge leaves the vertex
  int32_t* eidx;   // E edge indices sorted by eu
};

__host__ __device__ int64_t work_bytes(int32_t V, int64_t E) {
  const int64_t bytes = 80 * (int64_t)V + 4 * (4 * (int64_t)V + 1 + E);
  return (bytes + 7) / 8 * 8;
}

bool work_in_smem(int32_t V, int64_t E) {
  return work_bytes(V, E) <= kSmemBytes;
}

__device__ Work work_at(int64_t* base, int32_t V) {
  Work w;
  for (int k = 0; k < 2; ++k) {
    int64_t* p = base + 5 * (int64_t)V * k;
    w.st[k] = {p, p + V, p + 2 * V, p + 3 * V, p + 4 * V, nullptr};
  }
  int32_t* q = (int32_t*)(base + 10 * (int64_t)V);
  w.st[0].eid = q;
  w.st[1].eid = q + V;
  w.start = q + 2 * V;
  w.inv = w.start + V + 1;
  w.eidx = w.inv + V;
  return w;
}

// The edge's contribution to its tail's minima in one sweep: ok (the head
// is reached) and, if so, k1.
struct Cand {
  bool ok;
  int64_t k1;
};

__device__ __forceinline__ Cand cand(const State& o, int32_t v, int64_t es,
                                     int32_t ea) {
  const int64_t sv = o.s[v];
  if (sv >= kInf) return {false, kInf};
  return {true, pack_k1(add64(sv, es), add64(o.a[v], ea))};
}

__global__ void __launch_bounds__(kThreads)
relax64_kernel(const int32_t* __restrict__ eu_all,
               const int32_t* __restrict__ ev_all,
               const int64_t* __restrict__ es_all,
               const int32_t* __restrict__ ea_all,
               const int32_t* __restrict__ enz_all,
               const int32_t* __restrict__ etot_all,
               const int64_t* __restrict__ erank_all,
               const uint8_t* __restrict__ evalid_all,
               const int32_t* __restrict__ dest_all, int64_t B, int64_t E,
               int32_t V, int32_t n_sweeps, const int* __restrict__ flags,
               int64_t* __restrict__ work, int64_t* __restrict__ out,
               int32_t* __restrict__ out_eid) {
  extern __shared__ int64_t sm[];
  const int64_t b = blockIdx.x;
  const int flag = flags[b];
  if (!flag) return;  // the pass solved this contig
  const bool dist_done = flag == 2;  // the pass's distance is in out
  const int tid = threadIdx.x;
  const int32_t* eu = eu_all + b * E;
  const int32_t* ev = ev_all + b * E;
  const int64_t* es = es_all + b * E;
  const int32_t* ea = ea_all + b * E;
  const int32_t* enz = enz_all + b * E;
  const int32_t* etot = etot_all + b * E;
  const int64_t* erank = erank_all + b * E;
  const uint8_t* evalid = evalid_all + b * E;
  const int32_t dest = dest_all[b];
  const Work w =
      work_at(work ? work + b * (work_bytes(V, E) / 8) : sm, V);
  int32_t* start = w.start;

  // --- the CSR of the valid edges by eu ----------------------------------
  for (int32_t v = tid; v <= V; v += kThreads) start[v] = 0;
  for (int32_t v = tid; v < V; v += kThreads) w.inv[v] = 0;
  __syncthreads();
  for (int64_t e = tid; e < E; e += kThreads) {
    const int32_t u = eu[e], v = ev[e];
    if (u < 0 || u >= V) continue;  // JAX's segment ops drop the edge
    if (!evalid[e])
      w.inv[u] = 1;
    else if (v >= 0 && v < V)
      atomicAdd(&start[u], 1);
  }
  __syncthreads();
  if (tid < 32) warp_scan(start, V + 1);
  __syncthreads();
  int32_t* cursor = w.st[1].eid;  // free until the first sweep
  for (int32_t v = tid; v < V; v += kThreads) cursor[v] = start[v];
  __syncthreads();
  for (int64_t e = tid; e < E; e += kThreads) {
    const int32_t u = eu[e], v = ev[e];
    if (evalid[e] && u >= 0 && u < V && v >= 0 && v < V)
      w.eidx[atomicAdd(&cursor[u], 1)] = (int32_t)e;
  }
  const int64_t BV = B * V;
  int64_t* o = out + b * V;
  for (int32_t v = tid; v < V; v += kThreads) {
    const State s0 = w.st[0];
    s0.s[v] = dist_done ? o[v] : v == dest ? 0 : kInf;
    s0.a[v] = dist_done ? o[BV + v] : 0;
    s0.nz[v] = s0.tot[v] = 0;
    s0.rank[v] = v == dest ? -1 : kInf;
    s0.eid[v] = -1;
  }
  __syncthreads();

  // --- distance to dest over (k1, k2, erank) -----------------------------
  int cur = 0;
  for (int32_t it = 0; it < (dist_done ? 0 : n_sweeps); ++it) {
    const State o = cur ? w.st[1] : w.st[0];
    const State n = cur ? w.st[0] : w.st[1];
    bool changed = false;
    for (int32_t u = tid; u < V; u += kThreads) {
      const int32_t lo = start[u], hi = start[u + 1];
      const int64_t id = w.inv[u] ? kInf : kSegMax;
      int64_t m1 = id, m2 = id, m3 = id;
      for (int32_t j = lo; j < hi; ++j) {
        const int32_t e = w.eidx[j];
        m1 = min64(m1, cand(o, ev[e], es[e], ea[e]).k1);
      }
      for (int32_t j = lo; j < hi; ++j) {
        const int32_t e = w.eidx[j], v = ev[e];
        const Cand c = cand(o, v, es[e], ea[e]);
        const int64_t k2 = c.ok && c.k1 == m1
            ? qul_key(add64(o.nz[v], enz[e]), add64(o.tot[v], etot[e]))
            : kInf;
        m2 = min64(m2, k2);
      }
      for (int32_t j = lo; j < hi; ++j) {
        const int32_t e = w.eidx[j], v = ev[e];
        const Cand c = cand(o, v, es[e], ea[e]);
        const bool on2 =
            c.ok && c.k1 == m1 &&
            qul_key(add64(o.nz[v], enz[e]), add64(o.tot[v], etot[e])) == m2;
        m3 = min64(m3, on2 ? erank[e] : kInf);
      }
      const int64_t su = o.s[u], au = o.a[u], nzu = o.nz[u], totu = o.tot[u];
      const int64_t ranku = o.rank[u];
      const int64_t cur1 = su < kInf ? pack_k1(su, au) : kInf;
      const int64_t cur2 = qul_key(nzu, totu);
      const bool better = m1 < cur1 ||
          (m1 == cur1 && (m2 < cur2 || (m2 == cur2 && m3 < ranku)));
      int32_t win = -1;  // the lowest edge index among the winners
      if (better) {
        for (int32_t j = lo; j < hi; ++j) {
          const int32_t e = w.eidx[j];
          if (o.s[ev[e]] < kInf && erank[e] == m3 && (win < 0 || e < win))
            win = e;
        }
      }
      int64_t ns = su, na = au, nnz = nzu, ntot = totu, nrank = ranku;
      int32_t neid = o.eid[u];
      if (win >= 0) {
        const int32_t v = ev[win];
        ns = add64(o.s[v], es[win]);
        na = add64(o.a[v], ea[win]);
        nnz = add64(o.nz[v], enz[win]);
        ntot = add64(o.tot[v], etot[win]);
        nrank = erank[win];
        neid = win;
        changed |= ns != su || na != au || nnz != nzu || ntot != totu ||
                   nrank != ranku || neid != o.eid[u];
      }
      n.s[u] = ns;
      n.a[u] = na;
      n.nz[u] = nnz;
      n.tot[u] = ntot;
      n.rank[u] = nrank;
      n.eid[u] = neid;
    }
    cur ^= 1;
    if (!__syncthreads_or(changed)) break;
  }
  const State d = cur ? w.st[1] : w.st[0];
  for (int32_t v = tid; v < (dist_done ? 0 : V); v += kThreads) {
    o[v] = d.s[v];
    o[BV + v] = d.a[v];
    o[2 * BV + v] = d.nz[v];
    o[3 * BV + v] = d.tot[v];
    out_eid[b * V + v] = d.eid[v];
  }

  // --- anomaly floor, then the two walk counts ----------------------------
  // in the other state buffer; d's s and a stay for cnt_min's edge test
  int64_t* const buf0 = cur ? w.st[0].s : w.st[1].s;
  int64_t* const buf1 = cur ? w.st[0].a : w.st[1].a;
  for (int loop = 0; loop < 3; ++loop) {
    for (int32_t v = tid; v < V; v += kThreads)
      buf0[v] = loop == 0 ? (v == dest ? 0 : kInf) : (v == dest ? 1 : 0);
    __syncthreads();
    int x = 0;
    for (int32_t it = 0; it < n_sweeps; ++it) {
      const int64_t* X = x ? buf1 : buf0;
      int64_t* Y = x ? buf0 : buf1;
      bool changed = false;
      for (int32_t u = tid; u < V; u += kThreads) {
        const int32_t lo = start[u], hi = start[u + 1];
        int64_t nv;
        if (loop == 0) {
          int64_t m = w.inv[u] ? kInf : kSegMax;
          for (int32_t j = lo; j < hi; ++j) {
            const int32_t e = w.eidx[j];
            const int64_t fv = X[ev[e]];
            m = min64(m, fv < kInf ? add64(fv, ea[e]) : kInf);
          }
          nv = min64(X[u], m);
        } else {
          const int64_t du = d.s[u] < kInf ? pack_k1(d.s[u], d.a[u]) : kInf;
          int64_t sum = 0;
          for (int32_t j = lo; j < hi; ++j) {
            const int32_t e = w.eidx[j], v = ev[e];
            bool on = true;
            if (loop == 2) {
              const Cand c = cand(d, v, es[e], ea[e]);
              on = c.ok && c.k1 == du;
            }
            if (on) sum = add64(sum, X[v]);
          }
          nv = min64(add64(u == dest ? 1 : 0, sum), kCountSat);
        }
        changed |= nv != X[u];
        Y[u] = nv;
      }
      x ^= 1;
      if (!__syncthreads_or(changed)) break;
    }
    int64_t* ov = out + (4 + loop) * BV + b * V;
    const int64_t* X = x ? buf1 : buf0;
    for (int32_t v = tid; v < V; v += kThreads) ov[v] = X[v];
    __syncthreads();  // buf0 is rewritten by the next loop
  }
}

}  // namespace

// int64 words of global workspace the entry point needs per contig: 0 when
// the pass's and the Jacobi branch's workspaces both fit in shared memory,
// else the larger of the two (the launches run one after the other).
extern "C" int64_t aln_relax64_work_words(int32_t V, int64_t E) {
  if (pass_in_smem(V, E) && work_in_smem(V, E)) return 0;
  const int64_t p = pass_bytes(V, E, pool_entries(V, E)), j = work_bytes(V, E);
  return (p > j ? p : j) / 8;
}

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launches.  `evalid` is (B, E) bytes
// (torch.bool); `order` the (B, V) hint or null (the identity).  `out` is
// (7, B, V) int64:
// d_s, d_a, d_nz, d_tot, floor_a, cnt_tot, cnt_min; `out_eid` (B, V)
// int32.  `flags` holds B int32 zeros: the pass sets flags[b] for each
// contig the Jacobi branch must solve (1: all of it, 2: the floor and the
// counts) and adds their number to the one int32 at `jacobi` unless that
// is null.  `work` holds aln_relax64_work_words(V, E) * B int64 (null when
// that is 0).
extern "C" int aln_relax64(int device, const int32_t* eu, const int32_t* ev,
                           const int64_t* es, const int32_t* ea,
                           const int32_t* enz, const int32_t* etot,
                           const int64_t* erank, const uint8_t* evalid,
                           const int32_t* dest, const int32_t* order,
                           int64_t B, int64_t E, int32_t V, int32_t n_sweeps,
                           int* flags, int32_t* jacobi,
                           int64_t* work, int64_t* out, int32_t* out_eid,
                           void* stream) {
  if (V < 1 || V > kMaxV || E < 1 || E > 0x7fffffff || n_sweeps < 0 ||
      B < 0 || B > 0x7fffffff ||
      (work == nullptr) != (aln_relax64_work_words(V, E) == 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool pass_smem = pass_in_smem(V, E);
  const int64_t cap = pool_entries(V, E);
  const size_t psmem = pass_smem ? (size_t)pass_bytes(V, E, cap) : 0;
  int64_t* pwork = pass_smem ? nullptr : work;
  if (psmem > 48 * 1024) {
    rc = cudaFuncSetAttribute(relax64_pass_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)psmem);
    if (rc != cudaSuccess) return (int)rc;
  }
  relax64_pass_kernel<<<(unsigned)B, kPassThreads, psmem, st>>>(
      eu, ev, es, ea, enz, etot, erank, evalid, dest, order, B, E, V,
      n_sweeps, (int32_t)cap, flags, jacobi, pwork, out, out_eid);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  // the Jacobi branch: every CTA whose contig the pass flagged
  const bool jac_smem = work_in_smem(V, E);
  const size_t jsmem = jac_smem ? (size_t)work_bytes(V, E) : 0;
  if (jsmem > 48 * 1024) {
    rc = cudaFuncSetAttribute(relax64_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)jsmem);
    if (rc != cudaSuccess) return (int)rc;
  }
  relax64_kernel<<<(unsigned)B, kThreads, jsmem, st>>>(
      eu, ev, es, ea, enz, etot, erank, evalid, dest, B, E, V, n_sweeps, flags,
      jac_smem ? nullptr : work, out, out_eid);
  return (int)cudaGetLastError();
}
