// Edge-sharded int64 distance-to-sink: the graph axis of the device mesh.
//
// Replaces the XLA program of alignasm_tpu/parallel/mesh.py:40
// make_edge_sharded_sp (a shard_map'd fori_loop of n_sweeps Jacobi sweeps;
// each sweep merges per-vertex minima over the mesh in three lexicographic
// pmin rounds over (k1, qul, rank) and four pmin winner picks).  The plain
// version is alignasm_tpu_torch/parallel/mesh.py:edge_sharded_sp_plain,
// literal to those rounds.  The recurrence is ops/relax.py's distance loop
// (the same keys, tie-break and strict-improvement incumbent); only the
// winner differs: each payload field is the minimum over the edges whose
// whole key ties, and a row takes it only below INF.
//
// What bounds it: dependent steps.  The function reads each edge once
// (37 bytes) and writes four words a vertex, ~2 MB for the giant contig of
// chip_smoke.py, 0.001 ms at the card's memory rate; but a vertex can be
// final only after its successors, and the rounds pay a sweep's launches,
// copies and waits n_sweeps times (~15 us a sweep on one card, ~108 us on
// four: PERF.md).  Two routes, both on the first device's side:
//
// 1. The checked pass (aln_shard_pass), the default.  The wrapper gathers
//    every shard's valid edges to the first device once a call (a peer
//    copy of ~1.8 MB for the giant contig), sorts them into one CSR by
//    tail and derives the hint, a reverse Kahn order, from erank's high
//    bits on the card (as scheduler.topo_hint does on the host).  Three
//    launches of a thread a vertex check (a) the hint is a permutation of
//    0..V-1 and every valid edge (u, v) lies in [0, V)^2 with pos[v] >
//    pos[u], or v is dest while dest's own row holds no edge; then one
//    warp, alone in its launch so that each thread may hold 255
//    registers (in a 1,024-thread CTA it spilled), replays each vertex's
//    change history in reverse hint order (replay.cuh's replay_row, shared
//    with relax64.cu, exact at any n_sweeps), and
//    (d) the history pool (`cap` entries in device memory, a 64-byte
//    record each, so that walking a successor's list and reading its
//    state take one cache line an entry) must hold every entry.
//    relax64.cu's check (c), a longest path of at least 3/4 of the rows,
//    is not made: it weighed the pass against Jacobi loops of one launch;
//    here a sweep of the rounds costs ~12-17 us on one card and ~108 us on
//    four against a row's ~2.2 us, so the pass is slower only for a DAG
//    of more than ~6 rows a level on one card (~50 on four); the giant
//    contig of chip_smoke.py has 1.2 (PERF.md).  Every index and pool
//    offset is int64.  A contig that fails (a) or (d), or whose gathered edges
//    and pool do not fit the first device's free memory (the wrapper's
//    test), takes the rounds.
// 2. The sharded Jacobi rounds (aln_shard_relax).  Each shard is one mesh
//    entry's slice of the contig's padded edge arrays, on that entry's
//    device, re-ordered on the card by the wrapper into a CSR of its
//    valid edges by source vertex u (`off`, V + 1 entries), with a byte a
//    vertex (`has`) telling whether the shard holds any edge of it, valid
//    or not.  Invalid edges add nothing to the fold but that byte, and the
//    padding's invalid edges all sit at vertex 0: one thread looping over
//    them cost 2 ms a sweep on the giant corpus (PERF.md).  One sweep is:
//      a. a local launch per shard (`local_kernel`, a thread a vertex)
//         that folds the vertex's edges of the shard into one
//         lexicographic minimum (k1, k2, rank) of its valid candidates,
//         with the winners' payload (s, a, nz, tot: the minimum of each
//         over the edges that tie on the whole key), into the shard's
//         (7, V) `loc`;
//      b. a peer copy of a remote shard's `loc` to the mesh's first device;
//      c. a merge launch on the first device (`merge_kernel`) that takes
//         the lexicographic minimum over the shards, ties' payloads by
//         minimum, then the literal state update (better, got) of the
//         (5, V) state (s, a, nz, tot, rank), and writes the sweep's
//         index to a device word when any state word changed;
//      d. a peer copy of the state back to each remote shard's device
//         (not after the last sweep).
//    Fixpoint exit: every kCheck sweeps the host copies that word to
//    pinned memory behind an event and reads the previous check's copy
//    (so the card never waits for the host); it stops once a checked
//    sweep changed nothing.  That is exact: the next sweep's inputs are
//    then this sweep's, so every later sweep changes nothing either.
//    One merge a sweep replaces the seven: the literal rounds give the
//    same four outputs whenever each valid candidate's k1, k2 and rank and
//    each winner's payload lie below INF = 2^62 (a valid candidate extends
//    a finite distance by one edge: exporter scores are below 2^40,
//    anomaly, mapq and record counts are small, rank = Kahn position << 26
//    | index).  Then the literal m1 is the minimum k1 of the valid
//    candidates, or INF when the vertex has edges but none valid
//    (INT64_MAX, as segment_min of an empty segment, when no shard holds
//    an edge of it); m2 and m3 are the minimum k2 and rank among the tied
//    candidates, or the same INF / INT64_MAX; and each pick is the minimum
//    over the winners, which are exactly the candidates whose whole key
//    ties.  A shard with edges of u but no valid one contributes (INF,
//    INF, INF) and payload INF, a shard with none INT64_MAX throughout,
//    so the merge reproduces the fill values (tests/test_torch_mesh.py
//    emulates this fold and the pass against the literal rounds and the
//    JAX program, those cases included).  The host loops over the sweeps
//    in C, queueing every launch, copy and event without waiting but at
//    the checks.
// All int64 arithmetic wraps on uint64_t, as XLA's does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "replay.cuh"

namespace {

using namespace replay;

constexpr int kThreads = 256;
constexpr int kLoc = 7;    // m1, m2, m3, s, a, nz, tot
constexpr int kState = 5;  // s, a, nz, tot, rank
constexpr int64_t kCheck = 256;  // sweeps between two fixpoint checks
// The pass's pool: a 64-byte record an entry (replay.cuh's AoS), so that a
// successor's list and state come in one cache line an entry.
constexpr int kEntryWords = 8;
using Pool = AoS<kEntryWords>;

__device__ __forceinline__ bool lex_less(int64_t a1, int64_t a2, int64_t a3,
                                         int64_t b1, int64_t b2, int64_t b3) {
  return a1 < b1 || (a1 == b1 && (a2 < b2 || (a2 == b2 && a3 < b3)));
}

// ----------------------------------------------------------------------
// The checked pass.

// replay_row's Rule here: the edge-sharded program's winner.  Each payload
// field is the minimum, over the row's edges, of the field for a winner
// (reached, k1 == m1, k2 == m2, erank == m3) and INF for any other edge
// (an invalid edge of the row included: the fold's identity is then INF);
// the row takes it, with rank m3, only when its s is below INF.
struct PayloadMin {
  __device__ __forceinline__ void edge(int64_t, int32_t) {}

  template <int G>
  __device__ __forceinline__ bool pick(const Hist<int64_t, Pool>& h,
                                       int64_t lo,
                                       int64_t n, int lane, Fold& f,
                                       int64_t m1, int64_t m3, const St& one,
                                       bool one_ok, St& nx, int64_t& nr) {
    St w{kSegMax, kSegMax, kSegMax, kSegMax};
    bool off = f.ident == kInf, any = false;
    for (int64_t j = lane; j < n; j += G) {
      const int64_t k = lo + j;
      const bool one_row = G == 1 && n == 1;
      bool win = (one_row ? one_ok : h.cok[k] != 0) && h.erank[k] == m3;
      St cd{};
      if (win && one_row) {
        // the fold's only push: on m1 it is the m1-achiever whose key is
        // a1, and a1 == m2 is what a1_is_m2 tells, mostly without dividing
        cd = one;
        win = pack_k1(cd.s, cd.a) == m1 && f.a1_is_m2();
      } else if (win) {
        cd = cached_cand(h, k);
        win = pack_k1(cd.s, cd.a) == m1 &&
              qul_key(cd.nz, cd.tot) == f.m2_value();
      }
      if (win) {
        any = true;
        w.s = min64(w.s, cd.s);
        w.a = min64(w.a, cd.a);
        w.nz = min64(w.nz, cd.nz);
        w.tot = min64(w.tot, cd.tot);
      } else {
        off = true;
      }
    }
    w.s = group_min<G>(w.s);
    w.a = group_min<G>(w.a);
    w.nz = group_min<G>(w.nz);
    w.tot = group_min<G>(w.tot);
    off = group_min32<G>(off ? 0 : 1) == 0;
    any = group_min32<G>(any ? 0 : 1) == 0;
    if (off) {
      w.s = min64(w.s, kInf);
      w.a = min64(w.a, kInf);
      w.nz = min64(w.nz, kInf);
      w.tot = min64(w.tot, kInf);
    }
    if (!any || w.s >= kInf) return false;  // got
    nx = w;
    nr = m3;
    return true;
  }
};

// The pass's workspace in device memory: the pool of `cap` entries first
// (64-byte aligned records), then per vertex the first history entry and
// pos, and per edge the row's cache.
struct PassWork {
  int64_t *pool, *head, *cp;
  int32_t *pos, *cok;
};

__host__ __device__ int64_t pass_words(int32_t V, int64_t E, int64_t cap) {
  return kEntryWords * cap + (int64_t)V + E + ((int64_t)V + E + 1) / 2;
}

__host__ __device__ PassWork pass_at(int64_t* base, int32_t V, int64_t E,
                                     int64_t cap) {
  PassWork p;
  p.pool = base;
  p.head = p.pool + kEntryWords * cap;
  p.cp = p.head + V;
  p.pos = (int32_t*)(p.cp + E);
  p.cok = p.pos + V;
  return p;
}

// The pass's first three launches, a thread a vertex (or position): the
// outputs' and the lists' initial values; the hint's positions, flagging a
// vertex out of range or seen twice; every valid edge (u, v) in range and
// forward in the hint, or into dest while dest's row holds no edge (dest
// then never changes).  `flag` is set when check (a) fails.
__global__ void __launch_bounds__(kThreads)
shard_init_kernel(int32_t V, int32_t dest, int32_t* __restrict__ pos,
                  int64_t* __restrict__ head, int64_t* __restrict__ out) {
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  pos[v] = -1;
  head[v] = -1;
  out[v] = v == dest ? 0 : kInf;  // a row without edges keeps them
  out[V + v] = out[2 * (int64_t)V + v] = out[3 * (int64_t)V + v] = 0;
}

__global__ void __launch_bounds__(kThreads)
shard_order_kernel(const int32_t* __restrict__ order, int32_t V,
                   int32_t* __restrict__ pos, int32_t* __restrict__ flag) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= V) return;
  const int32_t v = order[t];
  if (v < 0 || v >= V || atomicExch(&pos[v], (int32_t)t) != -1) *flag = 1;
}

__global__ void __launch_bounds__(kThreads)
shard_edges_kernel(const int64_t* __restrict__ start,
                   const int32_t* __restrict__ ev, int32_t V, int32_t dest,
                   const int32_t* __restrict__ pos,
                   int32_t* __restrict__ flag) {
  const int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u >= V || *flag) return;
  const bool dest_free = start[dest + 1] == start[dest];
  const int32_t pu = pos[u];
  for (int64_t k = start[u], hi = start[u + 1]; k < hi; ++k) {
    const int32_t v = ev[k];
    if (v < 0 || v >= V || (!(v == dest && dest_free) && pos[v] <= pu))
      *flag = 1;
  }
}

// The rows, one warp (the whole register file a thread), in reverse hint
// order, unless check (a) failed; `flag` is set when (d) fails.
__global__ void __launch_bounds__(32)
shard_rows_kernel(const int64_t* __restrict__ start,
                  const int32_t* __restrict__ ev,
                  const int64_t* __restrict__ es,
                  const int32_t* __restrict__ ea,
                  const int32_t* __restrict__ enz,
                  const int32_t* __restrict__ etot,
                  const int64_t* __restrict__ erank,
                  const int32_t* __restrict__ inv,
                  const int32_t* __restrict__ order, int32_t V, int64_t E,
                  int32_t dest, int32_t limit, int64_t cap,
                  int64_t* __restrict__ work, int32_t* __restrict__ flag,
                  int64_t* __restrict__ out) {
  __shared__ int64_t cursor;
  if (*flag) return;
  const int lane = threadIdx.x;
  if (lane == 0) cursor = 0;
  __syncwarp();
  const PassWork p = pass_at(work, V, E, cap);
  Hist<int64_t, Pool> h;
  h.ev = ev;
  h.ea = ea;
  h.enz = enz;
  h.etot = etot;
  h.inv = inv;
  h.es = es;
  h.erank = erank;
  h.cp = p.cp;
  h.head = p.head;
  h.cok = p.cok;
  h.hs = p.pool;
  h.ha = p.pool + 1;
  h.hnz = p.pool + 2;
  h.htot = p.pool + 3;
  h.hnext = p.pool + 4;
  h.htime = (int32_t*)(p.pool + 5);
  h.cursor = &cursor;
  h.cap = cap;
  h.dest = dest;
  h.limit = limit;
  PayloadMin rule;
  for (int64_t t0 = (int64_t)V - 1; t0 >= 0; t0 -= 32) {
    // the next 32 rows' vertex and CSR range, a lane each, loaded together
    // (no row's work depends on them)
    int32_t ul = 0;
    int64_t lol = 0, nl = 0;
    if (t0 - lane >= 0) {
      ul = order[t0 - lane];
      lol = start[ul];
      nl = start[ul + 1] - lol;
    }
    const int m = t0 < 31 ? (int)t0 + 1 : 32;
    for (int i = 0; i < m; ++i) {
      const int64_t n = __shfl_sync(kFull, nl, i);
      if (n == 0) continue;
      const int32_t u = __shfl_sync(kFull, ul, i);
      const int64_t lo = __shfl_sync(kFull, lol, i);
      int64_t rank, tail;
      const St x = n > 1
          ? replay_row<32>(h, u, lo, n, lane, lane == 0, rule, rank, tail)
          : replay_row<1>(h, u, lo, n, 0, lane == 0, rule, rank, tail);
      if (lane == 0) {
        out[u] = x.s;
        out[V + u] = x.a;
        out[2 * (int64_t)V + u] = x.nz;
        out[3 * (int64_t)V + u] = x.tot;
      }
      __syncwarp();
    }
  }
  if (lane == 0 && cursor > cap) *flag = 1;  // (d)
}

// ----------------------------------------------------------------------
// The sharded Jacobi rounds.

// One shard's fold: loc[j * V + u] for j = m1, m2, m3, s, a, nz, tot.
__global__ void __launch_bounds__(kThreads)
local_kernel(const int64_t* __restrict__ off, const int32_t* __restrict__ ev,
             const int64_t* __restrict__ es, const int32_t* __restrict__ ea,
             const int32_t* __restrict__ enz,
             const int32_t* __restrict__ etot,
             const int64_t* __restrict__ erank,
             const uint8_t* __restrict__ has,
             const int64_t* __restrict__ state, int32_t V,
             int64_t* __restrict__ loc) {
  const int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u >= V) return;
  const int64_t lo = off[u], hi = off[u + 1];
  int64_t t1 = kSegMax, t2 = kSegMax, t3 = kSegMax;
  int64_t ps = kSegMax, pa = kSegMax, pnz = kSegMax, ptot = kSegMax;
  if (has[u]) {  // edges but none valid: the literal rounds' INF fills
    t1 = t2 = t3 = kInf;
    ps = pa = pnz = ptot = kInf;
  }
  const int64_t* S = state;
  const int64_t* A = state + V;
  const int64_t* NZ = state + 2 * (int64_t)V;
  const int64_t* TOT = state + 3 * (int64_t)V;
  for (int64_t e = lo; e < hi; ++e) {
    int32_t v = ev[e];
    if (v < 0) v += V;  // a JAX gather wraps a negative index once,
    v = v < 0 ? 0 : (v >= V ? V - 1 : v);  // then clamps
    const int64_t sv = S[v];
    if (sv >= kInf) continue;
    const int64_t cs = add64(sv, es[e]), ca = add64(A[v], ea[e]);
    const int64_t cnz = add64(NZ[v], enz[e]), ctot = add64(TOT[v], etot[e]);
    const int64_t k1 = pack_k1(cs, ca), k2 = qul_key(cnz, ctot), k3 = erank[e];
    if (lex_less(k1, k2, k3, t1, t2, t3)) {
      t1 = k1; t2 = k2; t3 = k3;
      ps = cs; pa = ca; pnz = cnz; ptot = ctot;
    } else if (k1 == t1 && k2 == t2 && k3 == t3) {
      ps = min64(ps, cs); pa = min64(pa, ca);
      pnz = min64(pnz, cnz); ptot = min64(ptot, ctot);
    }
  }
  const int64_t out[kLoc] = {t1, t2, t3, ps, pa, pnz, ptot};
#pragma unroll
  for (int j = 0; j < kLoc; ++j) loc[j * (int64_t)V + u] = out[j];
}

// The merge over the n shards' folds on the first device, then the state
// update of mesh.py's step; `last` gets `sweep` when a state word changed.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const int64_t* const* __restrict__ locs, int32_t n, int32_t V,
             int64_t* __restrict__ state, int64_t sweep,
             int64_t* __restrict__ last) {
  const int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u >= V) return;
  int64_t m[kLoc];
  const int64_t* l0 = locs[0];
#pragma unroll
  for (int j = 0; j < kLoc; ++j) m[j] = l0[j * (int64_t)V + u];
  for (int k = 1; k < n; ++k) {
    const int64_t* l = locs[k];
    int64_t x[kLoc];
#pragma unroll
    for (int j = 0; j < kLoc; ++j) x[j] = l[j * (int64_t)V + u];
    if (lex_less(x[0], x[1], x[2], m[0], m[1], m[2])) {
#pragma unroll
      for (int j = 0; j < kLoc; ++j) m[j] = x[j];
    } else if (x[0] == m[0] && x[1] == m[1] && x[2] == m[2]) {
#pragma unroll
      for (int j = 3; j < kLoc; ++j) m[j] = min64(m[j], x[j]);
    }
  }
  int64_t* S = state;
  int64_t* A = state + V;
  int64_t* NZ = state + 2 * (int64_t)V;
  int64_t* TOT = state + 3 * (int64_t)V;
  int64_t* RK = state + 4 * (int64_t)V;
  const int64_t s = S[u], a = A[u], nz = NZ[u], tot = TOT[u], rk = RK[u];
  const int64_t cur1 = s < kInf ? pack_k1(s, a) : kInf;
  const int64_t cur2 = qul_key(nz, tot);
  const bool better = m[0] < cur1 || (m[0] == cur1 && m[1] < cur2) ||
                      (m[0] == cur1 && m[1] == cur2 && m[2] < rk);
  if (better && m[3] < kInf) {  // got
    if (m[3] != s || m[4] != a || m[5] != nz || m[6] != tot || m[2] != rk)
      *last = sweep;  // every writer of a sweep writes the same value
    S[u] = m[3]; A[u] = m[4]; NZ[u] = m[5]; TOT[u] = m[6]; RK[u] = m[2];
  }
}

inline unsigned grid_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// int64 words of the pass's workspace for V vertices, E valid edges and a
// pool of `cap` entries.
int64_t aln_shard_pass_work_words(int32_t V, int64_t E, int64_t cap) {
  return pass_words(V, E, cap);
}

// The checked pass over one contig on `stream` of CUDA device `device`:
// the CSR of its valid edges by tail (`start`, V + 1 int64 offsets; each
// edge's head and fields in CSR order), `inv` (V int32: an invalid edge
// leaves the vertex), the hint `order` (V int32), `work` of
// aln_shard_pass_work_words(V, E, cap) words, `flag` one int32 zero that
// the kernel sets to 1 when a check fails, `out` (4, V) int64: d_s, d_a,
// d_nz, d_tot.  Does not synchronise; returns cudaGetLastError() after
// the launch.
int aln_shard_pass(int device, const int64_t* start, const int32_t* ev,
                   const int64_t* es, const int32_t* ea, const int32_t* enz,
                   const int32_t* etot, const int64_t* erank,
                   const int32_t* inv, const int32_t* order, int32_t V,
                   int64_t E, int32_t dest, int64_t n_sweeps, int64_t cap,
                   int64_t* work, int32_t* flag, int64_t* out, void* stream) {
  if (V < 1 || E < 0 || dest < 0 || dest >= V || n_sweeps < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  // no change comes after sweep V (replay.cuh)
  const int32_t limit = (int32_t)(n_sweeps < V ? n_sweeps : V);
  cudaStream_t st = (cudaStream_t)stream;
  const PassWork p = pass_at(work, V, E, cap);
  shard_init_kernel<<<grid_for(V), kThreads, 0, st>>>(V, dest, p.pos, p.head,
                                                      out);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  shard_order_kernel<<<grid_for(V), kThreads, 0, st>>>(order, V, p.pos, flag);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  shard_edges_kernel<<<grid_for(V), kThreads, 0, st>>>(start, ev, V, dest,
                                                       p.pos, flag);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  shard_rows_kernel<<<1, 32, 0, st>>>(start, ev, es, ea, enz, etot, erank,
                                      inv, order, V, E, dest, limit, cap,
                                      work, flag, out);
  return (int)cudaGetLastError();
}

// One shard of the rounds, every field a device pointer or handle as an
// int64: its CUDA device and stream (shards on one device share one
// stream), the CSR offsets (V + 1) and valid edges' columns in CSR order,
// `has` (V bytes: the shard holds an edge of the vertex), the (5, V) state
// its local launch reads (the first device's own for a shard there, else
// a copy on its device), its (7, V) fold `loc`, and `loc0`, where the
// merge reads that fold on the first device (`loc` itself for a shard
// there).
struct AlnShard {
  int64_t device, stream, off, ev, es, ea, enz, etot, erank, has, state,
      loc, loc0;
};

// At most n_sweeps sweeps over the n shards (shard 0 on the first device,
// whose state is the merged one), stopping at the fixpoint.  `locs0` is a
// device array, on the first device, of the n `loc0` pointers; `last` one
// int64 there holding -1; `seen` two int64 of pinned host memory.  Queues
// every launch and copy without waiting, but for each check's event (and
// the last checks' copies before it returns); writes the number of sweeps
// run to `*swept`; returns the first error.
int aln_shard_relax(const AlnShard* shards, int32_t n, int32_t V,
                    int64_t n_sweeps, const int64_t* const* locs0,
                    int64_t* last, int64_t* seen, int64_t* swept) {
  *swept = 0;
  if (n < 1 || n > 64 || V < 1 || n_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  int caller_dev = 0;
  cudaError_t rc = cudaGetDevice(&caller_dev);
  if (rc != cudaSuccess) return (int)rc;
  const int dev0 = (int)shards[0].device;
  cudaStream_t st0 = (cudaStream_t)shards[0].stream;
  int64_t* state0 = (int64_t*)shards[0].state;
  const size_t loc_bytes = sizeof(int64_t) * kLoc * (size_t)V;
  const size_t state_bytes = sizeof(int64_t) * kState * (size_t)V;
  cudaEvent_t ev0 = nullptr, checks[2] = {};
  cudaEvent_t evs[64] = {};
  bool remote = false;
  for (int k = 0; k < n && rc == cudaSuccess; ++k) {
    if ((int)shards[k].device == dev0) continue;
    remote = true;
    if ((rc = cudaSetDevice((int)shards[k].device)) == cudaSuccess)
      rc = cudaEventCreateWithFlags(&evs[k], cudaEventDisableTiming);
  }
  if (rc == cudaSuccess) rc = cudaSetDevice(dev0);
  if (rc == cudaSuccess && remote)
    rc = cudaEventCreateWithFlags(&ev0, cudaEventDisableTiming);
  for (int c = 0; c < 2 && rc == cudaSuccess; ++c)
    rc = cudaEventCreateWithFlags(&checks[c], cudaEventDisableTiming);
  int pending = -1;           // the check whose copy is in flight
  int64_t pending_sweep = 0;  // the sweep it checks
  for (int64_t sweep = 0; sweep < n_sweeps && rc == cudaSuccess; ++sweep) {
    for (int k = 0; k < n && rc == cudaSuccess; ++k) {
      const AlnShard& sh = shards[k];
      const int dev = (int)sh.device;
      cudaStream_t st = (cudaStream_t)sh.stream;
      if ((rc = cudaSetDevice(dev)) != cudaSuccess) break;
      local_kernel<<<grid_for(V), kThreads, 0, st>>>(
          (const int64_t*)sh.off, (const int32_t*)sh.ev,
          (const int64_t*)sh.es, (const int32_t*)sh.ea,
          (const int32_t*)sh.enz, (const int32_t*)sh.etot,
          (const int64_t*)sh.erank, (const uint8_t*)sh.has,
          (const int64_t*)sh.state, V, (int64_t*)sh.loc);
      if ((rc = cudaGetLastError()) != cudaSuccess) break;
      if (dev == dev0) continue;
      rc = cudaMemcpyPeerAsync((void*)sh.loc0, dev0, (const void*)sh.loc, dev,
                               loc_bytes, st);
      if (rc == cudaSuccess) rc = cudaEventRecord(evs[k], st);
      if (rc == cudaSuccess) rc = cudaStreamWaitEvent(st0, evs[k], 0);
    }
    if (rc != cudaSuccess || (rc = cudaSetDevice(dev0)) != cudaSuccess) break;
    merge_kernel<<<grid_for(V), kThreads, 0, st0>>>(locs0, n, V, state0, sweep,
                                                    last);
    if ((rc = cudaGetLastError()) != cudaSuccess) break;
    *swept = sweep + 1;
    if (sweep + 1 == n_sweeps) break;
    if ((sweep + 1) % kCheck == 0) {
      // this sweep's check starts; the previous one is read (its copy has
      // had a window of sweeps to land), and a sweep that changed nothing
      // ends the rounds
      const int c = (int)((sweep + 1) / kCheck) & 1;
      rc = cudaMemcpyAsync(seen + c, last, sizeof(int64_t),
                           cudaMemcpyDeviceToHost, st0);
      if (rc == cudaSuccess) rc = cudaEventRecord(checks[c], st0);
      if (rc == cudaSuccess && pending >= 0 &&
          (rc = cudaEventSynchronize(checks[pending])) == cudaSuccess &&
          ((volatile int64_t*)seen)[pending] < pending_sweep)
        break;
      pending = c;
      pending_sweep = sweep;
      if (rc != cudaSuccess) break;
    }
    // the state goes back to the remote shards for the next sweep (not
    // after the last: the caller may free the state once the merge is done)
    if (!remote) continue;
    if ((rc = cudaEventRecord(ev0, st0)) != cudaSuccess) break;
    for (int k = 0; k < n && rc == cudaSuccess; ++k) {
      const AlnShard& sh = shards[k];
      if ((int)sh.device == dev0) continue;
      cudaStream_t st = (cudaStream_t)sh.stream;
      if ((rc = cudaSetDevice((int)sh.device)) != cudaSuccess) break;
      if ((rc = cudaStreamWaitEvent(st, ev0, 0)) != cudaSuccess) break;
      rc = cudaMemcpyPeerAsync((void*)sh.state, (int)sh.device, state0, dev0,
                               state_bytes, st);
    }
  }
  // the checks' copies land before `seen` may be freed; an event may be
  // destroyed while work that records it is pending
  for (int c = 0; c < 2; ++c)
    if (checks[c]) {
      cudaEventSynchronize(checks[c]);
      cudaEventDestroy(checks[c]);
    }
  for (int k = 0; k < n; ++k)
    if (evs[k]) cudaEventDestroy(evs[k]);
  if (ev0) cudaEventDestroy(ev0);
  cudaSetDevice(caller_dev);
  return (int)rc;
}

}  // extern "C"
