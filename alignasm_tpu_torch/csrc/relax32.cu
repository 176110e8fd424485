// int32 sparse relaxation of the Python plane: (B, E) edge lists -> the five
// per-vertex vectors of a contig, (B, 5, V) [d_s, d_a, floor_a, cnt_tot,
// cnt_min].
//
// Replaces the XLA kernel alignasm_tpu/ops/relax32.py:sp_batch32 (:37), which
// the Python plane runs for its int32 buckets whose V is above dense_max_v
// (the 512-vertex buckets of long contigs) or that a dense cell cannot hold.
//
// The function is four loops in order, each n_sweeps Jacobi sweeps, as in
// the JAX function: the lex-min (sum, anom) to dest, the anomaly floor, the
// walk count and the count of min walks (over the (sum, anom)-achieving
// edges), counts saturated at COUNT_SAT.
//
// What bounds it: device memory.  Each loop is a DAG dynamic program that one
// reverse-topological pass over the edges computes; the edge lists (17 bytes
// an edge) are read once.
//
// Design: the checked pass of topo_pass.cuh, one CTA per contig.  Its
// threads counting-sort the contig's valid edges by eu into a CSR (counts by
// atomicAdd, an exclusive scan, a scatter of edge indices); padded edges
// (evalid false) are dropped there, and since every fold is an integer min
// or sum the sort's order does not matter.  Then one warp visits the
// vertices in reverse hint order (identity without a hint: a graph numbered
// topologically takes the pass, any other the Jacobi branch), its lanes on
// the vertex's out-edges 32 at a time, each batch gathered into a lane's
// column and stepped (topo::topo_step, NC = 1) with the batch before as its
// seed; a vertex without out-edges keeps its initial values.  The state (pos,
// L and the five vectors) and the CSR live in shared memory when they fit in
// kSmemBytes, else in a global workspace.  A contig that fails a check, or
// holds a valid edge whose eu or ev lies outside [0, V), takes the Jacobi
// branch in a second launch whose CTAs leave at once for the others.
//
// Jacobi branch: one CTA per contig, its threads striding over the E edges.
// The state and the per-sweep segment results live in shared memory (4V
// words): the segment minima are shared-memory atomicMin in two passes
// (score, then anomaly among the score-achievers), the sums atomicAdd, then
// one pass over the vertices applies the update.  Every value is an integer,
// so the result does not depend on the order of the atomics.  A vertex no
// edge leaves keeps segment_min's identity 2^31 - 1; padded edges (eu = ev =
// 0, evalid false) feed INF32 to vertex 0's minima and nothing to its sums,
// as in JAX.  A loop stops once a sweep changes nothing (the next state is a
// function of the current one only, so the result equals the full n_sweeps).

#include <cuda_runtime.h>
#include <stdint.h>

#include "topo_pass.cuh"

namespace {

using topo::kCountSat;
using topo::kFull;
using topo::kInf;
constexpr int32_t kI32Max = 0x7fffffff;
constexpr int kMaxV = 8192;  // 4V words of shared memory = 128 KB
constexpr int kThreads = 256;
constexpr int64_t kSmemBytes = 96 * 1024;  // the pass's shared workspace

__device__ __forceinline__ int32_t add32(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

__global__ void __launch_bounds__(kThreads)
relax32_kernel(const int32_t* __restrict__ eu_all,
               const int32_t* __restrict__ ev_all,
               const int32_t* __restrict__ es_all,
               const int32_t* __restrict__ ea_all,
               const uint8_t* __restrict__ evalid_all,
               const int32_t* __restrict__ dest_all, int64_t E, int32_t V,
               int32_t n_sweeps, const int32_t* __restrict__ flags,
               int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  int32_t* s = sm;          // d_s
  int32_t* a = sm + V;      // d_a
  int32_t* x = sm + 2 * V;  // m1 | fa | count
  int32_t* y = sm + 3 * V;  // m2 | segment min | segment sum

  const int64_t b = blockIdx.x;
  if (!flags[b]) return;  // the pass solved this contig
  const int32_t* eu = eu_all + b * E;
  const int32_t* ev = ev_all + b * E;
  const int32_t* es = es_all + b * E;
  const int32_t* ea = ea_all + b * E;
  const uint8_t* evalid = evalid_all + b * E;
  const int32_t dest = dest_all[b];
  const int tid = threadIdx.x;
  int32_t* o = out + b * 5 * V;

  for (int v = tid; v < V; v += blockDim.x) {
    s[v] = v == dest ? 0 : kInf;
    a[v] = 0;
  }
  __syncthreads();

  // --- (sum, anom) lexicographic min to dest ---------------------------
  int it = 0;
  while (it < n_sweeps) {
    for (int v = tid; v < V; v += blockDim.x) x[v] = y[v] = kI32Max;
    __syncthreads();
    for (int64_t e = tid; e < E; e += blockDim.x) {
      const int32_t sv = s[ev[e]];
      const bool ok = evalid[e] && sv < kInf;
      atomicMin(&x[eu[e]], ok ? add32(sv, es[e]) : kInf);
    }
    __syncthreads();
    for (int64_t e = tid; e < E; e += blockDim.x) {
      const int32_t u = eu[e], v = ev[e];
      const int32_t sv = s[v];
      const bool ok = evalid[e] && sv < kInf;
      const int32_t k1 = ok ? add32(sv, es[e]) : kInf;
      const bool on = ok && k1 == x[u];
      atomicMin(&y[u], on ? add32(a[v], ea[e]) : kInf);
    }
    __syncthreads();
    bool changed = false;
    for (int v = tid; v < V; v += blockDim.x) {
      const int32_t m1 = x[v], m2 = y[v];
      if (m1 < kInf && (m1 < s[v] || (m1 == s[v] && m2 < a[v]))) {
        s[v] = m1;
        a[v] = m2;
        changed = true;
      }
    }
    ++it;
    if (!__syncthreads_or(changed)) break;
  }
  for (int v = tid; v < V; v += blockDim.x) {
    o[v] = s[v];
    o[V + v] = a[v];
  }

  // --- anomaly floor, then the two walk counts --------------------------
  for (int loop = 1; loop < 4; ++loop) {
    for (int v = tid; v < V; v += blockDim.x)
      x[v] = loop == 1 ? (v == dest ? 0 : kInf) : (v == dest ? 1 : 0);
    __syncthreads();
    it = 0;
    while (it < n_sweeps) {
      for (int v = tid; v < V; v += blockDim.x) y[v] = loop == 1 ? kI32Max : 0;
      __syncthreads();
      for (int64_t e = tid; e < E; e += blockDim.x) {
        const int32_t u = eu[e], v = ev[e];
        const bool valid = evalid[e];
        if (loop == 1) {
          const int32_t fv = x[v];
          atomicMin(&y[u], valid && fv < kInf ? add32(fv, ea[e]) : kInf);
        } else {
          bool on = valid;
          if (loop == 3)
            on = on && s[v] < kInf && add32(s[v], es[e]) == s[u] &&
                 add32(a[v], ea[e]) == a[u];
          if (on) atomicAdd(&y[u], x[v]);
        }
      }
      __syncthreads();
      bool changed = false;
      for (int v = tid; v < V; v += blockDim.x) {
        const int32_t nv = loop == 1
            ? min(x[v], y[v])
            : min(add32(v == dest ? 1 : 0, y[v]), kCountSat);
        changed |= nv != x[v];
        x[v] = nv;
      }
      ++it;
      if (!__syncthreads_or(changed)) break;
    }
    for (int v = tid; v < V; v += blockDim.x) o[(1 + loop) * V + v] = x[v];
    __syncthreads();  // x[] is rewritten by the next loop
  }
}

// int32 words of the pass's workspace per contig: pos, L, the five
// vectors, the CSR's V + 1 row starts and its edge indices.
__host__ __device__ int64_t work_words(int32_t V, int64_t E) {
  return 8 * (int64_t)V + 1 + E;
}

bool work_in_smem(int32_t V, int64_t E) {
  return work_words(V, E) * 4 <= kSmemBytes;
}

__global__ void __launch_bounds__(kThreads)
relax32_pass_kernel(const int32_t* __restrict__ eu_all,
                    const int32_t* __restrict__ ev_all,
                    const int32_t* __restrict__ es_all,
                    const int32_t* __restrict__ ea_all,
                    const uint8_t* __restrict__ evalid_all,
                    const int32_t* __restrict__ dest_all,
                    const int32_t* __restrict__ order_all, int64_t E,
                    int32_t V, int32_t n_sweeps,
                    int32_t* __restrict__ flags, int32_t* __restrict__ jacobi,
                    int32_t* __restrict__ work, int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  __shared__ int bad;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int32_t* eu = eu_all + b * E;
  const int32_t* ev = ev_all + b * E;
  const int32_t* es = es_all + b * E;
  const int32_t* ea = ea_all + b * E;
  const uint8_t* evalid = evalid_all + b * E;
  const int32_t* order = order_all ? order_all + b * V : nullptr;
  const int32_t dest = dest_all[b];
  int32_t* base = work ? work + b * work_words(V, E) : sm;
  const topo::Work w = topo::work_at(base, V);
  int32_t* start = base + 7 * V;  // V + 1 row starts
  int32_t* eidx = start + V + 1;  // edge indices sorted by eu
  int32_t* cursor = w.ct;         // the scatter's cursors, before the state

  if (tid == 0) bad = 0;
  for (int32_t v = tid; v <= V; v += kThreads) start[v] = 0;
  for (int32_t v = tid; v < V; v += kThreads) w.pos[v] = -1;
  __syncthreads();
  bool ok = topo::fill_pos(w.pos, order, V, tid, kThreads);
  for (int64_t e = tid; e < E; e += kThreads) {
    if (!evalid[e]) continue;
    const int32_t u = eu[e], v = ev[e];
    if (u < 0 || u >= V || v < 0 || v >= V)
      ok = false;
    else
      atomicAdd(&start[u], 1);
  }
  if (!ok) bad = 1;
  __syncthreads();
  if (bad) {
    if (tid < 32) topo::to_jacobi(flags, jacobi, b);
    return;
  }
  if (tid < 32) {  // exclusive scan of the V + 1 counts, a chunk a lane
    const int32_t per = (V + 1 + 31) / 32;
    const int32_t lo = min(lane * per, V + 1), hi = min(lo + per, V + 1);
    int32_t sum = 0;
    for (int32_t i = lo; i < hi; ++i) sum += start[i];
    int32_t incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int32_t run = incl - sum;
    for (int32_t i = lo; i < hi; ++i) {
      const int32_t c = start[i];
      start[i] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int32_t v = tid; v < V; v += kThreads) cursor[v] = start[v];
  __syncthreads();
  for (int64_t e = tid; e < E; e += kThreads) {
    if (evalid[e]) eidx[atomicAdd(&cursor[eu[e]], 1)] = (int32_t)e;
  }
  __syncthreads();
  topo::init_work(w, V, dest, tid, kThreads);
  __syncthreads();
  if (tid >= 32) return;

  // one warp: the vertices in reverse hint order
  if (lane == 0 && dest >= 0 && dest < V && start[dest + 1] == start[dest])
    w.pos[dest] = topo::kAlwaysReady;  // dest's row holds no edge
  __syncwarp();
  const int32_t limit = min(n_sweeps, V);
  bool failed = false;
  for (int32_t t = V - 1; t >= 0; --t) {
    const int32_t u = order ? order[t] : t;
    const int32_t lo = start[u], n = start[u + 1] - lo;
    if (n == 0) continue;  // its initial values, L = 0
    topo::Seed seed = topo::no_seed();
    topo::Row r;
    int32_t len = 0;
    for (int32_t j = 0; j < n; j += 32) {
      const int32_t e = j + lane < n ? eidx[lo + j + lane] : -1;
      const int32_t col[1] = {e >= 0 ? ev[e] : -1};
      const int32_t cell[1] = {e >= 0 ? topo::pack_edge(true, es[e], ea[e])
                                      : kInf};
      r = topo::work_step<1>(w, col, cell, t, seed, len);
      seed = topo::seed_of(r);
    }
    len = __reduce_max_sync(kFull, len);
    failed |= len > limit;  // recorded, not branched on (sweep_dense.cu)
    topo::store_row(w, u, dest, r, len);
    __syncwarp();
  }
  if (failed) return topo::to_jacobi(flags, jacobi, b);
  int32_t* o = out + b * 5 * V;
  const int32_t* vec[5] = {w.s, w.a, w.fa, w.ct, w.cm};
  for (int k = 0; k < 5; ++k)
    for (int32_t v = lane; v < V; v += 32) o[k * V + v] = vec[k][v];
}

}  // namespace

// int32 words of global workspace the entry point needs per contig (0 when
// the pass's workspace fits in shared memory).
extern "C" int64_t aln_relax32_work_words(int32_t V, int64_t E) {
  return work_in_smem(V, E) ? 0 : work_words(V, E);
}

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launches.  `evalid` is (B, E) bytes
// (torch.bool); `order` the (B, V) hint or null (the identity).  `flags`
// holds B int32 zeros: the kernel sets flags[b] = 1 for each contig that
// took the Jacobi branch, and adds their number to the one int32 at
// `jacobi` unless that is null.  `work` holds aln_relax32_work_words(V, E)
// * B int32 (null when that is 0).
extern "C" int aln_relax32(int device, const int32_t* eu, const int32_t* ev,
                           const int32_t* es, const int32_t* ea,
                           const uint8_t* evalid, const int32_t* dest,
                           const int32_t* order, int64_t B, int64_t E,
                           int32_t V, int32_t n_sweeps, int32_t* flags,
                           int32_t* jacobi, int32_t* work, int32_t* out,
                           void* stream) {
  if (V < 1 || V > kMaxV || E < 1 || E > 0x7fffffff || n_sweeps < 0 ||
      B < 0 || B > 0x7fffffff || (work == nullptr) != work_in_smem(V, E))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const size_t pass_smem = work ? 0 : (size_t)work_words(V, E) * 4;
  if (pass_smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(relax32_pass_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)pass_smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  relax32_pass_kernel<<<(unsigned)B, kThreads, pass_smem, st>>>(
      eu, ev, es, ea, evalid, dest, order, E, V, n_sweeps, flags, jacobi, work,
      out);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  // the Jacobi branch: every CTA whose contig the pass did not solve
  const size_t smem = (size_t)4 * V * sizeof(int32_t);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(relax32_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  relax32_kernel<<<(unsigned)B, kThreads, smem, st>>>(
      eu, ev, es, ea, evalid, dest, E, V, n_sweeps, flags, out);
  return (int)cudaGetLastError();
}
