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
// What bounds it: the sweeps.  Each loop is a DAG dynamic program that one
// reverse-topological pass could compute, reading the edge lists (36 bytes
// an edge) once; the Jacobi loops read them once a sweep.  The distance
// loop must stay literal: its k2 is a mediant, not monotone in the
// successor's key, and a row keeps its incumbent on ties, so the result
// after n_sweeps sweeps can differ from one pass over final values.
//
// Design: one CTA per contig.  Its threads counting-sort the contig's valid
// edges by eu into a CSR (counts by atomicAdd, an exclusive scan, a scatter
// of edge indices, as relax32.cu); a vertex that an invalid edge (padding,
// eu = ev = 0) leaves is flagged, since that edge feeds INF to the vertex's
// three minima as in JAX.  Then each sweep gives each thread whole vertices:
// it folds the vertex's out-edges (three passes: m1, then m2 over the
// m1-achievers, then m3 over the m2-achievers, with segment_min's identity
// INT64_MAX for a vertex no edge leaves), picks the winner with the lowest
// edge index among the ok edges whose erank equals m3, and writes the
// vertex's new state into the other of two state buffers.  The state (two
// buffers of five int64 vectors and the int32 eid) and the CSR live in
// shared memory when they fit in kSmemBytes, else in a global workspace.
// A loop stops once a sweep changes no word of the contig (the next state
// is a function of the current one only, so the result equals the full
// n_sweeps).  Every sum, shift and pack runs on uint64_t: the JAX and
// PyTorch int64 arithmetic wraps, signed overflow in C++ does not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kInf = int64_t(1) << 62;  // ops/relax.py INF
constexpr int64_t kSegMax = INT64_MAX;      // segment_min of no element
constexpr int64_t kCountSat = 10001;
constexpr int kAnomBits = 16;
constexpr int kQulBits = 30;
constexpr int64_t kQulOne = int64_t(1) << kQulBits;
constexpr int kMaxV = 8192;
constexpr int kThreads = 256;
constexpr int64_t kSmemBytes = 96 * 1024;

__device__ __forceinline__ int64_t add64(int64_t x, int64_t y) {
  return (int64_t)((uint64_t)x + (uint64_t)y);
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ int64_t pack_k1(int64_t s, int64_t a) {
  return (int64_t)(((uint64_t)s << kAnomBits) | (uint64_t)a);
}

// Floor division, as torch.div(rounding_mode="floor") and jnp's //.
__device__ __forceinline__ int64_t floor_div(int64_t x, int64_t y) {
  if (y == -1) return (int64_t)(0 - (uint64_t)x);
  const int64_t q = x / y;
  return (x % y != 0 && ((x < 0) != (y < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t qul_key(int64_t nz, int64_t tot) {
  const int64_t num = (int64_t)((uint64_t)nz << kQulBits);
  return (int64_t)((uint64_t)kQulOne -
                   (uint64_t)floor_div(num, tot == 0 ? 1 : tot));
}

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
               int32_t V, int32_t n_sweeps, int64_t* __restrict__ work,
               int64_t* __restrict__ out, int32_t* __restrict__ out_eid) {
  extern __shared__ int64_t sm[];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
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
  if (tid < 32) {  // exclusive scan of the V + 1 counts, a chunk a lane
    const int32_t per = (V + 1 + 31) / 32;
    const int32_t lo = min(lane * per, V + 1), hi = min(lo + per, V + 1);
    int32_t sum = 0;
    for (int32_t i = lo; i < hi; ++i) sum += start[i];
    int32_t incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
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
  int32_t* cursor = w.st[1].eid;  // free until the first sweep
  for (int32_t v = tid; v < V; v += kThreads) cursor[v] = start[v];
  __syncthreads();
  for (int64_t e = tid; e < E; e += kThreads) {
    const int32_t u = eu[e], v = ev[e];
    if (evalid[e] && u >= 0 && u < V && v >= 0 && v < V)
      w.eidx[atomicAdd(&cursor[u], 1)] = (int32_t)e;
  }
  for (int32_t v = tid; v < V; v += kThreads) {
    const State s0 = w.st[0];
    s0.s[v] = v == dest ? 0 : kInf;
    s0.a[v] = s0.nz[v] = s0.tot[v] = 0;
    s0.rank[v] = v == dest ? -1 : kInf;
    s0.eid[v] = -1;
  }
  __syncthreads();

  // --- distance to dest over (k1, k2, erank) -----------------------------
  int cur = 0;
  for (int32_t it = 0; it < n_sweeps; ++it) {
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
  const int64_t BV = B * V;
  int64_t* o = out + b * V;
  for (int32_t v = tid; v < V; v += kThreads) {
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

// int64 words of global workspace the entry point needs per contig (0 when
// the workspace fits in shared memory).
extern "C" int64_t aln_relax64_work_words(int32_t V, int64_t E) {
  return work_in_smem(V, E) ? 0 : work_bytes(V, E) / 8;
}

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launch.  `evalid` is (B, E) bytes
// (torch.bool).  `out` is (7, B, V) int64: d_s, d_a, d_nz, d_tot, floor_a,
// cnt_tot, cnt_min; `out_eid` (B, V) int32.  `work` holds
// aln_relax64_work_words(V, E) * B int64 (null when that is 0).
extern "C" int aln_relax64(int device, const int32_t* eu, const int32_t* ev,
                           const int64_t* es, const int32_t* ea,
                           const int32_t* enz, const int32_t* etot,
                           const int64_t* erank, const uint8_t* evalid,
                           const int32_t* dest, int64_t B, int64_t E,
                           int32_t V, int32_t n_sweeps, int64_t* work,
                           int64_t* out, int32_t* out_eid, void* stream) {
  if (V < 1 || V > kMaxV || E < 1 || E > 0x7fffffff || n_sweeps < 0 ||
      B < 0 || B > 0x7fffffff || (work == nullptr) != work_in_smem(V, E))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem = work ? 0 : (size_t)work_bytes(V, E);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(relax64_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  relax64_kernel<<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
      eu, ev, es, ea, enz, etot, erank, evalid, dest, B, E, V, n_sweeps, work,
      out, out_eid);
  return (int)cudaGetLastError();
}
