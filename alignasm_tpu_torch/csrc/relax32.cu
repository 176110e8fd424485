// int32 sparse relaxation of the Python plane: (B, E) edge lists -> the five
// per-vertex vectors of a contig, (B, 5, V) [d_s, d_a, floor_a, cnt_tot,
// cnt_min].
//
// Replaces the XLA kernel alignasm_tpu/ops/relax32.py:sp_batch32 (:37), which
// the Python plane runs for its int32 buckets whose V is above dense_max_v
// (the 512-vertex buckets of long contigs) or that a dense cell cannot hold.
//
// Four loops in order, each n_sweeps Jacobi sweeps, as in the JAX function:
// the lex-min (sum, anom) to dest, the anomaly floor, the walk count and the
// count of min walks (over the (sum, anom)-achieving edges), counts saturated
// at COUNT_SAT.  A loop stops once a sweep changes nothing (the next state is
// a function of the current one only, so the result equals the full
// n_sweeps).
//
// Layout: one CTA per contig, its threads striding over the E edges.  The
// state and the per-sweep segment results live in shared memory (4V words):
// the segment minima are shared-memory atomicMin in two passes (score, then
// anomaly among the score-achievers), the sums atomicAdd, then one pass over
// the vertices applies the update.  Every value is an integer, so the result
// does not depend on the order of the atomics.  A vertex no edge leaves keeps
// segment_min's identity 2^31 - 1; padded edges (eu = ev = 0, evalid false)
// feed INF32 to vertex 0's minima and nothing to its sums, as in JAX.
//
// What bounds it: device memory.  Each loop is a DAG dynamic program that one
// reverse-topological pass over the edges computes (about 29 integer
// operations an edge over the four loops); the edge lists (17 bytes an edge)
// are read once.  This kernel instead runs up to the graph's depth plus one
// sweeps a loop, each rereading the edges from L2 with an atomic per edge and
// pass and three barriers, one CTA per contig: latency holds it far from the
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int32_t kCountSat = 10001;
constexpr int32_t kI32Max = 0x7fffffff;
constexpr int kMaxV = 8192;  // 4V words of shared memory = 128 KB
constexpr int kThreads = 256;

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
               int32_t n_sweeps, int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  int32_t* s = sm;          // d_s
  int32_t* a = sm + V;      // d_a
  int32_t* x = sm + 2 * V;  // m1 | fa | count
  int32_t* y = sm + 3 * V;  // m2 | segment min | segment sum

  const int64_t b = blockIdx.x;
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

}  // namespace

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launch.  `evalid` is (B, E) bytes
// (torch.bool).
extern "C" int aln_relax32(int device, const int32_t* eu, const int32_t* ev,
                           const int32_t* es, const int32_t* ea,
                           const uint8_t* evalid, const int32_t* dest,
                           int64_t B, int64_t E, int32_t V, int32_t n_sweeps,
                           int32_t* out, void* stream) {
  if (V < 1 || V > kMaxV || E < 1 || n_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)4 * V * sizeof(int32_t);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(relax32_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  relax32_kernel<<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
      eu, ev, es, ea, evalid, dest, E, V, n_sweeps, out);
  return (int)cudaGetLastError();
}
