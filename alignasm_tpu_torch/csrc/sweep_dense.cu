// Dense sweep solve of the Python plane: (B, V, V) score / anomaly matrices
// (or (B, V+1, V) packed slabs) -> the five per-vertex vectors of a contig.
//
// Replaces the TPU kernel alignasm_tpu/ops/dense.py:dense_solve_slabs_pallas
// (pallas_call at :701, body solve_slab :646 -> _solve_one :581) and the XLA
// dense_solve_batch (:564) that the Python plane runs for its dense buckets.
// One kernel body serves both entries:
//   batch: ws, wa (B, V, V), dest (B,); edge = ws < INF32; out (B, 5, V)
//          [d_s, d_a, floor_a, cnt_tot, cnt_min];
//   slabs: (B, V+1, V) cells score | anom << 28 (INF32 = no edge), row V
//          [dest, src]; out (B, 2V+4) [d_s, d_a, fa@src, ct@src, cm@src, src].
//
// Four loops of _solve_one in order, each n_sweeps Jacobi sweeps (a sweep
// reads only the previous sweep's vector): the lex-min (sum, anom) to dest
// (a min pass, then a min of the anomaly sums over the score-achieving
// edges), the anomaly floor, the walk count, and the count of min walks over
// the (sum, anom)-achieving edges, counts saturated at COUNT_SAT.  A loop
// stops once a sweep changes nothing: the next state is a function of the
// current one only, so every later sweep would return the same vector, and
// the result equals the full n_sweeps.
//
// Layout: one CTA per contig; the double-buffered state (s, a, and one vector
// that serves fa and both counts) in shared memory, 6V words; one warp per
// matrix row u at a time, its lanes on the row's columns (coalesced reads from
// global memory / L2), a shuffle reduction, lane 0 writing the new value.
//
// What bounds it: device memory.  Each loop is a DAG dynamic program that one
// reverse-topological pass over the cells computes (about 23 integer
// operations a cell over the four loops); the matrices (2 * B * V^2 * 4
// bytes, or (V+1) * V * 4 a slab) are read once.  This kernel instead runs
// up to the graph's depth plus one Jacobi sweeps a loop (the early stop cuts
// n_sweeps, a power of two above the longest contig's record count, to
// that), each rereading the V^2 cells from L2, so it is far from the bound.
//
// Arithmetic is the JAX package's int32 arithmetic, sums wrapping as there
// (add32), so the rows are bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int32_t kCountSat = 10001;
constexpr int kAnomShift = 28;
constexpr int32_t kScoreMask = (1 << kAnomShift) - 1;
constexpr int32_t kI32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxV = 8192;  // 6V words of shared memory = 192 KB
constexpr int kMaxWarps = 16;

__device__ __forceinline__ int32_t add32(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

__device__ __forceinline__ int32_t warp_min(int32_t x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int32_t warp_sum(int32_t x) {
  for (int o = 16; o > 0; o >>= 1) x = add32(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// One cell of row u, column v: edge flag, score, anomaly.
template <bool kPacked>
__device__ __forceinline__ bool cell(const int32_t* __restrict__ ws,
                                     const int32_t* __restrict__ wa,
                                     int64_t off, int32_t& sc, int32_t& an) {
  if (kPacked) {
    const int32_t x = ws[off];
    sc = x & kScoreMask;
    an = (int32_t)((uint32_t)x >> kAnomShift);
    return x != kInf;
  }
  sc = ws[off];
  an = wa[off];
  return sc < kInf;
}

template <bool kPacked>
__global__ void __launch_bounds__(32 * kMaxWarps)
sweep_dense_kernel(const int32_t* __restrict__ ws_all,
                   const int32_t* __restrict__ wa_all,
                   const int32_t* __restrict__ dest_all, int32_t V,
                   int32_t n_sweeps, int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  int32_t* s[2] = {sm, sm + V};
  int32_t* a[2] = {sm + 2 * V, sm + 3 * V};
  int32_t* x[2] = {sm + 4 * V, sm + 5 * V};

  const int64_t b = blockIdx.x;
  const int64_t VV = (int64_t)V * V;
  const int32_t* ws;
  const int32_t* wa = nullptr;
  int32_t dest, src = 0;
  if (kPacked) {
    ws = ws_all + b * (VV + V);
    dest = ws[VV];
    src = ws[VV + 1];
  } else {
    ws = ws_all + b * VV;
    wa = wa_all + b * VV;
    dest = dest_all[b];
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;

  for (int v = tid; v < V; v += blockDim.x) {
    s[0][v] = v == dest ? 0 : kInf;
    a[0][v] = 0;
  }
  __syncthreads();

  // --- (sum, anom) lexicographic min to dest ---------------------------
  int cur = 0, it = 0;
  while (it < n_sweeps) {
    const int32_t* sc_ = s[cur];
    const int32_t* ac_ = a[cur];
    bool changed = false;
    for (int32_t u = warp; u < V; u += nw) {
      const int32_t* wsr = ws + (int64_t)u * V;
      const int32_t* war = kPacked ? nullptr : wa + (int64_t)u * V;
      int32_t m1 = kI32Max;
      for (int32_t v = lane; v < V; v += 32) {
        int32_t w, an;
        const bool e = cell<kPacked>(wsr, war, v, w, an);
        m1 = min(m1, e ? add32(w, sc_[v]) : kInf);
      }
      m1 = warp_min(m1);
      int32_t m2 = kI32Max;
      for (int32_t v = lane; v < V; v += 32) {
        int32_t w, an;
        const bool e = cell<kPacked>(wsr, war, v, w, an);
        const bool on = e && add32(w, sc_[v]) == m1;
        m2 = min(m2, on ? add32(an, ac_[v]) : kInf);
      }
      m2 = warp_min(m2);
      if (lane == 0) {
        const int32_t su = sc_[u], au = ac_[u];
        const bool better = ((m1 < su) || (m1 == su && m2 < au)) && m1 < kInf;
        s[cur ^ 1][u] = better ? m1 : su;
        a[cur ^ 1][u] = better ? m2 : au;
        changed |= better;
      }
    }
    ++it;
    const int any = __syncthreads_or(changed);
    if (!any) break;  // s[cur ^ 1] == s[cur]: either is the result
    cur ^= 1;
  }
  const int32_t* sf = s[cur];
  const int32_t* af = a[cur];

  int32_t* o = kPacked ? out + b * (2 * V + 4) : out + b * 5 * V;
  for (int v = tid; v < V; v += blockDim.x) {
    o[v] = sf[v];
    o[V + v] = af[v];
  }

  // --- anomaly floor, then the two walk counts --------------------------
  for (int loop = 1; loop < 4; ++loop) {
    for (int v = tid; v < V; v += blockDim.x)
      x[0][v] = loop == 1 ? (v == dest ? 0 : kInf) : (v == dest ? 1 : 0);
    __syncthreads();
    cur = 0;
    it = 0;
    while (it < n_sweeps) {
      const int32_t* xc = x[cur];
      bool changed = false;
      for (int32_t u = warp; u < V; u += nw) {
        const int32_t* wsr = ws + (int64_t)u * V;
        const int32_t* war = kPacked ? nullptr : wa + (int64_t)u * V;
        int32_t r;
        if (loop == 1) {
          r = kI32Max;
          for (int32_t v = lane; v < V; v += 32) {
            int32_t w, an;
            const bool e = cell<kPacked>(wsr, war, v, w, an);
            r = min(r, e ? add32(an, xc[v]) : kInf);
          }
          r = warp_min(r);
        } else {
          const int32_t su = sf[u], au = af[u];
          r = 0;
          for (int32_t v = lane; v < V; v += 32) {
            int32_t w, an;
            bool e = cell<kPacked>(wsr, war, v, w, an);
            if (loop == 3)
              e = e && sf[v] < kInf && add32(w, sf[v]) == su &&
                  add32(an, af[v]) == au;
            r = add32(r, e ? xc[v] : 0);
          }
          r = warp_sum(r);
        }
        if (lane == 0) {
          const int32_t old = xc[u];
          const int32_t nv = loop == 1
              ? min(old, r)
              : min(add32(u == dest ? 1 : 0, r), kCountSat);
          x[cur ^ 1][u] = nv;
          changed |= nv != old;
        }
      }
      ++it;
      const int any = __syncthreads_or(changed);
      if (!any) break;
      cur ^= 1;
    }
    const int32_t* xf = x[cur];
    if (kPacked) {
      if (tid == 0) o[2 * V + loop - 1] = (src >= 0 && src < V) ? xf[src] : 0;
    } else {
      for (int v = tid; v < V; v += blockDim.x) o[(1 + loop) * V + v] = xf[v];
    }
    __syncthreads();  // x[] is rewritten by the next loop
  }
  if (kPacked && tid == 0) o[2 * V + 3] = src;
}

template <bool kPacked>
cudaError_t launch(const int32_t* ws, const int32_t* wa, const int32_t* dest,
                   int64_t B, int32_t V, int32_t n_sweeps, int32_t* out,
                   cudaStream_t stream) {
  const size_t smem = (size_t)6 * V * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        sweep_dense_kernel<kPacked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  const int warps = V < kMaxWarps ? V : kMaxWarps;
  sweep_dense_kernel<kPacked><<<(unsigned)B, 32 * warps, smem, stream>>>(
      ws, wa, dest, V, n_sweeps, out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launch.  packed != 0: `ws` holds
// (B, V+1, V) slabs and `wa`/`dest` are unused.
extern "C" int aln_sweep_dense(int device, const int32_t* ws, const int32_t* wa,
                               const int32_t* dest, int32_t packed, int64_t B,
                               int32_t V, int32_t n_sweeps, int32_t* out,
                               void* stream) {
  if (V < 1 || V > kMaxV || n_sweeps < 0) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  rc = packed ? launch<true>(ws, wa, dest, B, V, n_sweeps, out, st)
              : launch<false>(ws, wa, dest, B, V, n_sweeps, out, st);
  return (int)rc;
}
