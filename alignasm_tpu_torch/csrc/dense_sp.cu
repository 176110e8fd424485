// Dense shortest-path fixed point with the full PafDistance tie-break: five
// (B, V, V) int32 edge matrices + a (B, 1, V) dest row -> six (B, 1, V) int32
// state rows [s, a, nz, tot, rank, win].
//
// Replaces the TPU kernel alignasm_tpu/ops/pallas_relax.py:dense_sp_pallas
// (pallas_call at :160, body _kernel :109, one sweep _sweep :61), a library
// entry point with no caller on the engine's paths.
//
// Each Jacobi sweep is _sweep literally: per row u, masked row minima in
// cascade over the columns v -- m1 of the score sums over the valid edges
// (ws < INF32 and s[v] < INF32), m2 of the anomaly sums over those achieving
// m1, m3 of the f32 mapq key -(cnz / max(ctot, 1)) over those achieving m2,
// m4 of the arrival rank over those achieving m3 -- then, over the cells
// achieving m4, the minima of cnz and ctot and the lowest column (V if none);
// the row takes them when they beat its state in the same lexicographic
// order.  The f32 key uses IEEE division (__fdiv_rn) and round-to-nearest
// conversions, never fast math, so it equals the CPU's bit for bit; keys
// compare with < and == as in JAX (-0.0 == 0.0).  The loop stops once a sweep
// changes no state word, which equals running all n_sweeps.
//
// Layout: one CTA per contig; the double-buffered state (6 vectors x 2) in
// shared memory, 12V words; one warp per row u at a time, its lanes on the
// columns, five passes over the row (the cascade), each a shuffle reduction.
//
// What bounds it: device memory.  The fixed point is a DAG dynamic program
// that one reverse-topological pass of the five-pass cascade computes (about
// 40 operations a cell, one f32 division); the five matrices (20 * B * V^2
// bytes) are read once.  This kernel instead runs up to the graph's depth
// plus one sweeps, each rereading the rows from L2, far from the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int32_t kI32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxV = 4096;  // 12V words of shared memory = 192 KB
constexpr int kMaxWarps = 16;

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
                int32_t n_sweeps, int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  State st[2];
  for (int k = 0; k < 2; ++k) {
    int32_t* p = sm + k * 6 * V;
    st[k] = State{p, p + V, p + 2 * V, p + 3 * V, p + 4 * V, p + 5 * V};
  }
  const int64_t b = blockIdx.x;
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

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launch.  `out` is (6, B, 1, V) int32.
extern "C" int aln_dense_sp(int device, const int32_t* ws, const int32_t* wa,
                            const int32_t* wnz, const int32_t* wtot,
                            const int32_t* wrank, const int32_t* dest,
                            int64_t B, int32_t V, int32_t n_sweeps,
                            int32_t* out, void* stream) {
  if (V < 1 || V > kMaxV || n_sweeps < 0) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)12 * V * sizeof(int32_t);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(dense_sp_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int warps = V < kMaxWarps ? V : kMaxWarps;
  dense_sp_kernel<<<(unsigned)B, 32 * warps, smem, (cudaStream_t)stream>>>(
      ws, wa, wnz, wtot, wrank, dest, V, n_sweeps, out);
  return (int)cudaGetLastError();
}
