// Top-K walk keys by Jacobi sweeps: a (B, V, V) int64 matrix of packed edge
// keys (score_sum << 16 | anom; INF = 2^62 or above: no edge) + a (B,) int32
// dest -> (B, V, K) int64 keys, each row the K smallest candidates in
// top_k's order.
//
// Replaces alignasm_tpu/ops/topk.py:topk_walks_batch (:35), an XLA function
// (a vmapped fori_loop over a dense broadcast and lax.top_k), a library
// entry point with no caller on the engine's paths.
//
// The function is n_sweeps literal Jacobi sweeps from `base` (INF, with a 0
// at [dest, 0]; a negative dest counts from the end there, as JAX's index
// does): cand[u, v*K + j] = wk1[u, v] + tk[v, j] where wk1[u, v] < INF, else
// INF; tk'[u] = the K smallest of cand[u] by top_k(-cand) (ascending, except
// that -2^63, whose negation wraps to itself, sorts last); dest's row (for
// a dest in [0, V)) is reset to [0, INF, ...] after every sweep.  The sums
// wrap as int64: every sum here is taken on uint64_t (signed overflow is
// undefined in C++, and a cycle, a self-loop or a negative key reaches it).
//
// What bounds it: device memory, one read of the B V^2 keys.  The least work
// is one reverse-topological pass of K adds and K compares per valid edge;
// the literal sweeps cost up to n_sweeps times that, from shared memory.
//
// Design, one CTA a contig (a simple, exact kernel; a one-pass design from a
// checked hint is later work):
//   1. compact: the warps read wk1 row by row, coalesced, eight 32-column
//      loads in flight a lane; a warp ballots the valid cells (wk1 < INF,
//      negative keys included) and keeps the first kRowCap of the row in
//      shared memory (column and key, in column order) with the row's
//      degree.  This is the only read of wk1 for a row of at most kRowCap
//      edges; a denser row reads its valid cells in place, each sweep.
//   2. sweeps: tk double-buffered in shared memory, rows of K | 1 words (an
//      odd stride: a warp's threads on one slot hit distinct banks); a
//      thread a vertex.  A row starts as K copies of its virtual candidates:
//      INF when its degree is under V (the (V - deg) K non-edge candidates,
//      at least K of them), else -2^63 (the order's last value, which any
//      real candidate ties or beats).  Each out-edge's child list, sorted,
//      plus the edge's key is a sorted run unless the sum wraps inside it
//      (then its first candidate orders after its last); a sorted run merges
//      into the row from the back in O(K) after counting the m candidates
//      that enter, a wrapped one goes in by insertion.  The result is the K
//      smallest multiset, whatever the order of the edges, so it equals
//      top_k's output bit for bit.  dest's row is written directly.
//   3. A sweep that changes no word of tk leaves every later sweep equal, so
//      the loop stops there (__syncthreads_or); the sweeps run, summed over
//      the contigs, are added to the caller's `sweeps` word when given.
// Shared memory: 16 V (K | 1) bytes of tk + V (10 kRowCap + 4) of edges and
// degrees, at most 227 KB: V <= 512 at K <= 17.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kInf = int64_t(1) << 62;
constexpr uint64_t kTop = uint64_t(1) << 63;  // also -2^63's bits
constexpr int kRowCap = 16;   // edges of a row kept in shared memory
constexpr int kUnroll = 8;    // 32-column loads in flight a lane
constexpr int kMaxThreads = 512;
// the opt-in limit of a block; it keeps V <= 1,291, so a uint16 holds a
// column
constexpr int64_t kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int row_stride(int32_t K) { return K | 1; }

__host__ __device__ inline int64_t smem_bytes(int32_t V, int32_t K) {
  return (int64_t)V * (16 * (int64_t)row_stride(K) + 10 * kRowCap + 4);
}

// top_k(-cand)'s order as an unsigned one: x - 1 as a signed int64
__device__ __forceinline__ uint64_t ord(uint64_t x) { return (x - 1) ^ kTop; }

// c into the sorted row r if it beats the row's last
__device__ __forceinline__ void insert(uint64_t* r, uint64_t c, int K) {
  const uint64_t oc = ord(c);
  if (oc >= ord(r[K - 1])) return;
  int p = K - 1;
  while (p > 0 && ord(r[p - 1]) > oc) {
    r[p] = r[p - 1];
    --p;
  }
  r[p] = c;
}

// The K smallest of row r (sorted) and key + L[j] (L a sorted child list).
__device__ __forceinline__ void merge_list(uint64_t* r, const uint64_t* L,
                                           uint64_t key, int K) {
  if (ord(key + L[0]) > ord(key + L[K - 1])) {
    // the sum wraps inside the list: not a sorted run
    for (int j = 0; j < K; ++j) insert(r, key + L[j], K);
    return;
  }
  int m = 0;  // candidates that enter: c[m] < the row's (K-1-m)-th
  while (m < K && ord(key + L[m]) < ord(r[K - 1 - m])) ++m;
  int i = K - m - 1, p = K - 1;
  for (int j = m - 1; j >= 0; --p) {
    const uint64_t c = key + L[j];
    if (i >= 0 && ord(r[i]) > ord(c)) {
      r[p] = r[i--];
    } else {
      r[p] = c;
      --j;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
topk_kernel(const int64_t* __restrict__ wk1, const int32_t* __restrict__ dest,
            int32_t V, int32_t K, int32_t n_sweeps, int* sweeps,
            int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KS = row_stride(K);
  uint64_t* cur = reinterpret_cast<uint64_t*>(smem);
  uint64_t* nxt = cur + (int64_t)V * KS;
  uint64_t* ekey = nxt + (int64_t)V * KS;
  int32_t* deg = reinterpret_cast<int32_t*>(ekey + (int64_t)V * kRowCap);
  uint16_t* ecol = reinterpret_cast<uint16_t*>(deg + V);
  const int64_t b = blockIdx.x;
  const int64_t* w = wk1 + b * V * V;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int32_t d = dest[b];
  const int32_t r0 = d < 0 ? d + V : d;  // base's 0, as JAX's index

  // 1. compact each row's valid cells
  for (int u = warp; u < V; u += nwarps) {
    const int64_t* row = w + (int64_t)u * V;
    int n = 0;
    for (int c0 = 0; c0 < V; c0 += 32 * kUnroll) {
      int64_t k[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int c = c0 + 32 * i + lane;
        k[i] = c < V ? __ldg(row + c) : kInf;
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const bool valid = k[i] < kInf;
        const unsigned mask = __ballot_sync(kFull, valid);
        const int pos = n + __popc(mask & ((1u << lane) - 1u));
        if (valid && pos < kRowCap) {
          ecol[u * kRowCap + pos] = (uint16_t)(c0 + 32 * i + lane);
          ekey[u * kRowCap + pos] = (uint64_t)k[i];
        }
        n += __popc(mask);
      }
    }
    if (lane == 0) deg[u] = n;
  }
  for (int i = tid; i < V * K; i += nthr) {
    const int u = i / K, j = i - u * K;
    cur[u * KS + j] = (j == 0 && u == r0) ? 0 : (uint64_t)kInf;
  }
  __syncthreads();

  // 2. the sweeps, stopped at the fixed point
  int ran = 0;
  for (int s = 0; s < n_sweeps; ++s) {
    int changed = 0;
    for (int u = tid; u < V; u += nthr) {
      uint64_t* r = nxt + u * KS;
      if (u == d) {
        r[0] = 0;
        for (int j = 1; j < K; ++j) r[j] = (uint64_t)kInf;
      } else {
        const int n = deg[u];
        const uint64_t fill = n < V ? (uint64_t)kInf : kTop;
        for (int j = 0; j < K; ++j) r[j] = fill;
        if (n <= kRowCap) {
          for (int e = 0; e < n; ++e)
            merge_list(r, cur + ecol[u * kRowCap + e] * KS,
                       ekey[u * kRowCap + e], K);
        } else {
          const int64_t* row = w + (int64_t)u * V;
          for (int v = 0; v < V; ++v) {
            const int64_t key = __ldg(row + v);
            if (key < kInf) merge_list(r, cur + v * KS, (uint64_t)key, K);
          }
        }
      }
      const uint64_t* old = cur + u * KS;
      for (int j = 0; j < K; ++j) changed |= r[j] != old[j];
    }
    ++ran;
    const int any = __syncthreads_or(changed);
    uint64_t* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }

  int64_t* o = out + b * V * K;
  for (int i = tid; i < V * K; i += nthr) {
    const int u = i / K, j = i - u * K;
    o[i] = (int64_t)cur[u * KS + j];
  }
  if (tid == 0 && sweeps != nullptr) atomicAdd(sweeps, ran);
}

}  // namespace

// Bytes of shared memory a block of the kernel takes at (V, K); a launch
// above 227 KB is refused.
extern "C" int64_t aln_topk_smem_bytes(int32_t V, int32_t K) {
  return smem_bytes(V, K);
}

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launch.  `wk1` is (B, V, V) int64,
// `dest` (B,) int32, `out` (B, V, K) int64; a negative n_sweeps runs none.
// Adds the sweeps run, summed over the contigs, to the one int32 at `sweeps`
// unless that is null.
extern "C" int aln_topk(int device, const int64_t* wk1, const int32_t* dest,
                        int64_t B, int32_t V, int32_t K, int32_t n_sweeps,
                        int* sweeps, int64_t* out, void* stream) {
  if (V < 1 || K < 1 || B < 0 || B > 0x7fffffff ||
      smem_bytes(V, K) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)smem_bytes(V, K);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(topk_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int threads = V >= kMaxThreads ? kMaxThreads : (V + 31) / 32 * 32;
  topk_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      wk1, dest, V, K, n_sweeps, sweeps, out);
  return (int)cudaGetLastError();
}
