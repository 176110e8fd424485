// Blocked tropical triangular solve: (B, V+1, V) int32 slabs -> (B, V+2) int16
// gate rows [nxt (dest-encoded), fast, src], for Bk in {32, 64} and V a
// multiple of Bk up to 32767 (the main path sends 256 < V <= 8192).
//
// Replaces the TPU engine's big-V kernel alignasm_tpu/ops/dense.py:_blocked_dp
// / solve_slab_topo_nxt16_blocked (XLA), which the main path runs for every
// bucket with V > 256.  The rows are bit-equal to it and to the plain
// PyTorch version (ops/dense.py:solve_slab_topo_nxt16_blocked).
//
// Algorithm.  Vertices fall into nb = V/Bk diagonal blocks, solved last to
// first (edges point from low to high topo positions).  Block [lo, lo+Bk)
// needs, per row, a fold of its edges into the final tail columns
// (>= lo+Bk), then five scalar solves over the block's own (Bk, Bk) edges,
// each a log-depth closure: s (min-plus on scores), a (min-plus on
// anomalies over the s-achieving edges), fa (min-plus on anomalies), ct and
// cm (path counts saturated at 2, cm over the (s, a)-achieving edges).
//
// The JAX form reads three (Bk, V) panels per block step, one per dependent
// pass (s; a over the s-achievers; cm and nxt over the (s, a)-achievers).
// Here one fold per tail cell suffices: the tail's contribution to a row is
// the lexicographic minimum of (ws + s[c], wa + a[c]) over edges with
// s[c] < INF, with the saturated sum of cm[c] and the lowest c among the
// edges that attain it, plus min(wa + min(fa[c], INFA)) and the saturated
// sum of ct[c] over all edges.  Once the block's xs and xa are known, the
// JAX panels follow exactly: the s-achieving tail edges exist iff
// xs == the fold's s-minimum, and then their a-minimum is the fold's; the
// (s, a)-achievers exist iff xa also equals it, and then their cm sum and
// lowest index are the fold's.  Every quantity is a min, a saturated sum or
// a min index, so the fold is associative and order-free.
//
// Launches.  The fold is right-looking: when block j is final, one kernel
// folds its Bk columns into every row above it (rows < lo_j, spread over
// CTAs x contigs, one thread per row, 16-byte loads of the row's Bk cells),
// so each cell of the upper triangle is read once, at V = 8192 134 MB
// instead of the JAX form's 3 x 268 MB.  One CTA per contig then runs the
// next block's closures in shared memory.  The C entry point issues
// 2 * nb - 1 launches on the stream.
//
// Closures.  Min-plus: nlev = bit_length(Bk - 1) squarings of a (Bk, Bk)
// int32 matrix (entries clamped at INFH or INFAH, so every add stays below
// 2^31), each thread computing Bk*Bk/NT entries of one row with DPX
// add-min (__viaddmin_s32).  Counts: values in {0, 1, 2} are two bitmasks
// (>= 1, >= 2) per row and per column, and a saturated product entry is
//   m = x1[i] & y1[j];  0 if m == 0, else 2 if m has two bits or
//   x2[i] & y1[j] or x1[i] & y2[j], else 1
// which is exactly min(sum_k x[i,k] y[k,j], 2): O(Bk^2) word operations
// per product instead of O(Bk^3), exact integers (no tensor cores).
//
// What bounds it: at B = 1 the closures of one contig run on one SM, nb
// steps in sequence, so the sequential closure time (about 5 * nlev
// dependent Bk^3 / NT passes per step) and 2 * nb launch latencies bound it,
// not bytes: on an H100 (700 W) a step takes ~28 us at Bk = 32 and ~205 us
// at Bk = 64, nearly all of it the closures (PERF.md).  State (the five
// final vectors and the six fold vectors) lives in a global scratch buffer
// of 11 * B * V int32, L2-resident.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr int kAnomShift = 28;
constexpr int32_t kScoreMask = (1 << kAnomShift) - 1;
constexpr int32_t kInfH = kInf - (1 << kAnomShift);
constexpr int32_t kInfA = 1 << 20;
constexpr int32_t kInfAH = (1 << 20) - 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldThreads = 128;
constexpr int kInitThreads = 256;

// Scratch vectors, each (B, V) int32.
enum Vec {
  kS, kA, kFa, kCt, kCm,          // final DP values of solved columns
  kFoldS, kFoldA, kFoldCm, kFoldLow, kFoldFa, kFoldCt,  // per-row tail folds
  kNumVecs
};

template <int BK> struct Cfg;
template <> struct Cfg<32> {
  static constexpr int NT = 256;
  static constexpr int NLEV = 5;
  using Mask = unsigned;
};
template <> struct Cfg<64> {
  static constexpr int NT = 512;
  static constexpr int NLEV = 6;
  using Mask = unsigned long long;
};

__device__ __forceinline__ bool many(unsigned m) { return (m & (m - 1)) != 0; }
__device__ __forceinline__ bool many(unsigned long long m) {
  return (m & (m - 1)) != 0;
}

// min(sum_k x[i,k] * y[k,j], 2) from the >=1 / >=2 masks of row i of x and
// column j of y.
template <class Mask>
__device__ __forceinline__ int32_t sat_dot(Mask x1, Mask x2, Mask y1,
                                           Mask y2) {
  const Mask m = x1 & y1;
  if (!m) return 0;
  return (many(m) || (x2 & y1) || (x1 & y2)) ? 2 : 1;
}

__device__ __forceinline__ int32_t warp_min(int32_t x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <int BK> struct Smem {
  using Mask = typename Cfg<BK>::Mask;
  static constexpr int LD = BK + 4;  // 16-byte rows, rows i..i+3 on other banks
  int32_t R[BK * BK];          // the block's own cells, dest's row masked
  int32_t M[2][BK * LD];       // min-plus closure, ping-pong
  int32_t ps[BK], xs[BK], pa[BK], xa[BK], pf[BK], xf[BK];
  int32_t pct[BK], pcm[BK], xct[BK], xcm[BK];
  int32_t fold_s[BK], fold_a[BK], fold_cm[BK], fold_low[BK];  // rows' folds
  int32_t dcell[BK];           // cell (row, dest) when dest < lo, else INF
  Mask pr[2][2][BK], pc[2][2][BK], qr[2][2][BK], qc[2][2][BK];  // [buf][>=1,>=2]
};

// Mn = min(M (x) M, inf_h), min-plus.
template <int BK>
__device__ __forceinline__ void mp_square(const int32_t* __restrict__ M,
                                          int32_t* __restrict__ Mn,
                                          int32_t inf_h) {
  constexpr int NT = Cfg<BK>::NT, LD = Smem<BK>::LD;
  constexpr int R = BK * BK / NT;  // entries per thread, in one row: 4 or 8
  static_assert(R % 4 == 0, "whole int4 chunks per thread");
  constexpr int TPR = BK / R;
  const int i = threadIdx.x / TPR, j0 = (threadIdx.x % TPR) * R;
  int32_t acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = inf_h;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    const int32_t aik = M[i * LD + k];
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int4 b = *reinterpret_cast<const int4*>(M + k * LD + j0 + 4 * q);
      acc[4 * q] = __viaddmin_s32(aik, b.x, acc[4 * q]);
      acc[4 * q + 1] = __viaddmin_s32(aik, b.y, acc[4 * q + 1]);
      acc[4 * q + 2] = __viaddmin_s32(aik, b.z, acc[4 * q + 2]);
      acc[4 * q + 3] = __viaddmin_s32(aik, b.w, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    *reinterpret_cast<int4*>(Mn + i * LD + j0 + 4 * q) = make_int4(
        acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
}

// (I + A)^(2^NLEV) in min-plus, A(i, k) given by `init` for i != k; returns
// the shared buffer holding it.  Ends synchronised.
template <int BK, class F>
__device__ const int32_t* mp_closure(Smem<BK>& sm, F init, int32_t inf_h) {
  constexpr int NT = Cfg<BK>::NT, LD = Smem<BK>::LD;
  for (int e = threadIdx.x; e < BK * BK; e += NT) {
    const int i = e / BK, k = e % BK;
    sm.M[0][i * LD + k] = i == k ? 0 : init(i, k);
  }
  __syncthreads();
  int cur = 0;
  for (int lev = 0; lev < Cfg<BK>::NLEV; ++lev) {
    mp_square<BK>(sm.M[cur], sm.M[cur ^ 1], inf_h);
    __syncthreads();
    cur ^= 1;
  }
  return sm.M[cur];
}

// out[i] = min_k (M[i][k] + p[k]), one warp per row.  Ends synchronised.
template <int BK, class F>
__device__ void mp_apply(const int32_t* M, const int32_t* p, F finish) {
  constexpr int NW = Cfg<BK>::NT / 32, LD = Smem<BK>::LD;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < BK; i += NW) {
    int32_t x = INT_MAX;
    for (int k = lane; k < BK; k += 32) x = __viaddmin_s32(M[i * LD + k], p[k], x);
    x = warp_min(x);
    if (lane == 0) finish(i, x);
  }
  __syncthreads();
}

// Store a ballot as word w of a mask (w = 0 for Bk = 32).
template <class Mask>
__device__ __forceinline__ void put_word(Mask* m, int w, unsigned bits) {
  reinterpret_cast<unsigned*>(m)[w] = bits;
}

template <class Mask>
__device__ __forceinline__ int32_t bit(Mask m, int j) {
  return (int32_t)((m >> j) & 1);
}

// out[i] = min(sum_k P[i,k] p[k], 2) with P the saturated path-count
// closure of adj(i, k) (i != k): P = I, Q = adj, then NLEV times
// P' = min(P + Q P, 2), Q' = min(Q Q, 2).  Each level computes every entry
// twice, once row-major (ballots give row masks) and once column-major
// (ballots give column masks).  Ends synchronised.
template <int BK, class F>
__device__ void cnt_closure_apply(Smem<BK>& sm, F adj, const int32_t* p,
                                  int32_t* out) {
  using Mask = typename Cfg<BK>::Mask;
  constexpr int NT = Cfg<BK>::NT;
  const int lane = threadIdx.x & 31;
  // level 0: P = I, Q = adj
  for (int e = threadIdx.x; e < BK * BK; e += NT) {
    const int hi = e / BK, lo = e % BK;  // warps cover 32 consecutive `lo`
    const unsigned row = __ballot_sync(kFull, hi != lo && adj(hi, lo));
    const unsigned col = __ballot_sync(kFull, lo != hi && adj(lo, hi));
    if (lane == 0) {
      put_word(&sm.qr[0][0][hi], lo >> 5, row);  // row hi, columns lo
      put_word(&sm.qc[0][0][hi], lo >> 5, col);  // column hi, rows lo
      put_word(&sm.qr[0][1][hi], lo >> 5, 0u);
      put_word(&sm.qc[0][1][hi], lo >> 5, 0u);
      const unsigned diag = (hi >> 5) == (lo >> 5) ? 1u << (hi & 31) : 0u;
      put_word(&sm.pr[0][0][hi], lo >> 5, diag);
      put_word(&sm.pc[0][0][hi], lo >> 5, diag);
      put_word(&sm.pr[0][1][hi], lo >> 5, 0u);
      put_word(&sm.pc[0][1][hi], lo >> 5, 0u);
    }
  }
  __syncthreads();
  int cur = 0;
  for (int lev = 0; lev < Cfg<BK>::NLEV; ++lev) {
    const int nx = cur ^ 1;
    for (int e = threadIdx.x; e < BK * BK; e += NT) {
      const int hi = e / BK, lo = e % BK;
      // row-major: entry (hi, lo); column-major: entry (lo, hi)
#pragma unroll
      for (int layout = 0; layout < 2; ++layout) {
        const int i = layout == 0 ? hi : lo, j = layout == 0 ? lo : hi;
        const Mask q1 = sm.qr[cur][0][i], q2 = sm.qr[cur][1][i];
        const int32_t pij = bit(sm.pr[cur][0][i], j) + bit(sm.pr[cur][1][i], j);
        const int32_t qp = sat_dot(q1, q2, sm.pc[cur][0][j], sm.pc[cur][1][j]);
        const int32_t qq = sat_dot(q1, q2, sm.qc[cur][0][j], sm.qc[cur][1][j]);
        const int32_t np = min(pij + qp, 2);
        const unsigned p1 = __ballot_sync(kFull, np >= 1);
        const unsigned p2 = __ballot_sync(kFull, np >= 2);
        const unsigned q1n = __ballot_sync(kFull, qq >= 1);
        const unsigned q2n = __ballot_sync(kFull, qq >= 2);
        if (lane == 0) {
          Mask(*pm)[BK] = layout == 0 ? sm.pr[nx] : sm.pc[nx];
          Mask(*qm)[BK] = layout == 0 ? sm.qr[nx] : sm.qc[nx];
          put_word(&pm[0][hi], lo >> 5, p1);
          put_word(&pm[1][hi], lo >> 5, p2);
          put_word(&qm[0][hi], lo >> 5, q1n);
          put_word(&qm[1][hi], lo >> 5, q2n);
        }
      }
    }
    __syncthreads();
    cur = nx;
  }
  // out = min(P p, 2): p's masks over k by ballots (a 32-bit mask built by
  // a loop of scalar shifts came out 0 in the sm_90a -O3 build), then one
  // saturated dot per row, in the first BK / 32 warps
  if (threadIdx.x < BK) {
    Mask c1 = 0, c2 = 0;
#pragma unroll
    for (int h = 0; h < BK / 32; ++h) {
      const int32_t pk = p[32 * h + lane];
      c1 |= (Mask)__ballot_sync(kFull, pk >= 1) << (32 * h);
      c2 |= (Mask)__ballot_sync(kFull, pk >= 2) << (32 * h);
    }
    const int i = threadIdx.x;
    out[i] = sat_dot(sm.pr[cur][0][i], sm.pr[cur][1][i], c1, c2);
  }
  __syncthreads();
}

__device__ __forceinline__ int32_t* vec(int32_t* scratch, int v, int64_t B,
                                        int64_t b, int32_t V) {
  return scratch + ((int64_t)v * B + b) * V;
}

__global__ void __launch_bounds__(kInitThreads)
blocked_init_kernel(const int32_t* __restrict__ slabs, int32_t V, int64_t B,
                    int32_t* __restrict__ scratch, int16_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int32_t v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < V) {
    vec(scratch, kFoldS, B, b, V)[v] = kInf;  // no tail edge to a reachable column
    vec(scratch, kFoldA, B, b, V)[v] = kInf;
    vec(scratch, kFoldCm, B, b, V)[v] = 0;
    vec(scratch, kFoldLow, B, b, V)[v] = V;
    vec(scratch, kFoldFa, B, b, V)[v] = kInfA;
    vec(scratch, kFoldCt, B, b, V)[v] = 0;
  }
  if (v == 0) {
    const int32_t* slab = slabs + b * (V + 1) * V;
    int16_t* o = out + b * (V + 2);
    o[V] = 0;  // fast; set by the block holding src
    o[V + 1] = (int16_t)slab[(int64_t)V * V + 1];
  }
}

// Fold the solved columns [lo, lo+BK) into the folds of rows [0, lo).
template <int BK>
__global__ void __launch_bounds__(kFoldThreads)
blocked_fold_kernel(const int32_t* __restrict__ slabs, int32_t V, int64_t B,
                    int32_t lo, int32_t* __restrict__ scratch) {
  __shared__ int32_t cs[BK], ca[BK], ccm[BK], cfa[BK], cct[BK];
  const int64_t b = blockIdx.y;
  const int32_t* slab = slabs + b * (V + 1) * V;
  const int32_t dest = slab[(int64_t)V * V];
  for (int c = threadIdx.x; c < BK; c += blockDim.x) {
    cs[c] = vec(scratch, kS, B, b, V)[lo + c];
    ca[c] = vec(scratch, kA, B, b, V)[lo + c];
    ccm[c] = vec(scratch, kCm, B, b, V)[lo + c];
    cfa[c] = min(vec(scratch, kFa, B, b, V)[lo + c], kInfA);
    cct[c] = vec(scratch, kCt, B, b, V)[lo + c];
  }
  __syncthreads();
  const int32_t r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= lo || r == dest) return;  // dest's row is masked
  int32_t* f_s = vec(scratch, kFoldS, B, b, V) + r;
  int32_t* f_a = vec(scratch, kFoldA, B, b, V) + r;
  int32_t* f_cm = vec(scratch, kFoldCm, B, b, V) + r;
  int32_t* f_low = vec(scratch, kFoldLow, B, b, V) + r;
  int32_t* f_fa = vec(scratch, kFoldFa, B, b, V) + r;
  int32_t* f_ct = vec(scratch, kFoldCt, B, b, V) + r;
  int32_t best_s = *f_s, best_a = *f_a, best_cm = *f_cm, best_low = *f_low;
  int32_t min_fa = *f_fa, sum_ct = *f_ct;
  const int4* row = reinterpret_cast<const int4*>(slab + (int64_t)r * V + lo);
#pragma unroll 2
  for (int q = 0; q < BK / 4; ++q) {
    const int4 v4 = row[q];
    const int32_t cells[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int32_t cell = cells[u];
      if (cell == kInf) continue;
      const int c = 4 * q + u;
      const int32_t ws = cell & kScoreMask, wa = cell >> kAnomShift;
      if (cs[c] < kInf) {  // lexicographic (s, a) minimum, ties summed
        const int32_t s_ = ws + cs[c], a_ = wa + ca[c];
        if (s_ < best_s || (s_ == best_s && a_ < best_a)) {
          best_s = s_;
          best_a = a_;
          best_cm = ccm[c];
          best_low = lo + c;
        } else if (s_ == best_s && a_ == best_a) {
          best_cm = min(best_cm + ccm[c], 2);
          best_low = min(best_low, lo + c);
        }
      }
      min_fa = min(min_fa, wa + cfa[c]);
      sum_ct = min(sum_ct + cct[c], 2);
    }
  }
  *f_s = best_s;
  *f_a = best_a;
  *f_cm = best_cm;
  *f_low = best_low;
  *f_fa = min_fa;
  *f_ct = sum_ct;
}

// Solve block [lo, lo+BK) of every contig: one CTA per contig.
template <int BK>
__global__ void __launch_bounds__(Cfg<BK>::NT)
blocked_step_kernel(const int32_t* __restrict__ slabs, int32_t V, int64_t B,
                    int32_t lo, int32_t* __restrict__ scratch,
                    int16_t* __restrict__ out) {
  constexpr int NT = Cfg<BK>::NT, NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<BK>& sm = *reinterpret_cast<Smem<BK>*>(smem_raw);
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
  const int32_t* slab = slabs + b * (V + 1) * V;
  const int32_t dest = slab[(int64_t)V * V];
  const int32_t src = slab[(int64_t)V * V + 1];

  for (int e = t; e < BK * BK; e += NT) {
    const int i = e / BK, k = e % BK;
    sm.R[e] = lo + i == dest ? kInf : slab[(int64_t)(lo + i) * V + lo + k];
  }
  for (int i = t; i < BK; i += NT) {
    const int32_t r = lo + i;
    const bool on_dest = r == dest;
    const int32_t fs = vec(scratch, kFoldS, B, b, V)[r];
    sm.fold_s[i] = fs;
    sm.fold_a[i] = vec(scratch, kFoldA, B, b, V)[r];
    sm.fold_cm[i] = vec(scratch, kFoldCm, B, b, V)[r];
    sm.fold_low[i] = vec(scratch, kFoldLow, B, b, V)[r];
    sm.dcell[i] = dest >= 0 && dest < lo ? slab[(int64_t)r * V + dest] : kInf;
    sm.ps[i] = min(fs, on_dest ? 0 : kInf);
    sm.pf[i] = min(vec(scratch, kFoldFa, B, b, V)[r], on_dest ? 0 : kInfA);
    sm.pct[i] = min((on_dest ? 1 : 0) + vec(scratch, kFoldCt, B, b, V)[r], 2);
  }
  __syncthreads();

  // 1. s: min-plus on scores
  const int32_t* M = mp_closure<BK>(sm, [&](int i, int k) {
    const int32_t c = sm.R[i * BK + k];
    return c != kInf ? min(c & kScoreMask, kInfH) : kInfH;
  }, kInfH);
  mp_apply<BK>(M, sm.ps, [&](int i, int32_t x) {
    sm.xs[i] = x >= kInfH ? kInf : x;
  });

  // 2. a: min-plus on anomalies over the s-achieving edges
  for (int i = t; i < BK; i += NT) {
    const bool hit = sm.fold_s[i] < kInf && sm.fold_s[i] == sm.xs[i];
    sm.pa[i] = min(hit ? min(sm.fold_a[i], kInfA) : kInfA,
                   lo + i == dest ? 0 : kInfA);
  }
  M = mp_closure<BK>(sm, [&](int i, int k) {
    const int32_t c = sm.R[i * BK + k];
    const bool ach = c != kInf && sm.xs[k] < kInf &&
                     (c & kScoreMask) + sm.xs[k] == sm.xs[i];
    return ach ? c >> kAnomShift : kInfAH;
  }, kInfAH);
  mp_apply<BK>(M, sm.pa, [&](int i, int32_t x) {
    sm.xa[i] = sm.xs[i] < kInf ? x : 0;
  });

  // 3. fa: min-plus on anomalies over all edges
  M = mp_closure<BK>(sm, [&](int i, int k) {
    const int32_t c = sm.R[i * BK + k];
    return c != kInf ? c >> kAnomShift : kInfAH;
  }, kInfAH);
  mp_apply<BK>(M, sm.pf, [&](int i, int32_t x) {
    sm.xf[i] = x >= kInfAH ? kInf : x;
  });

  // 4. ct: saturated path counts over all edges
  cnt_closure_apply<BK>(sm, [&](int i, int k) {
    return sm.R[i * BK + k] != kInf;
  }, sm.pct, sm.xct);

  // 5. cm: saturated path counts over the (s, a)-achieving edges
  for (int i = t; i < BK; i += NT) {
    const bool hit = sm.fold_s[i] < kInf && sm.fold_s[i] == sm.xs[i] &&
                     sm.fold_a[i] == sm.xa[i];
    sm.pcm[i] = min((lo + i == dest ? 1 : 0) + (hit ? sm.fold_cm[i] : 0), 2);
  }
  __syncthreads();
  cnt_closure_apply<BK>(sm, [&](int i, int k) {
    const int32_t c = sm.R[i * BK + k];
    return c != kInf && sm.xs[k] < kInf &&
           (c & kScoreMask) + sm.xs[k] == sm.xs[i] &&
           (c >> kAnomShift) + sm.xa[k] == sm.xa[i];
  }, sm.pcm, sm.xcm);

  // nxt: the lowest achieving column of the whole row.  Columns below lo
  // still hold their initial values (s = INF but at dest, a = 0), so only
  // dest's can achieve there; then the block's own, then the tail's.
  int16_t* o = out + b * (V + 2);
  for (int i = t >> 5; i < BK; i += NW) {
    const int32_t xs = sm.xs[i], xa = sm.xa[i];
    int32_t nxt = -1;
    const int32_t dc = sm.dcell[i];
    if (dc != kInf && (dc & kScoreMask) == xs && (dc >> kAnomShift) == xa) {
      nxt = dest;
    } else {
      unsigned found = 0;
#pragma unroll
      for (int h = 0; h < BK / 32; ++h) {
        const int k = 32 * h + lane;
        const int32_t c = sm.R[i * BK + k];
        const bool ach = c != kInf && sm.xs[k] < kInf &&
                         (c & kScoreMask) + sm.xs[k] == xs &&
                         (c >> kAnomShift) + sm.xa[k] == xa;
        const unsigned bits = __ballot_sync(kFull, ach);
        if (!found && bits) found = 32 * h + __ffs(bits);  // 1-based
      }
      if (found) {
        nxt = lo + found - 1;
      } else if (sm.fold_s[i] < kInf && sm.fold_s[i] == xs && sm.fold_a[i] == xa) {
        nxt = sm.fold_low[i];
      }
    }
    if (lane == 0) o[lo + i] = (int16_t)(nxt < 0 ? dest : nxt);
  }
  for (int i = t; i < BK; i += NT) {
    const int32_t r = lo + i;
    vec(scratch, kS, B, b, V)[r] = sm.xs[i];
    vec(scratch, kA, B, b, V)[r] = sm.xa[i];
    vec(scratch, kFa, B, b, V)[r] = sm.xf[i];
    vec(scratch, kCt, B, b, V)[r] = sm.xct[i];
    vec(scratch, kCm, B, b, V)[r] = sm.xcm[i];
    if (r == src) {
      o[V] = (sm.xcm[i] == 1 && !(sm.xct[i] >= 2 && sm.xa[i] != sm.xf[i]))
                 ? 1 : 0;
    }
  }
}

template <int BK>
int run(const int32_t* slabs, int64_t B, int32_t V, int32_t* scratch,
        int16_t* out, cudaStream_t st) {
  const size_t smem = sizeof(Smem<BK>);
  cudaError_t rc = cudaFuncSetAttribute(
      blocked_step_kernel<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  blocked_init_kernel<<<dim3((V + kInitThreads - 1) / kInitThreads,
                             (unsigned)B), kInitThreads, 0, st>>>(
      slabs, V, B, scratch, out);
  for (int32_t lo = V - BK; lo >= 0; lo -= BK) {
    blocked_step_kernel<BK><<<(unsigned)B, Cfg<BK>::NT, smem, st>>>(
        slabs, V, B, lo, scratch, out);
    if (lo > 0) {
      blocked_fold_kernel<BK><<<dim3((lo + kFoldThreads - 1) / kFoldThreads,
                                     (unsigned)B), kFoldThreads, 0, st>>>(
          slabs, V, B, lo, scratch);
    }
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// int32 words of scratch the entry point needs per contig and vertex.
extern "C" int aln_blocked_dp_scratch_words() { return kNumVecs; }

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launches.  `scratch` holds
// aln_blocked_dp_scratch_words() * B * V int32; `slabs` and `scratch` are
// 16-byte aligned.
extern "C" int aln_blocked_dp_nxt16(int device, const int32_t* slabs,
                                    int64_t B, int32_t V, int32_t Bk,
                                    int32_t* scratch, int16_t* out,
                                    void* stream) {
  if ((Bk != 32 && Bk != 64) || V < Bk || V % Bk != 0 || V > 32767 ||
      B < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return Bk == 32 ? run<32>(slabs, B, V, scratch, out, st)
                  : run<64>(slabs, B, V, scratch, out, st);
}
