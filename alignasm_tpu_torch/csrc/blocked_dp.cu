// Blocked tropical triangular solve: (B, V+1, V) int32 slabs -> (B, V+2) int16
// gate rows [nxt (dest-encoded), fast, src], for Bk in {32, 64, 128} and V
// a multiple of Bk up to 32767 (the main path sends 256 < V <= 8192).
//
// Replaces the TPU engine's big-V kernel alignasm_tpu/ops/dense.py:_blocked_dp
// / solve_slab_topo_nxt16_blocked (XLA), which the main path runs for every
// bucket with V > 256.  The rows are bit-equal to it and to the plain
// PyTorch version (ops/dense.py:solve_slab_topo_nxt16_blocked) on slabs
// whose path sums stay below the JAX form's closure clamp INFH = 3 * 2^28
// (the scheduler sends sums below 2^27).  On slabs with no edge (r, dest)
// from a row r past dest, as the exporter writes them, they also equal the
// plain scan's int16 row (ops/dense.py:solve_slab_topo_nxt16) and so do not
// depend on Bk; an edge (r, dest) with dest < lo feeds only the row's nxt
// (the dest-below-lo rule below), while the scan also takes it into s, a,
// fa, ct and cm.
//
// Algorithm.  Vertices fall into nb = V/Bk diagonal blocks, solved last to
// first (edges point from low to high topo positions).  A row of block
// [lo, lo+Bk) needs its edges into the final tail columns (>= lo+Bk) and
// into the block's own columns after it.
//
// The tail: a right-looking fold.  When block j is final, one kernel folds
// its Bk columns into every row above it (rows < lo_j, spread over CTAs x
// contigs, one thread per row, 16-byte loads of the row's Bk cells), so
// each cell of the upper triangle is read once, at V = 8192 134 MB.  The
// fold keeps, per row, the lexicographic minimum of (ws + s[c], wa + a[c])
// over edges to reachable columns with the saturated sum of cm[c] and the
// lowest c attaining it, min (wa + fa[c]) and the saturated sum of ct[c]:
// all mins, saturated sums or a min index, so it is associative and
// order-free, and it is exactly the seed of topo_step.cuh.
//
// The block: the shared reverse-topological step (topo_step.cuh), one warp
// per contig, run over the block's Bk rows in reverse order, each row
// seeded from its fold; the block's columns' state lives in the lanes'
// registers (Bk/32 a lane).  The TPU form solved the block with five
// log-depth closures because a TPU step costs ~23 us; a warp step costs
// well under a microsecond on the H100, so V dependent steps are the
// shorter path.  Counts saturate at 2 (the gate reads cm == 1 and ct >= 2
// only).  nxt keeps the JAX form's rule: the lowest achieving column of the
// whole row, where a column below lo can achieve only if it is dest's (its
// anchors are final from the start), so an edge (row, dest) with dest < lo
// comes first.  The CTA stages the block's Bk x Bk cells in shared memory
// (64 KB at 128), INF32 where a row may not look, before the warp steps.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py,
// PERF.md): at B = 1 the V dependent warp steps, about 340 ns a row at
// Bk = 64, growing with Bk / 32 (the columns a lane holds), and the
// 2 * nb - 1 launches, each block's pair a few microseconds; a lone
// V = 8192 contig takes 2.8 ms at Bk = 64, against 0.04 ms to move its
// bytes.  The scheduler's Bk (runtime/scheduler.py:BLOCKED_BK) balances
// the two.  State (the five final vectors and the six fold vectors) lives
// in a global scratch buffer of 11 * B * V int32, L2-resident.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topo_step.cuh"

namespace {

using topo::kAnomShift;
using topo::kInf;
using topo::kNone;
using topo::kScoreMask;

constexpr int kFoldThreads = 128;
constexpr int kInitThreads = 256;
constexpr int kStepThreads = 128;  // all stage; warp 0 steps
constexpr int32_t kSat = 2;

// Scratch vectors, each (B, V) int32.
enum Vec {
  kS, kA, kFa, kCt, kCm,          // final DP values of solved columns
  kFoldS, kFoldA, kFoldCm, kFoldLow, kFoldFa, kFoldCt,  // per-row tail folds
  kNumVecs
};

__device__ __forceinline__ int32_t* vec(int32_t* scratch, int v, int64_t B,
                                        int64_t b, int32_t V) {
  return scratch + ((int64_t)v * B + b) * V;
}

__global__ void __launch_bounds__(kInitThreads)
blocked_init_kernel(const int32_t* __restrict__ slabs, int32_t V, int64_t B,
                    int32_t* __restrict__ scratch, int16_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int32_t v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < V) {  // topo::no_seed(): no tail edge yet
    vec(scratch, kFoldS, B, b, V)[v] = kInf;
    vec(scratch, kFoldA, B, b, V)[v] = kInf;
    vec(scratch, kFoldCm, B, b, V)[v] = 0;
    vec(scratch, kFoldLow, B, b, V)[v] = kNone;
    vec(scratch, kFoldFa, B, b, V)[v] = kNone;
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
    cfa[c] = vec(scratch, kFa, B, b, V)[lo + c];
    cct[c] = vec(scratch, kCt, B, b, V)[lo + c];
  }
  __syncthreads();
  const int32_t r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= lo || r == dest) return;  // dest's row keeps its anchors
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
          best_cm = min(best_cm + ccm[c], kSat);
          best_low = min(best_low, lo + c);
        }
      }
      min_fa = min(min_fa, wa + cfa[c]);
      sum_ct = min(sum_ct + cct[c], kSat);
    }
  }
  *f_s = best_s;
  *f_a = best_a;
  *f_cm = best_cm;
  *f_low = best_low;
  *f_fa = min_fa;
  *f_ct = sum_ct;
}

template <int BK>
struct StepSmem {
  int32_t seed[6][BK];  // the rows' folds, in topo::Seed order
  int32_t dcell[BK];    // cell (row, dest) when dest < lo, else INF32
  int32_t cells[BK * BK];
};

// Solve block [lo, lo+BK) of every contig: one CTA per contig, whose
// threads stage the block's folds and cells; then warp 0 runs the shared
// step over the block's rows, last to first.
template <int BK>
__global__ void __launch_bounds__(kStepThreads)
blocked_step_kernel(const int32_t* __restrict__ slabs, int32_t V, int64_t B,
                    int32_t lo, int32_t* __restrict__ scratch,
                    int16_t* __restrict__ out) {
  constexpr int NC = BK / 32;
  using Smem = StepSmem<BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t* slab = slabs + b * (V + 1) * V;
  const int32_t dest = slab[(int64_t)V * V];
  const int32_t src = slab[(int64_t)V * V + 1];

  for (int i = t; i < BK; i += kStepThreads) {
    const int32_t r = lo + i;
    sm.seed[0][i] = vec(scratch, kFoldS, B, b, V)[r];
    sm.seed[1][i] = vec(scratch, kFoldA, B, b, V)[r];
    sm.seed[2][i] = vec(scratch, kFoldCm, B, b, V)[r];
    sm.seed[3][i] = vec(scratch, kFoldLow, B, b, V)[r];
    sm.seed[4][i] = vec(scratch, kFoldFa, B, b, V)[r];
    sm.seed[5][i] = vec(scratch, kFoldCt, B, b, V)[r];
    sm.dcell[i] = dest >= 0 && dest < lo ? slab[(int64_t)r * V + dest] : kInf;
  }
  const int32_t dl = dest - lo;  // dest's block-local column
  auto needed = [&](int32_t i, int32_t col) { return col > i || col == dl; };
  // the cells a row may use, INF32 elsewhere
  for (int e = t; e < BK * BK / 4; e += kStepThreads) {
    const int i = e / (BK / 4), q = e % (BK / 4);
    int4 v = *reinterpret_cast<const int4*>(
        slab + (int64_t)(lo + i) * V + lo + 4 * q);
    v.x = needed(i, 4 * q) ? v.x : kInf;
    v.y = needed(i, 4 * q + 1) ? v.y : kInf;
    v.z = needed(i, 4 * q + 2) ? v.z : kInf;
    v.w = needed(i, 4 * q + 3) ? v.w : kInf;
    *reinterpret_cast<int4*>(sm.cells + i * BK + 4 * q) = v;
  }
  __syncthreads();
  if (t >= 32) return;

  const int lane = t;
  topo::Cols<NC> c;
  topo::init_cols(c, lo, dest);
  auto body = [&](int32_t i, const int32_t (&cell)[NC]) {
    if (lo + i == dest) return;  // dest's values are the anchors
    const topo::Seed seed{sm.seed[0][i], sm.seed[1][i], sm.seed[2][i],
                          sm.seed[3][i], sm.seed[4][i], sm.seed[5][i]};
    topo::Row r = topo::topo_step<NC, kSat>(cell, c, lo, seed);
    const int32_t dc = sm.dcell[i];
    if (dc != kInf && (dc & kScoreMask) == r.s && (dc >> kAnomShift) == r.a)
      r.nxt = dest;
    topo::set_col(c, lo, lo + i, r);
  };
  topo::reverse_rows<NC, 2>(BK, [&](int32_t i, int32_t (&cell)[NC]) {
#pragma unroll
    for (int k = 0; k < NC; ++k) cell[k] = sm.cells[i * BK + lane + 32 * k];
  }, body);

  int16_t* o = out + b * (V + 2);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int32_t r = lo + lane + 32 * k;
    vec(scratch, kS, B, b, V)[r] = c.s[k];
    vec(scratch, kA, B, b, V)[r] = c.a[k];
    vec(scratch, kFa, B, b, V)[r] = c.fa[k];
    vec(scratch, kCt, B, b, V)[r] = c.ct[k];
    vec(scratch, kCm, B, b, V)[r] = c.cm[k];
    o[r] = (int16_t)(c.nxt[k] < 0 ? dest : c.nxt[k]);
  }
  const bool fast = topo::gate_at(c, lo, src);
  if (lane == 0 && src >= lo && src < lo + BK) o[V] = fast ? 1 : 0;
}

template <int BK>
int run(const int32_t* slabs, int64_t B, int32_t V, int32_t* scratch,
        int16_t* out, cudaStream_t st) {
  const size_t smem = sizeof(StepSmem<BK>);
  cudaError_t rc = cudaFuncSetAttribute(
      blocked_step_kernel<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  blocked_init_kernel<<<dim3((V + kInitThreads - 1) / kInitThreads,
                             (unsigned)B), kInitThreads, 0, st>>>(
      slabs, V, B, scratch, out);
  for (int32_t lo = V - BK; lo >= 0; lo -= BK) {
    blocked_step_kernel<BK><<<(unsigned)B, kStepThreads, smem, st>>>(
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
  if ((Bk != 32 && Bk != 64 && Bk != 128) || V < Bk ||
      V % Bk != 0 || V > 32767 || B < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (Bk) {
    case 32: return run<32>(slabs, B, V, scratch, out, st);
    case 64: return run<64>(slabs, B, V, scratch, out, st);
    default: return run<128>(slabs, B, V, scratch, out, st);
  }
}
