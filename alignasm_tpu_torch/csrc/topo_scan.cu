// Reverse-topological scan: (B, V+1, V) int32 slabs -> (B, V+2) uint8 gate rows.
//
// Replaces the TPU kernel alignasm_tpu/ops/pallas_topo.py:_scan_kernel and its
// XLA form alignasm_tpu/ops/dense.py:_topo_scan / solve_slab_topo_nxt8, which
// the main path runs for every bucket with V <= 256.
//
// What bounds it on the H100: V dependent steps per contig, each a
// reduction over the row, and the bucket's needed bytes.  A block barrier
// per step would make it latency-bound.  By the cells it needs the
// function is bound by bytes: karyotype10k's V = 64 bucket (16,384
// contigs) takes 0.2191 ms against 0.0403 ms for its bytes and 0.0250 ms
// for its operations (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py,
// PERF.md).  With one warp per contig and thousands of contigs in flight,
// the gap is the steps' instructions: three warp reductions a row after
// per-lane trees.
//
// Design.  One warp per contig, kWarps contigs per CTA, no block barrier
// anywhere: a warp whose contig lies past B leaves at once.  The lanes hold
// the columns' DP state in registers (NC = ceil(V/32) columns a lane) and
// run the shared step of topo_step.cuh for u = V-1 .. 0.  _topo_scan
// requires u < v for every edge (dense.py:113-115) while dest may sit
// anywhere, so row u reads only its columns > u and dest's column: about
// half the slab's sectors.  The next rows' loads stay in flight:
//   V <= 64   the contig's needed cells go to the warp's slice of shared
//             memory in one cp.async pass (16 KB at V = 64, every load in
//             flight at once, INF32 written to the other slots), then the
//             steps read shared memory;
//   V > 64    a ring of kRing rows in registers, loaded kRing - 1 steps
//             ahead from global memory (an int32 slab at V = 256 is
//             263 KB, more than a CTA's shared memory).
// At the end every lane writes its columns' dest-encoded nxt bytes and lane
// 0 the gate (fast = cm == 1 && !(ct >= 2 && a != fa) at src) and src.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topo_step.cuh"

namespace {

using topo::kInf;

constexpr int32_t kCountSat = 10001;
constexpr int kWarps = 4;  // contigs per CTA
constexpr int kRing = 4;   // rows in flight at V > 64

template <int NC>
__global__ void __launch_bounds__(32 * kWarps)
topo_scan_nxt8_kernel(const int32_t* __restrict__ slabs, int32_t V, int64_t B,
                      uint8_t* __restrict__ out) {
  extern __shared__ int32_t staged[];  // V <= 64: kWarps slices of V x 32 NC
  constexpr int LD = 32 * NC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= B) return;
  const int32_t* slab = slabs + b * (V + 1) * V;
  const int32_t dest = slab[(int64_t)V * V];
  const int32_t src = slab[(int64_t)V * V + 1];

  topo::Cols<NC> c;
  topo::init_cols(c, 0, dest);
  auto body = [&](int32_t u, const int32_t (&cell)[NC]) {
    if (u == dest) return;  // dest's values are the anchors
    const topo::Row r = topo::topo_step<NC, kCountSat>(cell, c, 0,
                                                      topo::no_seed());
    topo::set_col(c, 0, u, r);
  };
  auto needed = [&](int32_t u, int32_t col) {
    return col < V && (col > u || col == dest);
  };

  if constexpr (NC <= 2) {
    // the needed cells by cp.async, INF32 in every other slot
    int32_t* sm = staged + warp * V * LD;
    for (int32_t u = 0; u < V; ++u) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int32_t col = lane + 32 * k;
        if (needed(u, col))
          __pipeline_memcpy_async(sm + u * LD + col,
                                  slab + (int64_t)u * V + col, 4);
        else
          sm[u * LD + col] = kInf;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    topo::reverse_rows<NC, 2>(V, [&](int32_t u, int32_t (&cell)[NC]) {
#pragma unroll
      for (int k = 0; k < NC; ++k) cell[k] = sm[u * LD + lane + 32 * k];
    }, body);
  } else {
    topo::reverse_rows<NC, kRing>(V, [&](int32_t u, int32_t (&cell)[NC]) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int32_t col = lane + 32 * k;
        cell[k] = needed(u, col) ? __ldg(slab + (int64_t)u * V + col) : kInf;
      }
    }, body);
  }

  uint8_t* o = out + b * (V + 2);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int32_t col = lane + 32 * k;
    if (col < V) o[col] = (uint8_t)(c.nxt[k] < 0 ? dest : c.nxt[k]);
  }
  const bool fast = topo::gate_at(c, 0, src);
  if (lane == 0) {
    o[V] = fast ? 1 : 0;
    o[V + 1] = (uint8_t)src;
  }
}

template <int NC>
int launch(const int32_t* slabs, int64_t B, int32_t V, uint8_t* out,
           cudaStream_t st) {
  const size_t smem = NC <= 2 ? (size_t)kWarps * V * 32 * NC * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        topo_scan_nxt8_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int64_t ctas = (B + kWarps - 1) / kWarps;
  topo_scan_nxt8_kernel<NC><<<(unsigned)ctas, 32 * kWarps, smem, st>>>(
      slabs, V, B, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launch.
extern "C" int aln_topo_scan_nxt8(int device, const int32_t* slabs, int64_t B,
                                  int32_t V, uint8_t* out, void* stream) {
  if (V < 2 || V > 256 || B < 0) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch ((V + 31) / 32) {
    case 1: return launch<1>(slabs, B, V, out, st);
    case 2: return launch<2>(slabs, B, V, out, st);
    case 3: return launch<3>(slabs, B, V, out, st);
    case 4: return launch<4>(slabs, B, V, out, st);
    case 5: return launch<5>(slabs, B, V, out, st);
    case 6: return launch<6>(slabs, B, V, out, st);
    case 7: return launch<7>(slabs, B, V, out, st);
    default: return launch<8>(slabs, B, V, out, st);
  }
}
