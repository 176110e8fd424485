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
// The function is _solve_one's four loops in order, each n_sweeps Jacobi
// sweeps (a sweep reads only the previous sweep's vector): the lex-min (sum,
// anom) to dest, the anomaly floor, the walk count, and the count of min
// walks over the (sum, anom)-achieving edges, counts saturated at COUNT_SAT.
//
// What bounds it: device memory.  Each loop is a DAG dynamic program that one
// reverse-topological pass over the cells computes; the matrices (2 * B * V^2
// * 4 bytes, or (V+1) * V * 4 a slab) are read once.
//
// Design: the checked pass of topo_pass.cuh.  An optional hint order (B, V)
// (identity when null: the slab entry's default, as the exporter's slabs are
// in Kahn order) gives each contig's topological positions.  The pass:
//   V <= 256   one warp per contig, kPassWarps contigs per CTA, no block
//              barrier; the lanes hold their columns' five values, pos and
//              L in registers (NC = V/32 a lane) and run topo::topo_step
//              for t = V-1 .. 0 on row order[t], read whole and coalesced,
//              kRing rows in flight (topo::reverse_rows); the checks of
//              (a)-(c) ride in one more warp reduction (a max) a row;
//   V > 256    one warp per contig, the state in a global workspace (7V
//              words a contig), the row in chunks of 256 columns, each
//              gathered into registers and stepped with the chunk before as
//              its seed (a library size: the plane's dense_max_v is 256).
// A contig that fails a check takes the Jacobi branch, the literal loops
// below, in a second launch whose CTAs leave at once for the others.
//
// Jacobi branch: one CTA per contig; the double-buffered state (s, a, and
// one vector that serves fa and both counts) in shared memory, 6V words; one
// warp per matrix row u at a time, its lanes on the row's columns, a shuffle
// reduction, lane 0 writing the new value.  A loop stops once a sweep changes
// nothing: the next state is a function of the current one only, so every
// later sweep would return the same vector, and the result equals the full
// n_sweeps.  Arithmetic is the JAX package's int32 arithmetic, sums wrapping
// as there (add32), so the rows are bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topo_pass.cuh"

namespace {

using topo::kAnomShift;
using topo::kCountSat;
using topo::kFull;
using topo::kInf;
using topo::kScoreMask;
constexpr int32_t kI32Max = 0x7fffffff;
constexpr int kMaxV = 8192;  // 6V words of shared memory = 192 KB
constexpr int kMaxWarps = 16;
constexpr int kPassWarps = 4;  // contigs per CTA of the register pass
constexpr int kRing = 4;       // rows in flight
constexpr int kRegV = 256;     // the register pass's largest V
constexpr int kChunk = 256;    // columns a chunk of the workspace pass

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

// --- the checked pass ---------------------------------------------------

// Where a contig's data lies: its cells (ws and wa, or the packed slab), its
// dest, src (slabs) and hint.
template <bool kPacked>
struct Contig {
  const int32_t* ws;
  const int32_t* wa;
  const int32_t* order;  // null: the identity
  int32_t dest, src;

  __device__ Contig(const int32_t* ws_all, const int32_t* wa_all,
                    const int32_t* dest_all, const int32_t* order_all,
                    int64_t b, int32_t V) {
    const int64_t VV = (int64_t)V * V;
    order = order_all ? order_all + b * V : nullptr;
    if (kPacked) {
      ws = ws_all + b * (VV + V);
      wa = nullptr;
      dest = ws[VV];
      src = ws[VV + 1];
    } else {
      ws = ws_all + b * VV;
      wa = wa_all + b * VV;
      dest = dest_all[b];
      src = 0;
    }
  }

  __device__ int32_t row_at(int32_t t) const { return order ? order[t] : t; }

  // The checked cell (u, col): INF32, an edge's packed cell, or kBad.
  __device__ int32_t cell_at(int32_t u, int32_t col, int32_t V) const {
    if (col >= V) return kInf;
    const int64_t off = (int64_t)u * V + col;
    if (kPacked) return topo::check_cell(__ldg(ws + off));
    const int32_t w = __ldg(ws + off);
    return topo::pack_edge(w < kInf, w, w < kInf ? __ldg(wa + off) : 0);
  }

  // dest's column is final for every row when dest's row holds no edge (or
  // dest lies outside the matrix).  Warp-uniform.
  __device__ bool dest_final(int32_t V) const {
    bool edge = false;
    if (dest >= 0 && dest < V) {
      for (int32_t col = topo::lane_id(); col < V; col += 32)
        edge |= cell_at(dest, col, V) != kInf;
    }
    return !__any_sync(kFull, edge);
  }
};

// Rows of one contig: (B, 5, V) vectors, or a slab's (2V+4) row with the
// three counts and fa at src.  `at(v, k)` is vertex v's value k (0 = s ..
// 4 = cm); each lane writes the columns it is given.
template <bool kPacked, class At>
__device__ __forceinline__ void write_out(int32_t* out, int64_t b, int32_t V,
                                          int32_t col, int32_t src, At at) {
  if (col >= V) return;
  if (kPacked) {
    int32_t* o = out + b * (2 * V + 4);
    o[col] = at(col, 0);
    o[V + col] = at(col, 1);
    if (col == src) {
      for (int k = 2; k < 5; ++k) o[2 * V + k - 2] = at(col, k);
    }
  } else {
    int32_t* o = out + b * 5 * V;
    for (int k = 0; k < 5; ++k) o[k * V + col] = at(col, k);
  }
}

template <bool kPacked>
__device__ __forceinline__ void write_tail(int32_t* out, int64_t b,
                                           int32_t V, int32_t src) {
  if (!kPacked || topo::lane_id() != 0) return;
  int32_t* o = out + b * (2 * V + 4);
  if (src < 0 || src >= V) {  // the JAX masked sum picks 0
    o[2 * V] = o[2 * V + 1] = o[2 * V + 2] = 0;
  }
  o[2 * V + 3] = src;
}

// The register pass, V <= 256: one warp per contig, kPassWarps a CTA.
template <bool kPacked, int NC>
__global__ void __launch_bounds__(32 * kPassWarps)
sweep_pass_kernel(const int32_t* __restrict__ ws_all,
                  const int32_t* __restrict__ wa_all,
                  const int32_t* __restrict__ dest_all,
                  const int32_t* __restrict__ order_all, int32_t V, int64_t B,
                  int32_t n_sweeps, int32_t* __restrict__ flags,
                  int32_t* __restrict__ jacobi, int32_t* __restrict__ out) {
  constexpr int RW = kPacked ? NC : 2 * NC;  // raw words a lane loads a row
  __shared__ int32_t pos_all[kPassWarps][kRegV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kPassWarps + warp;
  if (b >= B) return;
  const Contig<kPacked> g(ws_all, wa_all, dest_all, order_all, b, V);
  int32_t* pos = pos_all[warp];
  for (int32_t v = lane; v < V; v += 32) pos[v] = -1;
  __syncwarp();
  const bool perm = __all_sync(kFull, topo::fill_pos(pos, g.order, V, lane,
                                                     32));
  __syncwarp();
  if (!perm) return topo::to_jacobi(flags, jacobi, b);
  const bool dest_final = g.dest_final(V);

  int32_t pk[NC], lk[NC];  // pos and L of the lane's columns
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int32_t col = lane + 32 * k;
    pk[k] = col >= V                      ? -1
            : col == g.dest && dest_final ? topo::kAlwaysReady
                                          : pos[col];
    lk[k] = 0;
  }
  topo::Cols<NC> c;
  topo::init_cols(c, 0, g.dest);
  const int32_t limit = min(n_sweeps, V);
  bool failed = false;
  // raw[k] the row's ws (or packed) word of column lane + 32k, raw[NC + k]
  // its wa word; checked and packed at the step, so the loads stay in flight
  auto load = [&](int32_t t, int32_t (&raw)[RW]) {
    const int64_t row = (int64_t)g.row_at(t) * V;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int32_t col = lane + 32 * k;
      raw[k] = col < V ? __ldg(g.ws + row + col) : kInf;
      if constexpr (!kPacked) raw[NC + k] = col < V ? __ldg(g.wa + row + col) : 0;
    }
  };
  // A failed check is only recorded: a branch before the step would hold
  // its warp reductions behind the check's; the contig's values are then
  // dropped for the Jacobi branch's.
  auto body = [&](int32_t t, const int32_t (&raw)[RW]) {
    const int32_t u = g.row_at(t);
    int32_t m[NC];
    int32_t len = 0;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int32_t col = lane + 32 * k;
      const int32_t cell =
          kPacked ? topo::check_cell(raw[k])
                  : topo::pack_edge(raw[k] < kInf, raw[k], raw[RW - NC + k]);
      const bool ready = pk[k] > t;
      len = max(len, topo::path_term(cell, ready, lk[k]));
      m[k] = ready && cell >= 0 ? cell : kInf;
    }
    len = __reduce_max_sync(kFull, len);
    failed |= len > limit;
    topo::Row r = topo::topo_step<NC, kCountSat>(m, c, 0, topo::no_seed());
    r.fa = min(r.fa, kInf);
    if (u != g.dest) topo::set_col(c, 0, u, r);  // dest keeps its anchors
#pragma unroll
    for (int k = 0; k < NC; ++k) lk[k] = lane + 32 * k == u ? len : lk[k];
  };
  topo::reverse_rows<RW, kRing>(V, load, body);
  if (failed) return topo::to_jacobi(flags, jacobi, b);

#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int32_t vals[5] = {c.s[k], c.a[k], c.fa[k], c.ct[k], c.cm[k]};
    write_out<kPacked>(out, b, V, lane + 32 * k, g.src,
                       [&](int32_t, int j) { return vals[j]; });
  }
  write_tail<kPacked>(out, b, V, g.src);
}

// The workspace pass, V > 256: one warp per contig, its state in `work`
// (7V words a contig), each row in chunks of kChunk columns.
template <bool kPacked>
__global__ void __launch_bounds__(32)
sweep_work_kernel(const int32_t* __restrict__ ws_all,
                  const int32_t* __restrict__ wa_all,
                  const int32_t* __restrict__ dest_all,
                  const int32_t* __restrict__ order_all, int32_t V,
                  int32_t n_sweeps, int32_t* __restrict__ flags,
                  int32_t* __restrict__ jacobi, int32_t* __restrict__ work,
                  int32_t* __restrict__ out) {
  constexpr int NC = kChunk / 32;
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const Contig<kPacked> g(ws_all, wa_all, dest_all, order_all, b, V);
  const topo::Work w = topo::work_at(work + b * 7 * V, V);
  for (int32_t v = lane; v < V; v += 32) w.pos[v] = -1;
  __syncwarp();
  const bool perm = __all_sync(kFull, topo::fill_pos(w.pos, g.order, V, lane,
                                                     32));
  if (!perm) return topo::to_jacobi(flags, jacobi, b);
  topo::init_work(w, V, g.dest, lane, 32);
  if (g.dest_final(V) && lane == 0 && g.dest >= 0 && g.dest < V)
    w.pos[g.dest] = topo::kAlwaysReady;
  __syncwarp();
  const int32_t limit = min(n_sweeps, V);
  for (int32_t t = V - 1; t >= 0; --t) {
    const int32_t u = g.row_at(t);
    topo::Seed seed = topo::no_seed();
    topo::Row r;
    int32_t len = 0;
    for (int32_t j = 0; j < V; j += kChunk) {
      int32_t col[NC], cell[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int32_t v = j + lane + 32 * k;
        col[k] = v < V ? v : -1;
        cell[k] = g.cell_at(u, v, V);
      }
      r = topo::work_step<NC>(w, col, cell, t, seed, len);
      seed = topo::seed_of(r);
    }
    len = __reduce_max_sync(kFull, len);
    if (len > limit) return topo::to_jacobi(flags, jacobi, b);
    topo::store_row(w, u, g.dest, r, len);
    __syncwarp();
  }
  const int32_t* vec[5] = {w.s, w.a, w.fa, w.ct, w.cm};
  for (int32_t v = lane; v < V; v += 32)
    write_out<kPacked>(out, b, V, v, g.src,
                       [&](int32_t x, int j) { return vec[j][x]; });
  write_tail<kPacked>(out, b, V, g.src);
}

template <bool kPacked>
__global__ void __launch_bounds__(32 * kMaxWarps)
sweep_dense_kernel(const int32_t* __restrict__ ws_all,
                   const int32_t* __restrict__ wa_all,
                   const int32_t* __restrict__ dest_all, int32_t V,
                   int32_t n_sweeps, const int32_t* __restrict__ flags,
                   int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  int32_t* s[2] = {sm, sm + V};
  int32_t* a[2] = {sm + 2 * V, sm + 3 * V};
  int32_t* x[2] = {sm + 4 * V, sm + 5 * V};

  const int64_t b = blockIdx.x;
  if (!flags[b]) return;  // the pass solved this contig
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

template <bool kPacked, int NC>
cudaError_t launch_pass(const int32_t* ws, const int32_t* wa,
                        const int32_t* dest, const int32_t* order, int64_t B,
                        int32_t V, int32_t n_sweeps, int32_t* flags,
                        int32_t* jacobi, int32_t* out, cudaStream_t stream) {
  const int64_t ctas = (B + kPassWarps - 1) / kPassWarps;
  sweep_pass_kernel<kPacked, NC><<<(unsigned)ctas, 32 * kPassWarps, 0,
                                   stream>>>(ws, wa, dest, order, V, B,
                                             n_sweeps, flags, jacobi, out);
  return cudaGetLastError();
}

template <bool kPacked>
cudaError_t launch(const int32_t* ws, const int32_t* wa, const int32_t* dest,
                   const int32_t* order, int64_t B, int32_t V,
                   int32_t n_sweeps, int32_t* flags, int32_t* jacobi,
                   int32_t* work, int32_t* out, cudaStream_t stream) {
  cudaError_t rc;
  switch ((V + 31) / 32) {
#define PASS(nc)                                                          \
  case nc:                                                                \
    rc = launch_pass<kPacked, nc>(ws, wa, dest, order, B, V, n_sweeps,    \
                                  flags, jacobi, out, stream);            \
    break;
    PASS(1) PASS(2) PASS(3) PASS(4) PASS(5) PASS(6) PASS(7) PASS(8)
#undef PASS
    default:
      sweep_work_kernel<kPacked><<<(unsigned)B, 32, 0, stream>>>(
          ws, wa, dest, order, V, n_sweeps, flags, jacobi, work, out);
      rc = cudaGetLastError();
  }
  if (rc != cudaSuccess) return rc;
  // the Jacobi branch: every CTA whose contig the pass did not solve
  const size_t smem = (size_t)6 * V * sizeof(int32_t);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(sweep_dense_kernel<kPacked>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  const int warps = V < kMaxWarps ? V : kMaxWarps;
  sweep_dense_kernel<kPacked><<<(unsigned)B, 32 * warps, smem, stream>>>(
      ws, wa, dest, V, n_sweeps, flags, out);
  return cudaGetLastError();
}

}  // namespace

// int32 words of workspace the entry point needs per contig (0: none).
extern "C" int aln_sweep_dense_work_words(int32_t V) {
  return V > kRegV ? 7 * V : 0;
}

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launches.  packed != 0: `ws` holds
// (B, V+1, V) slabs and `wa`/`dest` are unused.  `order` is the (B, V) hint
// or null (the identity).  `flags` holds B int32 zeros: the kernel sets
// flags[b] = 1 for each contig that took the Jacobi branch, and adds their
// number to the one int32 at `jacobi` unless that is null.  `work` holds
// aln_sweep_dense_work_words(V) * B int32.
extern "C" int aln_sweep_dense(int device, const int32_t* ws, const int32_t* wa,
                               const int32_t* dest, const int32_t* order,
                               int32_t packed, int64_t B, int32_t V,
                               int32_t n_sweeps, int32_t* flags,
                               int32_t* jacobi, int32_t* work, int32_t* out,
                               void* stream) {
  if (V < 1 || V > kMaxV || n_sweeps < 0 || B < 0 || B > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  rc = packed ? launch<true>(ws, wa, dest, order, B, V, n_sweeps, flags,
                             jacobi, work, out, st)
              : launch<false>(ws, wa, dest, order, B, V, n_sweeps, flags,
                              jacobi, work, out, st);
  return (int)rc;
}
