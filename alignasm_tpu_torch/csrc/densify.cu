// Wire densify: the native exporter's sparse wires -> (B, V+1, V) int32 slabs.
//
// Replaces the XLA scatters alignasm_tpu/ops/dense.py:_densify_wire_ragged
// (:491) and _densify_wire16 (:532).  Both kernels are bound by bytes:
// the wire in and the slabs out, each once.
//
// The ragged wire: the caller pre-fills the flat (B * V * (V+1) + 1)
// buffer with INF32; each entry is one 4-byte store, one thread per entry;
// indices outside [0, trash] go to the trash cell, which the caller slices
// off.  On this wire only the trash cell repeats (the exporter trash-fills
// a rejected contig's span, export.cc:aln_export_wire_ragged), so racing
// stores are harmless.  The 16-bit wire repeats cells besides: its
// rejected-contig filler is zero deltas that repeat the src cell with the
// same value (export.cc:aln_export_wire16).
//
// The 16-bit wire (cell i = cumsum(deltas)[i], value i = table[vidx[i]],
// entries at or past n_real dropped, then the seed pairs on top) writes
// each slab line once, a tile at a time, with no pre-fill and no trash
// cell:
//   1. scan: a sum launch (one int64 sum per chunk of the u16 deltas, and
//      the seeds' descents) and a scan launch (each chunk's exclusive
//      prefix from the sums, then a block scan) write the int32
//      positions.  The 64-bit total of [0, n_real) tells whether they are
//      nondecreasing as int32: it is below 2^31 on every exporter wire
//      (the deltas are u16 and the cells end at or below the trash cell).
//      If it is, the scan launch marks each tile's first entry (tstart)
//      and, for sorted seeds (the exporter's are ascending, padded with
//      the trash cell), each tile's first seed (sstart);
//   2. tiles: a CTA a tile of kTile flat cells (32 KB) fills it with INF32
//      in shared memory, stores its entries there (of a run of equal cells
//      the last entry, as a serial scatter leaves it: the exporter's
//      rejected-contig filler is zero deltas that repeat a cell with the
//      same value), then its sorted seeds the same way, and writes the
//      tile out once with 16-byte stores.  (A one-call A/B on the H100,
//      PERF.md: tiles of 8192 cells beat 32768 and 131072, and staging in
//      shared memory matched streaming INF32 to device memory first);
//   3. fix-up, a launch that returns at once unless a flag of the scan
//      asks for it: when the positions wrap (the total passes 2^31 - 1)
//      the tiles wrote INF32 only, and it scatters every entry, dropping
//      cells outside [0, B*M); within a run of equal consecutive cells
//      the last entry stores, and cells that meet again after the int32
//      positions wrap take either value, as the JAX scatter leaves
//      repeats unspecified.  Then, for unsorted seeds or after the wrap,
//      the last of its CTAs to finish places the seeds (unsorted: one
//      thread, in stream order).
// The host never waits: the branches are taken on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kInf = 1 << 30;
constexpr int kScanItems = 16;                   // deltas a thread scans
constexpr int kChunk = kThreads * kScanItems;    // deltas a scan CTA owns
constexpr int kTile = 8192;                      // cells a tile CTA owns
constexpr int kFixGrid = 264;                    // CTAs of the fix-up
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t clamp_trash(int64_t i, int64_t trash) {
  return (i >= 0 && i <= trash) ? i : trash;
}

__global__ void scatter_kernel(const int32_t* __restrict__ idx,
                               const int32_t* __restrict__ val, int64_t n,
                               int64_t trash, int32_t* __restrict__ flat) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  flat[clamp_trash(idx[i], trash)] = val[i];
}

inline unsigned grid_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// ----------------------------------------------------------------------
// The 16-bit wire.

// The scratch words of one call: flags (0: the positions wrap, 1: the
// seeds are unsorted, 2: the fix-up launch's CTAs done), the chunks'
// int64 sums of deltas and their seeds' descents, tstart and sstart
// (ntiles + 1 each) and the n_real int32 positions.
struct Scratch {
  int32_t* flags;
  int64_t* csum;
  int32_t *desc, *tstart, *sstart, *pos;
};

__host__ __device__ inline int64_t n_chunks(int64_t n_real) {
  return n_real > 0 ? (n_real + kChunk - 1) / kChunk : 1;
}

__host__ __device__ inline int64_t n_tiles(int64_t cells) {
  return (cells + kTile - 1) / kTile;
}

__host__ __device__ inline int64_t scratch_words(int64_t n_real,
                                                 int64_t cells) {
  return 4 + 3 * n_chunks(n_real) + 2 * (n_tiles(cells) + 1) + n_real;
}

__host__ __device__ inline Scratch scratch_at(int32_t* base, int64_t n_real,
                                              int64_t cells) {
  const int64_t C = n_chunks(n_real), T = n_tiles(cells) + 1;
  Scratch s;
  s.flags = base;
  s.csum = (int64_t*)(base + 4);
  s.desc = base + 4 + 2 * C;
  s.tstart = s.desc + C;
  s.sstart = s.tstart + T;
  s.pos = s.sstart + T;
  return s;
}

__device__ __forceinline__ int32_t u16(const int16_t* p, int64_t i) {
  return (int32_t)p[i] & 0xFFFF;  // the raw u16 bits, widened
}

__device__ __forceinline__ int32_t value(const int16_t* vidx,
                                         const int32_t* table,
                                         int32_t n_table, int64_t i) {
  const int32_t vi = u16(vidx, i);
  return table[vi < n_table ? vi : n_table - 1];  // a JAX gather clamps
}

// Sum of one value a thread over the CTA (every thread gets it).
template <typename T>
__device__ T block_sum(T x, T* red) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// Tile key of a cell for the tile boundaries: -1 below the slabs, the
// tile, or ntiles at and past the last tile.
__device__ __forceinline__ int64_t tile_of(int64_t cell, int64_t ntiles) {
  if (cell < 0) return -1;
  const int64_t k = cell / kTile;
  return k < ntiles ? k : ntiles;
}

// first[k] = i for the tiles k in (prev, key], k >= 0: by one thread.
__device__ __forceinline__ void mark(int32_t* first, int64_t prev,
                                     int64_t key, int64_t i) {
  for (int64_t k = prev + 1 > 0 ? prev + 1 : 0; k <= key; ++k)
    first[k] = (int32_t)i;
}

// first[k] = i for the tiles k in [from, to], from >= 0 (or none): by
// the CTA's threads.
__device__ __forceinline__ void mark_range(int32_t* first, int64_t from,
                                           int64_t to, int64_t i) {
  for (int64_t k = (from > 0 ? from : 0) + threadIdx.x; k <= to;
       k += kThreads)
    first[k] = (int32_t)i;
}

// Launch 1: each chunk's sum of deltas over [0, n_real), and the seeds'
// descents (seed_idx[s] > seed_idx[s + 1]) in the CTA's stride of them.
__global__ void __launch_bounds__(kThreads)
wire16_sum_kernel(const int16_t* __restrict__ deltas, int64_t n_real,
                  const int32_t* __restrict__ seed_idx, int64_t S,
                  Scratch sc) {
  __shared__ int32_t red[kThreads / 32];
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  int32_t x = 0;  // at most kChunk * 65535 < 2^31
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t i = lo + j * kThreads + threadIdx.x;
    if (i < n_real) x += u16(deltas, i);
  }
  int32_t dn = 0;
  for (int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x; s + 1 < S;
       s += (int64_t)gridDim.x * kThreads)
    dn += seed_idx[s] > seed_idx[s + 1];
  x = block_sum(x, red);
  dn = block_sum(dn, red);
  if (threadIdx.x == 0) {
    sc.csum[blockIdx.x] = x;
    sc.desc[blockIdx.x] = dn;
  }
}

// Launch 2: the int32 positions, the flags, and without a wrap the tile
// boundaries of the entries and, when they are sorted, of the seeds.
__global__ void __launch_bounds__(kThreads)
wire16_scan_kernel(const int16_t* __restrict__ deltas, int64_t n_real,
                   const int32_t* __restrict__ seed_idx, int64_t S,
                   int64_t cells, Scratch sc) {
  __shared__ int64_t red[kThreads / 32];
  __shared__ int32_t wsum[kThreads / 32];
  __shared__ uint16_t d[kChunk];
  __shared__ int32_t p[kChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c = blockIdx.x, C = gridDim.x, lo = c * kChunk;
  const int64_t ntiles = n_tiles(cells);

  // this chunk's exclusive prefix, the total in int64, and the descents
  int64_t before = 0, all = 0, desc = 0;
  for (int64_t k = tid; k < C; k += kThreads) {
    const int64_t v = sc.csum[k];
    all += v;
    if (k < c) before += v;
    desc += sc.desc[k];
  }
  const int64_t base = block_sum(before, red);
  const int64_t total = block_sum(all, red);
  const bool wrap = total > 0x7fffffff;
  const bool sorted = block_sum(desc, red) == 0;
  if (c == 0 && tid == 0) {
    sc.flags[0] = wrap;
    sc.flags[1] = !sorted;
    sc.flags[2] = 0;
  }

  for (int j = 0; j < kScanItems; ++j) {
    const int64_t i = lo + j * kThreads + tid;
    d[j * kThreads + tid] = i < n_real ? (uint16_t)u16(deltas, i) : 0;
  }
  __syncthreads();
  // a thread's items in a row, then an exclusive scan of the threads' sums
  int32_t own = 0;
  for (int j = 0; j < kScanItems; ++j) own += d[tid * kScanItems + j];
  int32_t incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int32_t run = incl - own;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int j = 0; j < kScanItems; ++j) {
    run += d[tid * kScanItems + j];
    p[tid * kScanItems + j] = run;  // inclusive, within the chunk
  }
  __syncthreads();
  for (int j = 0; j < kScanItems; ++j) {
    const int k = j * kThreads + tid;
    const int64_t i = lo + k;
    if (i >= n_real) break;
    const int64_t cell = base + p[k];
    sc.pos[i] = (int32_t)(uint32_t)(uint64_t)cell;  // torch.cumsum's wrap
    if (!wrap && i > 0)
      mark(sc.tstart, tile_of(k == 0 ? base : base + p[k - 1], ntiles),
           tile_of(cell, ntiles), i);
  }
  if (wrap) return;
  // the tiles before the first entry and past the last, spread over the
  // CTA's threads (a gap between two entries is marked by the later one)
  if (c == 0)  // base is 0 there
    mark_range(sc.tstart, 0, n_real ? tile_of(p[0], ntiles) : ntiles, 0);
  if (c == C - 1 && n_real) {
    const int64_t last = base + p[(n_real - 1) % kChunk];
    mark_range(sc.tstart, tile_of(last, ntiles) + 1, ntiles, n_real);
  }
  if (!sorted) return;
  for (int64_t s = c * kThreads + tid + 1; s < S; s += C * kThreads)
    mark(sc.sstart, tile_of(seed_idx[s - 1], ntiles),
         tile_of(seed_idx[s], ntiles), s);
  if (c == 0)
    mark_range(sc.sstart, 0, S ? tile_of(seed_idx[0], ntiles) : ntiles, 0);
  if (c == C - 1 && S)
    mark_range(sc.sstart, tile_of(seed_idx[S - 1], ntiles) + 1, ntiles, S);
}

// Launch 3: a tile of the slabs, written once: filled with INF32 in
// shared memory, then its entries and sorted seeds stored there, then
// written out with 16-byte stores.
__global__ void __launch_bounds__(kThreads)
wire16_tile_kernel(const int16_t* __restrict__ vidx,
                   const int32_t* __restrict__ table, int32_t n_table,
                   int64_t n_real, const int32_t* __restrict__ seeds,
                   int64_t S, int64_t cells, Scratch sc,
                   int32_t* __restrict__ flat) {
  __shared__ __align__(16) int32_t tile[kTile];
  const int tid = threadIdx.x;
  const int64_t k = blockIdx.x, c0 = k * kTile;
  const int64_t c1 = c0 + kTile < cells ? c0 + kTile : cells;
  int4* t4 = reinterpret_cast<int4*>(tile);
  for (int q = tid; q < kTile / 4; q += kThreads)
    t4[q] = make_int4(kInf, kInf, kInf, kInf);
  const bool wrap = sc.flags[0] != 0, sorted = sc.flags[1] == 0;
  __syncthreads();
  if (!wrap) {
    const int64_t hi = sc.tstart[k + 1];
    for (int64_t i = sc.tstart[k] + tid; i < hi; i += kThreads) {
      const int32_t p = sc.pos[i];
      if (p < c0 || p >= c1) continue;
      if (i + 1 < n_real && sc.pos[i + 1] == p) continue;  // the last wins
      tile[p - c0] = value(vidx, table, n_table, i);
    }
    __syncthreads();
    if (sorted) {
      const int64_t shi = sc.sstart[k + 1];
      for (int64_t s = sc.sstart[k] + tid; s < shi; s += kThreads) {
        const int32_t x = seeds[s];
        if (x < c0 || x >= c1) continue;
        if (s + 1 < S && seeds[s + 1] == x) continue;
        tile[x - c0] = seeds[S + s];
      }
      __syncthreads();
    }
  }
  const int64_t n = c1 - c0, n4 = n / 4;
  int4* f4 = reinterpret_cast<int4*>(flat + c0);  // c0 % 4 == 0
  for (int64_t q = tid; q < n4; q += kThreads) f4[q] = t4[q];
  for (int64_t j = 4 * n4 + tid; j < n; j += kThreads) flat[c0 + j] = tile[j];
}

// Launch 4, the fix-up: returns at once unless the positions wrap or the
// seeds are unsorted.  The wrap branch scatters every entry over the
// filled slabs; then the last CTA to finish places the seeds (sorted: in
// parallel, the last of a run of equal cells; unsorted: one thread, in
// stream order).
__global__ void __launch_bounds__(kThreads)
wire16_fix_kernel(const int16_t* __restrict__ vidx,
                  const int32_t* __restrict__ table, int32_t n_table,
                  int64_t n_real, const int32_t* __restrict__ seeds,
                  int64_t S, int64_t cells, Scratch sc,
                  int32_t* __restrict__ flat, int32_t* __restrict__ count) {
  __shared__ int last;
  const bool wrap = sc.flags[0] != 0, sorted = sc.flags[1] == 0;
  if (!wrap && sorted) return;
  if (wrap) {
    if (count && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(count, 1);
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
         i < n_real; i += (int64_t)gridDim.x * kThreads) {
      const int32_t p = sc.pos[i];
      if (p < 0 || p >= cells) continue;  // no trash cell: dropped
      if (i + 1 < n_real && sc.pos[i + 1] == p) continue;
      flat[p] = value(vidx, table, n_table, i);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&sc.flags[2], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int32_t* val = seeds + S;
  if (sorted) {
    for (int64_t s = threadIdx.x; s < S; s += kThreads) {
      const int32_t x = seeds[s];
      if (x < 0 || x >= cells || (s + 1 < S && seeds[s + 1] == x)) continue;
      flat[x] = val[s];
    }
  } else if (threadIdx.x == 0) {
    for (int64_t s = 0; s < S; ++s) {
      const int32_t x = seeds[s];
      if (x >= 0 && x < cells) flat[x] = val[s];
    }
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` of CUDA device `device`, does not
// synchronise, and returns cudaGetLastError() after the launches.
//
// flat[idx[i]] = val[i] for i < n, indices outside [0, trash] to the trash
// cell.  The ragged wire (idx = wire[0], val = wire[1]).
int aln_densify_scatter(int device, const int32_t* idx, const int32_t* val,
                        int64_t n, int64_t trash, int32_t* flat, void* stream) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (n > 0)
    scatter_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        idx, val, n, trash, flat);
  return (int)cudaGetLastError();
}

// int32 words of scratch aln_densify_wire16 needs.
int64_t aln_densify_wire16_scratch_words(int64_t n_real, int64_t cells) {
  return scratch_words(n_real, cells);
}

// The 16-bit wire -> flat[0, cells), every cell written: cells =
// B * V * (V+1) below 2^31, `flat` 16-byte aligned.  `seeds` is (2, S)
// int32 (cells, then values); n_real <= the stream's length; `scratch`
// holds aln_densify_wire16_scratch_words(n_real, cells) int32; `count`,
// if not null, gets 1 added when the wrap branch runs.
int aln_densify_wire16(int device, const int16_t* deltas, const int16_t* vidx,
                       const int32_t* table, int32_t n_table,
                       const int32_t* seeds, int64_t S, int64_t n_real,
                       int64_t cells, int32_t* scratch, int32_t* flat,
                       int32_t* count, void* stream) {
  if (n_table < 1 || S < 0 || S > 0x7fffffff || n_real < 0 ||
      n_real > 0x7fffffff || cells < 1 || cells > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch sc = scratch_at(scratch, n_real, cells);
  const unsigned C = (unsigned)n_chunks(n_real);
  wire16_sum_kernel<<<C, kThreads, 0, st>>>(deltas, n_real, seeds, S, sc);
  wire16_scan_kernel<<<C, kThreads, 0, st>>>(deltas, n_real, seeds, S,
                                             cells, sc);
  wire16_tile_kernel<<<(unsigned)n_tiles(cells), kThreads, 0, st>>>(
      vidx, table, n_table, n_real, seeds, S, cells, sc, flat);
  wire16_fix_kernel<<<kFixGrid, kThreads, 0, st>>>(
      vidx, table, n_table, n_real, seeds, S, cells, sc, flat, count);
  return (int)cudaGetLastError();
}

const char* aln_cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
