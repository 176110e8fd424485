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
// the sweeps are dependent steps (a row's shuffles and votes, two barriers),
// so their latency, not the bytes, is what the design cuts: it recomputes
// only the rows that can change and spreads a row over lanes.
//
// Design, one CTA a contig (two an SM at V = 512, K = 16):
//   1. compact: the warps read wk1 row by row, coalesced, eight 32-column
//      loads in flight a lane; a warp ballots the valid cells (wk1 < INF,
//      negative keys included) into a per-warp buffer and then claims the
//      row's slice of a CSR of kEdgesPerVertex V edges (column and key) in
//      shared memory.  A row of more than kRowCap edges, or one that finds
//      the CSR full, reads its valid cells in place each time it runs.
//   2. keys in `ord` space: tk holds ord(x) = x - 1 + 2^63 (mod 2^64), in
//      which top_k(-cand)'s order is the unsigned one and adding an edge
//      key commutes (ord(x + k) = ord(x) + k), one buffer of V K words.
//   3. frontier: row u after sweep s depends only on its children's rows
//      after sweep s - 1, and dest's row never changes, so sweep 1 computes
//      every other row and a later sweep only the rows one of whose
//      children changed in the sweep before (a V-bit mask; a row read in
//      place always runs).  Skipping an unchanged row changes no bit.  The
//      active rows are compacted by ballots into a list; the sweeps stop at
//      the first sweep that changes no row, as the literal loop would, and
//      their sum is added to the caller's `sweeps` word when given.
//   4. lanes over a row (K <= 32): a group of G = min(next_pow2(K), 8)
//      lanes takes one active row, R = next_pow2(K) / G keys a lane (the
//      row's element r G + l in lane l's register r; elements >= K: the
//      order's last value, -2^63's).  A row starts as its virtual
//      candidates: INF when its degree is under V (at least K of them),
//      else -2^63 (the last value, which any real candidate ties or beats).
//      Each child's list plus the edge key is a sorted run unless the sum
//      carries past 2^64 for some elements but not all (then a rotation,
//      undone by shuffles).  The first run into a row is an element-wise
//      minimum; a later one takes the minimum against the run reversed (a
//      bitonic sequence holding the G R smallest) and sorts it with log2
//      (G R) compare-exchange stages, in registers and by __shfl_xor_sync.
//      The result is the K smallest multiset whatever the edge order, so it
//      equals top_k's output bit for bit.  The warp's groups step through
//      their rows' edges together, a group without an edge at a step
//      feeding nothing, so every shuffle and vote takes the full mask; the
//      change test is one ballot.  A group's first row of a sweep stays in
//      its registers across the barrier; the next `groups` rows stage in
//      shared memory and the rest (sweep 1 and the few after it) in the
//      caller's `out`, which holds nothing before the final copy.  K > 32
//      takes a thread a row instead: its children's sorted runs merged from
//      the back in `out`, a wrapped one by insertion.
// Shared memory (layout()): 8 V K bytes of keys, 40 V of CSR, 8 V of row
// starts and degrees and two active lists, two V-bit masks and the staging
// rows: 96 KB at V = 512, K = 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kInf = int64_t(1) << 62;
constexpr uint64_t kBias = (uint64_t(1) << 63) - 1;  // ord(x) = x + kBias
constexpr uint64_t kLast = ~uint64_t(0);  // ord(-2^63): the order's last
constexpr uint64_t kOrdInf = uint64_t(kInf) + kBias;
constexpr int kUnroll = 8;    // 32-column loads in flight a lane
constexpr int kMaxThreads = 512;
constexpr int kRowCap = 32;   // edges of a row the CSR holds (one ballot)
constexpr int kGroupLanes = 8;  // lanes a row at most: 64 rows at a time
constexpr int kEdgesPerVertex = 4;  // the CSR's budget, 4 V edges a contig
constexpr uint16_t kInPlace = 0xffff;  // row start: read the row in place
// the opt-in limit of a block; it keeps V < 4,000, so a uint16 holds a
// column, a CSR offset and a degree
constexpr int64_t kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// A row's route: N = next_pow2(K) keys as lanes_of(K) = min(N, kGroupLanes)
// lanes of keys_of(K) = N / lanes keys each for K <= 32; 0 (a thread a
// row) above.
__host__ __device__ inline int pow2_at_least(int32_t K) {
  int n = 1;
  while (n < K) n <<= 1;
  return n;
}
__host__ __device__ inline int lanes_of(int32_t K) {
  if (K > 32) return 0;
  const int n = pow2_at_least(K);
  return n < kGroupLanes ? n : kGroupLanes;
}
__host__ __device__ inline int keys_of(int32_t K) {
  return K > 32 ? 0 : pow2_at_least(K) / lanes_of(K);
}

// Byte offsets of the shared arrays at (V, K) and the launch's shape.
struct Layout {
  int threads, groups, stage;
  int64_t ekey, stg, mask, cnt, rinfo, ecol, act, total;
};

__host__ __device__ inline Layout layout(int32_t V, int32_t K) {
  Layout L;
  L.threads = V >= kMaxThreads ? kMaxThreads : (V + 31) / 32 * 32;
  const int G = lanes_of(K);
  L.groups = G ? L.threads / G : L.threads;
  L.stage = G ? L.groups : 0;  // staging rows in shared memory
  const int64_t E = (int64_t)kEdgesPerVertex * V;
  const int64_t stg = 8 * (int64_t)L.stage * K;
  const int64_t wbuf = (int64_t)(L.threads / 32) * kRowCap * 10;
  int64_t o = 8 * (int64_t)V * K;  // tk at 0
  L.ekey = o;
  o += 8 * E;
  L.stg = o;  // the staging rows, and the warps' buffers while compacting
  o += stg > wbuf ? stg : wbuf;
  L.mask = o;
  o += 8 * (int64_t)((V + 31) / 32);
  L.cnt = o;
  o += 16;
  L.rinfo = o;  // a row's CSR start | its degree << 16
  o += 4 * (int64_t)V;
  L.ecol = o;
  o += 2 * E;
  L.act = o;
  o += 4 * (int64_t)V;
  L.total = o;
  return L;
}

// The active rows of the next sweep into A (count *n, zeroed before): every
// row but dest's when `first`, else the rows read in place and those with a
// child whose bit is set in M (four children tested at a time).
__device__ void frontier(bool first, const uint32_t* M, uint16_t* A, int* n,
                         int32_t V, int32_t d, const uint32_t* rinfo,
                         const uint16_t* ecol) {
  const int lane = threadIdx.x & 31;
  for (int u0 = threadIdx.x - lane; u0 < V; u0 += blockDim.x) {
    const int u = u0 + lane;
    bool a = false;
    if (u < V && u != d) {
      const uint32_t ri = rinfo[u];
      const int st = ri & 0xffff, deg = ri >> 16;
      a = first || st == kInPlace;
      for (int e0 = 0; !a && e0 < deg; e0 += 4) {
        int v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[t] = ecol[st + (e0 + t < deg ? e0 + t : deg - 1)];
#pragma unroll
        for (int t = 0; t < 4; ++t) a |= (M[v[t] >> 5] >> (v[t] & 31)) & 1u;
      }
    }
    const unsigned m = __ballot_sync(kFull, a);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(n, __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (a) A[base + __popc(m & ((1u << lane) - 1u))] = (uint16_t)u;
  }
}

// A row in a group of G lanes, R keys a lane: element e = r G + l of the
// row's N = G R keys (ascending, ord space; elements >= K hold the last
// value or a genuine candidate past the K-th) is lane l's x[r].  `base` is
// the group's first lane in the warp, `gm` its lanes' mask.  Every warp
// collective below is called by the whole warp (all its groups, with or
// without a row or an edge at this step) with the full mask, so it
// compiles to one instruction without convergence checks.
template <int G, int R>
struct Group {
  int l, base;
  unsigned gm;
  static constexpr int N = G * R;

  __device__ __forceinline__ uint64_t shfl(uint64_t v, int src) const {
    return __shfl_sync(kFull, v, base + src);
  }
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(kFull, p) & gm) >> base;
  }

  // y = the run c sorted: element e of a run rotated by m (its least key
  // at element m) is c's element (e + m) mod K, the last value past K
  __device__ __forceinline__ void rotate(uint64_t (&y)[R],
                                         const uint64_t (&c)[R], int m,
                                         int K) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = r * G + l;
      const int i = q < K ? (q + m < K ? q + m : q + m - K) : 0;
      uint64_t v = kLast;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const uint64_t z = shfl(c[t], i % G);
        if (i / G == t) v = z;
      }
      y[r] = q < K ? v : kLast;
    }
  }

  // One step of a row's merge: x = the N smallest of x and key + L[0 .. K)
  // for a group that `has` an edge (L its child's keys), x unchanged for
  // one that has none.  The elements whose sum carried past 2^64 are a
  // suffix of the run, its least keys, when some but not all carried: the
  // run is then rotated back to sorted order first.  The group's first edge
  // (x only its virtual candidates, constant below K) takes the
  // element-wise minimum of x and the sorted run; a later one the minimum
  // against the run reversed, a bitonic sequence that holds the N
  // smallest, sorted by log2 N compare-exchange stages (in registers for
  // strides of G or more, by shuffles below), which leave a sorted row
  // as it is.
  __device__ __forceinline__ void step(uint64_t (&x)[R], bool has,
                                       const uint64_t* L, uint64_t key,
                                       bool& first, int K) const {
    uint64_t c[R], y[R];
    int m = N, carried = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * G + l;
      const bool in = has && e < K;
      const uint64_t o = in ? L[e] : kLast;
      c[r] = in ? o + key : kLast;
      const unsigned bits = ballot(in && c[r] < o);
      carried += __popc(bits);
      if (bits && m == N) m = r * G + __ffs(bits) - 1;
    }
    m = carried != 0 && carried != K ? m : 0;
    if (__any_sync(kFull, m != 0)) {
      uint64_t z[R];
      rotate(z, c, m, K);
#pragma unroll
      for (int r = 0; r < R; ++r) c[r] = z[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      y[r] = __shfl_xor_sync(kFull, c[R - 1 - r], G - 1);
    const bool later = has && !first;
    bool take = false;
    if (has && first) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = c[r] < x[r] ? c[r] : x[r];
      first = false;
    }
    if (later) {
#pragma unroll
      for (int r = 0; r < R; ++r) take |= y[r] < x[r];
    }
    if (!__any_sync(kFull, take)) return;
    if (later) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = y[r] < x[r] ? y[r] : x[r];
    }
#pragma unroll
    for (int s = N / 2; s >= 1; s >>= 1) {
      if (s >= G) {
        const int h = s / G;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & h) continue;
          const uint64_t lo = x[r] < x[r | h] ? x[r] : x[r | h];
          const uint64_t hi = x[r] < x[r | h] ? x[r | h] : x[r];
          x[r] = lo;
          x[r | h] = hi;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint64_t w = __shfl_xor_sync(kFull, x[r], s);
          x[r] = (l & s) ? (w > x[r] ? w : x[r]) : (w < x[r] ? w : x[r]);
        }
      }
    }
  }
};

// c into the sorted row r (ord space) if it beats the row's last
__device__ __forceinline__ void insert(uint64_t* r, uint64_t c, int K) {
  if (c >= r[K - 1]) return;
  int p = K - 1;
  while (p > 0 && r[p - 1] > c) {
    r[p] = r[p - 1];
    --p;
  }
  r[p] = c;
}

// A thread's merge (K > 32): the K smallest of the sorted row r and
// key + L[j] (L a sorted child list, both in ord space).
__device__ __forceinline__ void merge_list(uint64_t* r, const uint64_t* L,
                                           uint64_t key, int K) {
  if (L[0] + key > L[K - 1] + key) {
    // the sum carries inside the list: not a sorted run
    for (int j = 0; j < K; ++j) insert(r, L[j] + key, K);
    return;
  }
  int m = 0;  // candidates that enter: c[m] < the row's (K-1-m)-th
  while (m < K && L[m] + key < r[K - 1 - m]) ++m;
  int i = K - m - 1, p = K - 1;
  for (int j = m - 1; j >= 0; --p) {
    const uint64_t c = L[j] + key;
    if (i >= 0 && r[i] > c) {
      r[p] = r[i--];
    } else {
      r[p] = c;
      --j;
    }
  }
}

template <int G, int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
topk_kernel(const int64_t* __restrict__ wk1, const int32_t* __restrict__ dest,
            int32_t V, int32_t K, int32_t n_sweeps, int* sweeps,
            int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(V, K);
  uint64_t* tk = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ekey = reinterpret_cast<uint64_t*>(smem + L.ekey);
  uint64_t* stg = reinterpret_cast<uint64_t*>(smem + L.stg);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L.mask);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);  // active counts, pool
  uint32_t* rinfo = reinterpret_cast<uint32_t*>(smem + L.rinfo);
  uint16_t* ecol = reinterpret_cast<uint16_t*>(smem + L.ecol);
  uint16_t* act = reinterpret_cast<uint16_t*>(smem + L.act);
  const int64_t b = blockIdx.x;
  const int64_t* w = wk1 + b * V * V;
  // the caller's rows of this contig, the staging overflow until the end
  uint64_t* ob = reinterpret_cast<uint64_t*>(out + b * V * K);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int MW = (V + 31) >> 5;
  const int32_t d = dest[b];
  const int32_t r0 = d < 0 ? d + V : d;  // base's 0, as JAX's index

  if (tid < 4) cnt[tid] = 0;
  for (int i = tid; i < 2 * MW; i += nthr) mask[i] = 0;
  __syncthreads();

  // 1. compact each row's valid cells into the CSR
  {
    uint64_t* wkey = stg + warp * kRowCap;
    uint16_t* wcol =
        reinterpret_cast<uint16_t*>(stg + nwarps * kRowCap) + warp * kRowCap;
    const int E = kEdgesPerVertex * V;
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
          const unsigned m = __ballot_sync(kFull, valid);
          const int pos = n + __popc(m & ((1u << lane) - 1u));
          if (valid && pos < kRowCap) {
            wkey[pos] = (uint64_t)k[i];
            wcol[pos] = (uint16_t)(c0 + 32 * i + lane);
          }
          n += __popc(m);
        }
      }
      __syncwarp();
      int start = kInPlace;
      if (n <= kRowCap) {
        int off = 0;
        if (lane == 0 && n > 0) off = atomicAdd(&cnt[2], n);
        off = __shfl_sync(kFull, off, 0);
        if (off + n <= E) start = off;
      }
      if (start != kInPlace && lane < n) {
        ekey[start + lane] = wkey[lane];
        ecol[start + lane] = wcol[lane];
      }
      if (lane == 0) rinfo[u] = (uint32_t)start | (uint32_t)n << 16;
      __syncwarp();
    }
  }
  for (int i = tid; i < V * K; i += nthr) {
    const int u = i / K, j = i - u * K;
    tk[i] = (j == 0 && u == r0) ? kBias : kOrdInf;
  }
  __syncthreads();
  frontier(true, mask, act, &cnt[0], V, d, rinfo, ecol);
  __syncthreads();

  // 2. the sweeps, each over its active rows, stopped at the fixed point
  constexpr int GW = G ? G : 1;  // lanes a group
  constexpr int RW = G ? R : 1;
  const int grp = tid / GW;
  Group<GW, RW> g;
  g.l = tid & (GW - 1);
  g.base = lane & ~(GW - 1);
  g.gm = GW == 32 ? kFull : ((1u << GW) - 1u) << g.base;
  // where active row i of a sweep stages its keys: the lane route keeps
  // each group's first row in registers, the next `stage` rows in shared
  // memory, the rest in `ob`
  auto staged = [&](int i) {
    const int r = i - L.groups;
    return r >= 0 && r < L.stage ? stg + r * K : ob + (int64_t)i * K;
  };
  int ran = 0;
  for (int s = 0; s < n_sweeps; ++s) {
    const int c = s & 1;
    const uint16_t* A = act + c * V;
    uint32_t* M = mask + c * MW;  // this sweep's changed rows, zeroed
    const int nact = cnt[c];
    if (tid == 0) cnt[c ^ 1] = 0;
    uint64_t keep[RW];      // the group's first row, kept across the barrier
    uint64_t changed = 0;   // bit k: the group's k-th row changed
    if constexpr (G > 0) {
      // the warp's groups take rows grp, grp + groups, ... together
      for (int k = 0, i = grp; k * L.groups + warp * (32 / G) < nact;
           ++k, i += L.groups) {
        const bool has_row = i < nact;
        const int u = has_row ? A[i] : 0;
        const uint32_t ri = has_row ? rinfo[u] : 0;
        const int st = ri & 0xffff, n = ri >> 16;
        const bool in_place = has_row && st == kInPlace;
        const int ncsr = in_place ? 0 : n;
        uint64_t x[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          x[r] = r * G + g.l < K && n < V ? kOrdInf : kLast;
        bool first = true;
        for (int e = 0; __any_sync(kFull, e < ncsr); ++e) {
          const bool has = e < ncsr;
          const int j = has ? st + e : 0;
          g.step(x, has, tk + (has ? ecol[j] : 0) * K, ekey[j], first, K);
        }
        if (__any_sync(kFull, in_place)) {
          // a row read in place: its valid cells, G columns a chunk
          const int64_t* row = w + (int64_t)u * V;
          for (int c0 = 0; c0 < V; c0 += G) {
            const int col = c0 + g.l;
            const int64_t key = in_place && col < V ? __ldg(row + col) : kInf;
            unsigned bits = g.ballot(key < kInf);
            while (__any_sync(kFull, bits != 0)) {
              const bool has = bits != 0;
              const int t = has ? __ffs(bits) - 1 : 0;
              bits &= bits - 1;
              g.step(x, has, tk + (c0 + t) * K, g.shfl((uint64_t)key, t),
                     first, K);
            }
          }
        }
        bool diff = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e = r * G + g.l;
          diff |= has_row && e < K && x[r] != tk[u * K + e];
        }
        if (g.ballot(diff)) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int e = r * G + g.l;
            if (k == 0) keep[r] = x[r];
            else if (e < K) staged(i)[e] = x[r];
          }
          if (g.l == 0) atomicOr(&M[u >> 5], 1u << (u & 31));
          changed |= uint64_t(1) << k;
        }
      }
    } else {
      for (int i = grp, k = 0; i < nact; i += L.groups, ++k) {
        const int u = A[i];
        const uint32_t ri = rinfo[u];
        const int st = ri & 0xffff, n = ri >> 16;
        uint64_t* r = staged(i);
        const uint64_t fill = n < V ? kOrdInf : kLast;
        for (int j = 0; j < K; ++j) r[j] = fill;
        if (st != kInPlace) {
          for (int e = 0; e < n; ++e)
            merge_list(r, tk + ecol[st + e] * K, ekey[st + e], K);
        } else {
          const int64_t* row = w + (int64_t)u * V;
          for (int v = 0; v < V; ++v) {
            const int64_t key = __ldg(row + v);
            if (key < kInf) merge_list(r, tk + v * K, (uint64_t)key, K);
          }
        }
        bool ch = false;
        for (int j = 0; j < K; ++j) ch |= r[j] != tk[u * K + j];
        if (ch) {
          atomicOr(&M[u >> 5], 1u << (u & 31));
          changed |= uint64_t(1) << k;
        }
      }
    }
    ++ran;
    if (!__syncthreads_or(changed != 0)) break;
    // write the changed rows back, then build the next sweep's frontier
    for (int i = grp, k = 0; k < 64 && changed >> k; i += L.groups, ++k) {
      if (!((changed >> k) & 1)) continue;
      const int u = A[i];
      if constexpr (G > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e = r * G + g.l;
          if (e < K) tk[u * K + e] = k == 0 ? keep[r] : staged(i)[e];
        }
      } else {
        const uint64_t* r = staged(i);
        for (int j = 0; j < K; ++j) tk[u * K + j] = r[j];
      }
    }
    for (int i = tid; i < MW; i += nthr) mask[(c ^ 1) * MW + i] = 0;
    frontier(false, M, act + (c ^ 1) * V, &cnt[c ^ 1], V, d, rinfo, ecol);
    __syncthreads();
  }

  for (int i = tid; i < V * K; i += nthr)
    out[b * V * K + i] = (int64_t)(tk[i] - kBias);
  if (tid == 0 && sweeps != nullptr) atomicAdd(sweeps, ran);
}

template <int G, int R>
cudaError_t launch(const int64_t* wk1, const int32_t* dest, int64_t B,
                   int32_t V, int32_t K, int32_t n_sweeps, int* sweeps,
                   int64_t* out, cudaStream_t stream) {
  const Layout L = layout(V, K);
  const size_t smem = (size_t)L.total;
  cudaError_t rc = cudaFuncSetAttribute(
      topk_kernel<G, R>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess && smem > 48 * 1024)
    rc = cudaFuncSetAttribute(topk_kernel<G, R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  if (rc != cudaSuccess) return rc;
  topk_kernel<G, R><<<(unsigned)B, L.threads, smem, stream>>>(
      wk1, dest, V, K, n_sweeps, sweeps, out);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block of the kernel takes at (V, K); a launch
// above 227 KB is refused.
extern "C" int64_t aln_topk_smem_bytes(int32_t V, int32_t K) {
  return layout(V, K).total;
}

// Launches on `stream` of CUDA device `device`, does not synchronise, and
// returns cudaGetLastError() after the launch.  `wk1` is (B, V, V) int64,
// `dest` (B,) int32, `out` (B, V, K) int64 (also the kernel's scratch until
// it writes the result); a negative n_sweeps runs none.  Adds the sweeps
// run, summed over the contigs, to the one int32 at `sweeps` unless that is
// null.
extern "C" int aln_topk(int device, const int64_t* wk1, const int32_t* dest,
                        int64_t B, int32_t V, int32_t K, int32_t n_sweeps,
                        int* sweeps, int64_t* out, void* stream) {
  if (V < 1 || K < 1 || B < 0 || B > 0x7fffffff ||
      layout(V, K).total > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (B == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_of(K) * 4 + keys_of(K)) {
#define ALN_TOPK_ROUTE(G, R) \
  case G * 4 + R:            \
    return (int)launch<G, R>(wk1, dest, B, V, K, n_sweeps, sweeps, out, s);
    ALN_TOPK_ROUTE(1, 1)
    ALN_TOPK_ROUTE(2, 1)
    ALN_TOPK_ROUTE(4, 1)
    ALN_TOPK_ROUTE(8, 1)
    ALN_TOPK_ROUTE(8, 2)
    ALN_TOPK_ROUTE(8, 4)
#undef ALN_TOPK_ROUTE
    default:
      return (int)launch<0, 0>(wk1, dest, B, V, K, n_sweeps, sweeps, out, s);
  }
}
