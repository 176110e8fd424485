// Per-contig solver: DAG build, anomaly floor, lazy k-shortest walks,
// gap upgrade, tie sweep, alt selection.
//
// Mirrors the validated Python exact engine (alignasm_tpu/engine/
// graph.py, kshortest.py, exact.py); reference behavior documented
// there (solve_ctg_read, paf_data.cpp:223-1650).
#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <unordered_map>

#include "types.h"

namespace aln {

struct ContigResult {
    std::vector<OutRow> out;
    std::vector<OutRow> alt;
    std::vector<std::vector<OutRow>> max_out;
};

// records: the contig's records in input order (ctg_index == position);
// sorted_index is written back into each record.
ContigResult solve_contig(std::vector<Record> &records, const Config &cfg);

// steps 6-10 of solve_ctg_read on an already-built DAG (records'
// sorted_index set by build_graph)
struct Graph;
ContigResult solve_from_graph(const Graph &g, const Config &cfg);

// device-assisted finish for the provably order-insensitive case
// (unique best walk, no alt scan); verts = the device-chased min-walk
// vertex sequence src..dest
ContigResult finish_from_path(const Graph &g, const i32 *verts, int n,
                              const Config &cfg);

// ---- graph internals, exposed for the device-engine export ABI ------

struct Edge {
    i32 to;
    Dist w;
};

// A graph vertex is either one record (pre==cur) or a cut overlap pair.
struct Graph {
    i64 n = 0;  // record count
    std::vector<const Record *> recs;      // sorted order
    std::vector<i64> part_idx;
    std::vector<i64> parts;                // part starts + sentinel n
    std::vector<std::pair<i32, i32>> vtx;  // (pre, cur) per vertex id
    // key i*n+j -> vertex id (i<j): insert-then-lookup only, so a flat
    // linear-probe table replaces unordered_map (whose per-insert node
    // mallocs were ~22% of the pipeline's remaining allocation sites)
    struct PairMap {
        std::vector<std::pair<i64, i32>> slots;  // key -> val, key -1 = empty
        size_t mask = 0, count = 0;
        void clear() {
            count = 0;
            std::fill(slots.begin(), slots.end(), std::pair<i64, i32>{-1, -1});
        }
        void grow(size_t want) {
            size_t cap = 16;
            while (cap < want * 2) cap <<= 1;
            if (cap <= slots.size()) return;
            std::vector<std::pair<i64, i32>> old = std::move(slots);
            slots.assign(cap, {-1, -1});
            mask = cap - 1;
            for (auto &[k, v] : old)
                if (k != -1) put_nogrow(k, v);
        }
        void put_nogrow(i64 k, i32 v) {
            size_t h = (size_t) k * 0x9e3779b97f4a7c15ull & mask;
            while (slots[h].first != -1) h = (h + 1) & mask;
            slots[h] = {k, v};
        }
        void put(i64 k, i32 v) {
            if ((count + 1) * 2 > slots.size()) grow(count + 1);
            put_nogrow(k, v);
            count++;
        }
        i32 get(i64 k) const {
            if (!count) return -1;
            size_t h = (size_t) k * 0x9e3779b97f4a7c15ull & mask;
            while (slots[h].first != -1) {
                if (slots[h].first == k) return slots[h].second;
                h = (h + 1) & mask;
            }
            return -1;
        }
    };
    PairMap pair_vtx;
    // cut tables per vertex id (aligned with vtx)
    std::vector<i64> cut_pe_q, cut_pe_r;   // edited end of record i
    std::vector<i64> cut_st_q, cut_st_r;   // edited start of record j
    // adj MAY be oversized when the Graph is a reused scratch object
    // (build_graph_into) — always bound vertex loops by nv(), not
    // adj.size().  Freshly built graphs (build_graph) are exact-sized.
    std::vector<std::vector<Edge>> adj;
    i32 src = 0, dest = 0;

    // vertex count: src = vtx.size() and dest = src + 1 by construction
    i64 nv() const { return (i64) dest + 1; }

    i32 vid(i64 i, i64 j) const {
        if (i == j) return (i32) i;
        return pair_vtx.get(i * n + j);
    }
};

Graph build_graph(std::vector<Record> &records, const Config &cfg);

// Process-wide helper budget shared by intra-contig build parallelism
// (a mega-contig's cut sweep + edge construction run chunked on helper
// threads while the pool's other workers sit idle at the end of a
// parse) and io.cc's chunked big-contig formatting.  The pipeline
// owner sets the cap to its worker count - 1; the default 0 means
// standalone solve_contig calls never spawn.  Byte-identity: chunk
// results are spliced in the exact serial order either way (see
// build_graph_into / format_rows_parallel).
void set_solver_helper_cap(int cap);
// Acquire up to ``want`` helper slots from the SHARED process-wide
// budget (one counter for build + formatting helpers, so concurrent
// mega-contig builds and >=16k-row formats cannot jointly oversubscribe
// the machine); returns how many were granted.  Always release the
// same count.
int acquire_solver_helpers(int want);
void release_solver_helpers(int n);

// scratch-reusing form: clears and refills `g`, keeping every
// container's capacity (adj is only grown, never shrunk — the
// per-vertex edge vectors' capacity is the point of the reuse)
void build_graph_into(std::vector<Record> &records, const Config &cfg,
                      Graph &g);

}  // namespace aln

// env-gated solve sub-phase attribution (ALN_SOLVE_PROF=1): global
// nanosecond counters accumulated by solve_contig/solve_from_graph,
// printed + reset by aln_run_stats2
namespace aln {
extern std::atomic<long long> solve_prof_ns[8];
extern const char *const solve_prof_names[8];
bool solve_prof_on();
// RAII accumulator for one slot (no-op when ALN_SOLVE_PROF unset)
struct SolveProfScope {
    int slot;
    bool on;
    std::chrono::steady_clock::time_point t0;
    explicit SolveProfScope(int s)
        : slot(s), on(solve_prof_on()),
          t0(on ? std::chrono::steady_clock::now()
                : std::chrono::steady_clock::time_point{}) {}
    ~SolveProfScope() {
        if (on)
            solve_prof_ns[slot].fetch_add(
                std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count(),
                std::memory_order_relaxed);
    }
};
}  // namespace aln
