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

// The host plane's counter table: per slot, the nanoseconds summed over
// every timed scope and the number of scopes.  aln_trace switches it on
// and off, aln_trace_read reads and resets it (export.cc).  While it is
// off a scope reads no clock and adds nothing.  A scope adds to its
// thread's own sums; trace_flush moves them into the shared table, which
// each worker thread does once, when it ends, and run_pool and
// aln_trace_read do for the calling thread.  The serial scan and a
// teardown, once a call each, add to the table directly.
namespace aln {
enum TraceSlot {
    // sub-slots of a solve (solve_contig / solve_from_graph, wherever it
    // runs): graph build, topo order and anomaly floor, walk DP, the
    // unique-walk rows, lazy enumeration, selection
    kSolveBuild, kTopo, kWalkDp, kFastRows, kLazyEnum, kSelect,
    kParse,     // record and cs parse (parse workers)
    kFormat,    // one contig's output rows formatted
    kScan,      // read_paf's serial scan, wall time
    kBuild,     // the exporter's graph build with ranks (parse workers)
    kFast,      // a device-gated contig: path chase and rows
    kFallback,  // a contig the device gated out, solved on the host
    kFlush,     // flush_three, wall time
    kSolve,     // the exporter's host solve of one contig
    kTeardown,  // one background teardown, wall time, counted at its end
    kTraceSlots
};
extern const char *const trace_names[kTraceSlots];
extern std::atomic<bool> trace_flag;
inline bool trace_on() { return trace_flag.load(std::memory_order_relaxed); }
inline long long trace_clock_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}
void trace_add(int slot, long long ns);    // to this thread's sums
void trace_count(int slot, long long ns);  // to the table
void trace_flush();                        // this thread's sums to the table
// flushes this thread, then reads the table into ns[], n[] and resets it
void trace_take(long long *ns, long long *n);
// one timed scope of ``slot``, added to this thread's sums
struct TraceScope {
    int slot;
    long long t0;
    explicit TraceScope(int s)
        : slot(trace_on() ? s : -1), t0(slot < 0 ? 0 : trace_clock_ns()) {}
    ~TraceScope() {
        if (slot >= 0) trace_add(slot, trace_clock_ns() - t0);
    }
};
}  // namespace aln
