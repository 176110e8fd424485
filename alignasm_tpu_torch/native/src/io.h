// PAF dataset IO: fast tokenizing reader, alt-PAF merge, output writers.
// Parity: alignasm.cpp:76-332 (parse/merge), :398-490 (writers), via the
// validated Python engine (alignasm_tpu/io/paf.py).
#pragma once

#include <functional>
#include <string>
#include <string_view>
#include <unordered_map>

#include "types.h"

namespace aln {

// heterogeneous string_view lookup: the parse loops run one lookup per
// line, and materializing a std::string key per line was the dominant
// serial cost of read_paf
struct SvHash {
    using is_transparent = void;
    size_t operator()(std::string_view s) const {
        return std::hash<std::string_view>{}(s);
    }
};
struct SvEq {
    using is_transparent = void;
    bool operator()(std::string_view a, std::string_view b) const {
        return a == b;
    }
};
template <typename V>
using StrMap = std::unordered_map<std::string, V, SvHash, SvEq>;

// read-only file mapping (zero-copy input buffer for the sharded
// parse; pages are shared across ranks through the page cache)
struct Mapped {
    const char *p = nullptr;
    size_t n = 0;
    Mapped() = default;
    Mapped(const Mapped &) = delete;
    Mapped &operator=(const Mapped &) = delete;
    ~Mapped();
};

struct Dataset {
    std::string buffer;       // whole main PAF file (records view into it)
    std::unique_ptr<Mapped> mapped;  // range-mode input (views point here)
    std::string alt_buffer;   // whole alt PAF file
    // merge_alt's alt lines read and records appended to contigs
    i64 alt_records = 0, alt_merged = 0;
    std::vector<std::vector<Record>> contigs;
    std::vector<std::string> ctg_names;
    std::vector<std::string> chr_names;               // id -> name
    StrMap<i32> chr_ids;                              // name -> id
    StrMap<i32> paf_map;                              // qry name -> contig
    // match-run storage the records' RunSpans point into (one arena
    // per parse worker + one for the alt merge); block addresses are
    // stable, so moving the Dataset keeps every span valid
    std::vector<std::unique_ptr<RunArena>> run_arenas;
    // this rank's contig-group range under a sharded parse: groups
    // [shard_lo, shard_hi) are owned (CONTIGUOUS, record-balanced —
    // contiguity makes the multihost merge a pure blob concatenation
    // and lets rank 0 write its own slice straight into the outputs);
    // world == 1 owns everything
    i64 shard_lo = 0, shard_hi = 0;
};

// Optional fused-pipeline hook for read_paf: when given, `start` runs
// once (serially) after the contig count is known, then `group` is
// called from the parse workers as each contig group's records become
// complete — the caller can solve + format a contig while later groups
// are still parsing.  Only ds.contigs[g], ds.ctg_names, ds.chr_names
// and ds.paf_map may be read from `group` (all complete by then);
// other contigs are still being written concurrently.  `scan_s` is
// filled with the time spent before the parallel parse began.
struct GroupSink {
    std::function<void(Dataset &, size_t)> start;
    std::function<void(Dataset &, size_t)> group;
    double scan_s = 0;
};

// rank/world shard the PARSE by contig group: the cheap line/name index
// scan still covers the whole file (group boundaries and global row
// provenance need it), but the expensive per-record field parse + cs
// scan runs only for owned groups — a CONTIGUOUS record-balanced range
// [ds.shard_lo, ds.shard_hi), identical on every rank — the others
// stay empty vectors (ctg_names/paf_map are still global, so indices
// and alt-merge targeting are identical to a full parse).  world == 1
// is the ordinary full parse.
Dataset read_paf(const std::string &path, int threads = 1,
                 GroupSink *sink = nullptr, i64 rank = 0, i64 world = 1);

// BYTE-RANGE sharded parse (the fused multihost fast path): rank r
// field-scans ONLY its ~1/world byte slice — slice bounds are the
// first contig-group start at/after byte r*S/world, derived locally
// and identically by adjacent ranks — and memchr-counts the prefix
// lines so cord_row provenance stays GLOBAL.  The returned Dataset
// holds only the rank's groups (contigs/ctg_names/paf_map are LOCAL;
// shard_lo/hi = [0, n_local)); chromosome interning is local, which
// is byte-safe because ref_chr ids are only ever compared for
// equality and resolved back to names (solver.cc:37,41, io.cc
// writer).  n_lines_out receives the GLOBAL non-empty line count
// (the cross-rank consistency token).  Unlike read_paf, this path
// cannot serve an alt merge (alt targeting needs the global
// last-wins name map) — aln_run_shard falls back to read_paf there.
Dataset read_paf_range(const std::string &path, int threads,
                       GroupSink *sink, i64 rank, i64 world,
                       i64 *n_lines_out);
void merge_alt(Dataset &ds, const std::string &alt_path, double alt_baseline,
               i64 rank = 0, i64 world = 1);

// writes one output stream; rows_per_ctg[i] aligns with ds.contigs[i].
// max mode suffixes ".<cnt>" per tied path group.
void write_rows(const Dataset &ds, const std::vector<std::vector<OutRow>> &rows,
                const std::string &path, int threads = 1);
void write_max_rows(const Dataset &ds,
                    const std::vector<std::vector<std::vector<OutRow>>> &rows,
                    const std::string &path, int threads = 1);

// per-contig formatting pieces of the writers above, for callers that
// fuse output formatting into their own worker pool (api.cc: the solve
// workers format each contig's rows right after solving it, so the
// write phase is just the ordered flush)
void format_rows_one(std::string &out, const Dataset &ds, size_t i,
                     const std::vector<OutRow> &rows);
// chunked parallel form for big contigs (order-identical output);
// falls back to the serial loop below ~16k rows
void format_rows_parallel(std::string &out, const Dataset &ds, size_t i,
                          const std::vector<OutRow> &rows, int threads);
void format_max_rows_one(std::string &out, const Dataset &ds, size_t i,
                         const std::vector<std::vector<OutRow>> &groups);
void flush_parts_file(const std::string &path,
                      const std::vector<std::string> &parts);
// append parts[lo, hi) onto an open fd through a 4 MB staging buffer
// (batches 10^5 tiny part writes into memcpy-bound write() calls)
void write_parts_fd(int fd, const std::vector<std::string> &parts,
                    i64 lo, i64 hi);

// flush the three output PAFs (<prefix>.aln[.alt|.all].paf) from
// per-contig parts, concurrently unless threads == 1; throws on the
// first file error
void flush_three(const std::string &prefix,
                 const std::vector<std::string> &out,
                 const std::vector<std::string> &alt,
                 const std::vector<std::string> &max, int threads);

// ---- page population (heap.cc) ----------------------------------------
// populate [p, p+len) as if written (one syscall, ~50-500x cheaper than
// demand faulting under this hypervisor's page tracking); no-op where
// MADV_POPULATE_WRITE is unsupported
size_t populate_range(void *p, size_t len);
// the page butler scans /proc/self/maps while any scope is alive and
// populates newly-appeared anon-RW extents ahead of the workers
void butler_begin();
void butler_end();
struct ButlerScope {
    ButlerScope() { butler_begin(); }
    ~ButlerScope() { butler_end(); }
    ButlerScope(const ButlerScope &) = delete;
    ButlerScope &operator=(const ButlerScope &) = delete;
};

// Run ``fn`` (a bulk teardown: free()ing 10^5-10^6 small heap blocks)
// on a background thread so the caller's path doesn't pay for it.  The
// thread is kept JOINABLE in a registry — aln_drain_teardowns() joins
// every pending one, so benchmark loops can keep back-to-back reps
// from competing with the previous rep's frees without serializing
// production callers (which never drain).
void async_teardown(std::function<void()> fn);

}  // namespace aln

// heap retention knobs (heap.cc); exported to ctypes, safe to call early
// and often (applies once per process)
extern "C" void aln_tune_heap(void);
