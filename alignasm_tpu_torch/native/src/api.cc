// C ABI for the native pipeline (ctypes-friendly).
//
// aln_run_stats2(): the full reference-equivalent pipeline — read PAF
// (+ optional alt merge), solve every contig on a thread pool, write
// the three output PAFs, reporting phase timings + counters.  The
// threading model mirrors the reference's contig-level task
// parallelism (alignasm.cpp:346-361) with dynamic chunking for skewed
// contig sizes.
#include <atomic>
#include <mutex>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <exception>
#include <fstream>
#include <string>
#include <thread>

#include <cerrno>
#include <fcntl.h>
#include <unistd.h>

#include "io.h"
#include "solver.h"

// phase timings + counters reported back through aln_run_stats2
struct AlnStats {
    double read_s, solve_s, write_s;
    long long contigs, records;
};

#include "scoring_abi.h"

namespace {

void set_err(char *err, int errlen, const std::string &msg) {
    if (err && errlen > 0) {
        std::snprintf(err, (size_t) errlen, "%s", msg.c_str());
    }
}

}  // namespace

extern "C" {

int aln_run_stats2(const char *paf_path, const char *alt_path, double alt_baseline,
                   int non_skip_linkable, int threads, int lazy_walks,
                   const char *out_prefix, char *err, int errlen,
                   AlnStats *stats, const AlnScoring *scoring) {
    using clk = std::chrono::steady_clock;
    auto secs = [](clk::time_point a, clk::time_point b) {
        return std::chrono::duration<double>(b - a).count();
    };
    try {
        aln_tune_heap();
        aln::ButlerScope butler;
        aln::Config cfg;
        cfg.alt_baseline = alt_baseline;
        cfg.non_skip_linkable = non_skip_linkable != 0;
        cfg.lazy_walks = lazy_walks != 0;
        aln::apply_scoring(cfg, scoring);

        int io_threads = threads > 0 ? threads : (int) std::thread::hardware_concurrency();
        int nthreads = io_threads;
        aln::set_solver_helper_cap(nthreads - 1);
        auto t0 = clk::now();

        // solve + format fused with the parse: an alt merge appends
        // records to already-parsed contigs, so with no alt file each
        // contig can be solved and its three output parts formatted by
        // the parse worker the moment its records are complete (one
        // parallel phase, no barriers); with an alt file the solve
        // waits for the merge and runs as its own parallel phase.
        // solve_s includes output formatting; write_s is flush I/O.
        std::vector<std::string> parts_out, parts_alt, parts_max;
        std::atomic<bool> failed{false};
        std::string fail_msg;
        std::mutex fail_mu;
        auto do_one = [&](aln::Dataset &dset, size_t i) {
            if (failed.load(std::memory_order_relaxed)) return;
            try {
                aln::ContigResult res = aln::solve_contig(dset.contigs[i], cfg);
                aln::TraceScope ps(aln::kFormat);
                aln::format_rows_parallel(parts_out[i], dset, i, res.out,
                                          nthreads);
                aln::format_rows_one(parts_alt[i], dset, i, res.alt);
                aln::format_max_rows_one(parts_max[i], dset, i, res.max_out);
            } catch (const std::exception &e) {
                std::lock_guard<std::mutex> lk(fail_mu);
                failed = true;
                fail_msg = std::string("contig ") + dset.ctg_names[i] + ": " + e.what();
            }
        };

        bool fused = !(alt_path && alt_path[0]);
        aln::GroupSink sink;
        sink.start = [&](aln::Dataset &, size_t n_groups) {
            parts_out.resize(n_groups);
            parts_alt.resize(n_groups);
            parts_max.resize(n_groups);
        };
        sink.group = do_one;
        aln::Dataset ds = aln::read_paf(paf_path, io_threads,
                                        fused ? &sink : nullptr);
        size_t n = ds.contigs.size();
        if (!fused) aln::merge_alt(ds, alt_path, alt_baseline);
        auto t1 = clk::now();
        double read_secs = fused ? sink.scan_s : secs(t0, t1);

        if (!fused) {
            parts_out.resize(n);
            parts_alt.resize(n);
            parts_max.resize(n);
            std::atomic<size_t> next{0};
            auto worker = [&] {
                while (true) {
                    size_t i = next.fetch_add(1);
                    if (i >= n || failed.load(std::memory_order_relaxed)) break;
                    do_one(ds, i);
                }
            };
            if (nthreads <= 1 || n <= 1) {
                worker();
            } else {
                std::vector<std::thread> pool;
                for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
                for (auto &t : pool) t.join();
            }
        }
        if (failed) { set_err(err, errlen, fail_msg); return 2; }
        auto t2 = clk::now();

        std::string prefix = out_prefix && out_prefix[0] ? out_prefix : "";
        if (prefix.empty()) {
            std::string p(paf_path);
            prefix = p.substr(0, p.size() - 4);  // strip ".paf"
        }
        aln::flush_three(prefix, parts_out, parts_alt, parts_max,
                         nthreads <= 1 ? 1 : 3);
        auto t3 = clk::now();
        if (stats) {
            long long recs = 0;
            for (const auto &c : ds.contigs) recs += (long long) c.size();
            stats->records = recs;
        }
        // teardown off the timed path: the dataset + formatted parts are
        // ~10^5 small heap blocks (multiple ms of free()); the caller
        // only needs the files, so a detached thread releases them.
        // Constraint: the library must stay loaded for the thread's
        // lifetime — fine for the ctypes embedding (never dlclosed);
        // process exit mid-free is benign (threads die with the process
        // before any unmapping)
        {
            struct Garbage {
                aln::Dataset ds;
                std::vector<std::string> a, b, c;
            };
            auto *g = new Garbage{std::move(ds), std::move(parts_out),
                                  std::move(parts_alt), std::move(parts_max)};
            aln::async_teardown([g] { delete g; });
        }
        if (stats) {
            stats->read_s = read_secs;
            stats->solve_s = secs(t0, t2) - read_secs;
            stats->write_s = secs(t2, t3);
            stats->contigs = (long long) n;
        }
        return 0;
    } catch (const std::exception &e) {
        set_err(err, errlen, e.what());
        return 1;
    }
}

// ---- multihost shard engine -------------------------------------------
//
// Each rank runs aln_run_shard: a contig-group-sharded parse (the cheap
// line index scan covers the whole file; the expensive record parse +
// cs scan + solve + output formatting run only for the rank's owned
// groups — a CONTIGUOUS record-balanced range, io.cc read_paf).
// Ranks > 0 publish their PRE-FORMATTED output text for the three
// streams as one binary shard file (atomic rename); rank 0 streams its
// own slice STRAIGHT into the (tmp-named) output files — contiguity
// means rank 0's groups are the head of every stream — then appends
// each later rank's blobs as its shard lands (aln_append_shard), so
// the merge is pure sequential blob concatenation overlapped with the
// barrier instead of a post-barrier per-contig interleave.  Shard file
// layout (int64 LE):
//   [magic, digest, world, rank, n_total, g_lo, g_hi, m_bytes,
//    a_bytes, x_bytes] + m blob + a blob + x blob
//   (owned groups in ascending g; n_local = g_hi - g_lo)
static const long long SHARD_MAGIC = 0x414C4E53484432LL;  // "ALNSHD2"

int aln_run_shard(const char *paf_path, const char *alt_path,
                  double alt_baseline, int non_skip_linkable, int threads,
                  int lazy_walks, long long rank, long long world,
                  long long digest, const char *shard_path,
                  const char *direct_prefix,
                  long long *n_total_out, long long *n_local_out,
                  char *err, int errlen, const AlnScoring *scoring) {
    try {
        aln_tune_heap();
        aln::ButlerScope butler;
        aln::Config cfg;
        cfg.alt_baseline = alt_baseline;
        cfg.non_skip_linkable = non_skip_linkable != 0;
        cfg.lazy_walks = lazy_walks != 0;
        aln::apply_scoring(cfg, scoring);
        int nthreads = threads > 0 ? threads
                                   : (int) std::thread::hardware_concurrency();
        aln::set_solver_helper_cap(nthreads - 1);

        std::vector<std::string> parts_out, parts_alt, parts_max;
        std::atomic<bool> failed{false};
        std::string fail_msg;
        std::mutex fail_mu;
        auto do_one = [&](aln::Dataset &dset, size_t i) {
            if (failed.load(std::memory_order_relaxed)) return;
            try {
                aln::ContigResult res = aln::solve_contig(dset.contigs[i], cfg);
                aln::format_rows_one(parts_out[i], dset, i, res.out);
                aln::format_rows_one(parts_alt[i], dset, i, res.alt);
                aln::format_max_rows_one(parts_max[i], dset, i, res.max_out);
            } catch (const std::exception &e) {
                std::lock_guard<std::mutex> lk(fail_mu);
                failed = true;
                fail_msg = std::string("contig ") + dset.ctg_names[i] + ": "
                           + e.what();
            }
        };
        bool fused = !(alt_path && alt_path[0]);
        aln::GroupSink sink;
        sink.start = [&](aln::Dataset &, size_t n_groups) {
            parts_out.resize(n_groups);
            parts_alt.resize(n_groups);
            parts_max.resize(n_groups);
        };
        sink.group = do_one;  // called only for local groups
        // fused mode: byte-range sharded parse — the rank field-scans
        // only its ~1/world slice (io.cc read_paf_range), so the scan
        // cost scales down with world instead of being duplicated.
        // Alt mode needs the global last-wins name map: full scan.
        aln::i64 n_lines = 0;
        aln::Dataset ds = (fused && world > 1)
            ? aln::read_paf_range(paf_path, nthreads, &sink, rank, world,
                                  &n_lines)
            : aln::read_paf(paf_path, nthreads, fused ? &sink : nullptr,
                            rank, world);
        size_t n = ds.contigs.size();
        // the cross-rank consistency token in the shard header: global
        // line count under the range parse (group counts are local
        // there), global group count otherwise
        long long n_token = (fused && world > 1) ? n_lines : (long long) n;
        if (!fused) {
            aln::merge_alt(ds, alt_path, alt_baseline, rank, world);
            parts_out.resize(n);
            parts_alt.resize(n);
            parts_max.resize(n);
            std::vector<long long> mine;
            for (long long g = ds.shard_lo; g < ds.shard_hi; g++)
                mine.push_back(g);
            std::atomic<size_t> next{0};
            auto worker = [&] {
                while (true) {
                    size_t k = next.fetch_add(1);
                    if (k >= mine.size()
                        || failed.load(std::memory_order_relaxed)) break;
                    do_one(ds, (size_t) mine[k]);
                }
            };
            if (nthreads <= 1 || mine.size() <= 1) {
                worker();
            } else {
                std::vector<std::thread> pool;
                for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
                for (auto &t : pool) t.join();
            }
        }
        if (failed) { set_err(err, errlen, fail_msg); return 2; }

        long long n_local = ds.shard_hi - ds.shard_lo;
        const std::vector<std::string> *streams[3] = {&parts_out, &parts_alt,
                                                      &parts_max};
        if (direct_prefix && direct_prefix[0]) {
            // rank 0 owns the HEAD of every stream (contiguous ranges):
            // flush its parts straight into the output files — no shard
            // file, no self-read at merge time.  Non-owned parts are
            // empty strings, so the ordinary three-way flush applies.
            aln::flush_three(std::string(direct_prefix), parts_out,
                             parts_alt, parts_max,
                             nthreads <= 1 ? 1 : 3);
        } else {
            // publish the shard file (write to .tmp, atomic rename)
            long long totals[3] = {0, 0, 0};
            for (int s = 0; s < 3; s++)
                for (long long g = ds.shard_lo; g < ds.shard_hi; g++)
                    totals[s] += (long long) (*streams[s])[(size_t) g].size();
            std::string tmp = std::string(shard_path) + ".tmp";
            {
                int fd = ::open(tmp.c_str(),
                                O_WRONLY | O_CREAT | O_TRUNC, 0644);
                if (fd < 0) throw std::runtime_error("cannot write " + tmp);
                try {
                    long long header[10] = {SHARD_MAGIC, digest, world, rank,
                                            n_token, ds.shard_lo,
                                            ds.shard_hi, totals[0], totals[1],
                                            totals[2]};
                    ssize_t w = ::write(fd, header, sizeof(header));
                    if (w != (ssize_t) sizeof(header))
                        throw std::runtime_error("short write: " + tmp);
                    for (int s = 0; s < 3; s++)
                        aln::write_parts_fd(fd, *streams[s], ds.shard_lo,
                                            ds.shard_hi);
                } catch (...) {
                    ::close(fd);
                    throw;
                }
                if (::close(fd) != 0)
                    throw std::runtime_error("close failed: " + tmp);
            }
            if (std::rename(tmp.c_str(), shard_path) != 0)
                throw std::runtime_error("cannot publish "
                                         + std::string(shard_path));
        }
        // teardown off the timed path (same rationale as run_stats2):
        // rank 0 proceeds straight to appending landed shards
        {
            struct Garbage {
                aln::Dataset ds;
                std::vector<std::string> a, b, c;
            };
            auto *g = new Garbage{std::move(ds), std::move(parts_out),
                                  std::move(parts_alt), std::move(parts_max)};
            aln::async_teardown([g] { delete g; });
        }
        if (n_total_out) *n_total_out = n_token;
        if (n_local_out) *n_local_out = n_local;
        return 0;
    } catch (const std::exception &e) {
        set_err(err, errlen, e.what());
        return 1;
    }
}

int aln_append_shard(const char *out_prefix, const char *shard_path,
                     long long world, long long rank, long long digest,
                     long long n_expected, int threads,
                     char *err, int errlen) {
    // Append one landed shard's three stream blobs onto the (tmp-named)
    // output files.  Ranges are contiguous and shards are appended in
    // rank order, so this IS the merge — big sequential reads/writes,
    // no per-contig slice bookkeeping; the three streams run
    // concurrently.  Validates the header against the caller's job
    // identity (digest/world/rank, and the contig count when known).
    try {
        std::ifstream in(shard_path, std::ios::binary);
        if (!in)
            throw std::runtime_error("cannot open "
                                     + std::string(shard_path));
        long long header[10];
        in.read((char *) header, sizeof(header));
        if (!in || header[0] != SHARD_MAGIC)
            throw std::runtime_error("bad shard header: "
                                     + std::string(shard_path));
        if (header[1] != digest || header[2] != world || header[3] != rank)
            throw std::runtime_error("shard meta mismatch: "
                                     + std::string(shard_path));
        if (n_expected >= 0 && header[4] != n_expected)
            throw std::runtime_error("shard contig-count mismatch: "
                                     + std::string(shard_path));
        long long off[4];
        off[0] = (long long) sizeof(header);
        for (int s = 0; s < 3; s++) off[s + 1] = off[s] + header[7 + s];
        static const char *sfx[] = {".aln.paf", ".aln.alt.paf",
                                    ".aln.all.paf"};
        std::string fail[3];
        auto copy_one = [&](int s) {
            try {
                std::string out_path = std::string(out_prefix) + sfx[s];
                long long left = header[7 + s];
                // fast path: in-kernel copy (the append sits on rank
                // 0's critical path right after the barrier; userspace
                // double-buffering cost ~25-40 ms per 50 MB shard on
                // tmpfs).  copy_file_range rejects O_APPEND outputs,
                // so seek the end explicitly.
                int ifd = ::open(shard_path, O_RDONLY);
                int ofd = ::open(out_path.c_str(),
                                 O_WRONLY | O_CREAT, 0644);
                bool done = false;
                if (ifd >= 0 && ofd >= 0) {
                    off_t in_off = (off_t) off[s];
                    off_t out_off = ::lseek(ofd, 0, SEEK_END);
                    long long rem = left;
                    while (rem > 0) {
                        ssize_t n = ::copy_file_range(
                            ifd, &in_off, ofd, &out_off, (size_t) rem, 0);
                        if (n < 0 && errno == EINTR) continue;
                        if (n <= 0) break;  // fall back for the rest
                        rem -= n;
                    }
                    if (rem == 0) done = true;
                    else {  // resume point for the buffered fallback
                        off[s] = (long long) in_off;
                        left = rem;
                    }
                }
                if (ifd >= 0) ::close(ifd);
                if (ofd >= 0) ::close(ofd);
                if (done) return;
                std::ifstream i2(shard_path, std::ios::binary);
                if (!i2) throw std::runtime_error("cannot open shard");
                i2.seekg(off[s]);
                std::ofstream o(out_path, std::ios::binary | std::ios::app);
                if (!o) throw std::runtime_error("cannot append "
                                                 + out_path);
                std::vector<char> buf(4 << 20);
                while (left > 0) {
                    long long take = std::min(left, (long long) buf.size());
                    i2.read(buf.data(), (std::streamsize) take);
                    if (!i2) throw std::runtime_error(
                        "short shard read: " + std::string(shard_path));
                    o.write(buf.data(), (std::streamsize) take);
                    left -= take;
                }
                if (!o) throw std::runtime_error("short write: " + out_path);
            } catch (const std::exception &e) {
                fail[s] = e.what();
            }
        };
        if (threads == 1) {
            for (int s = 0; s < 3; s++) copy_one(s);
        } else {
            std::vector<std::thread> pool;
            for (int s = 0; s < 3; s++) pool.emplace_back(copy_one, s);
            for (auto &t : pool) t.join();
        }
        for (int s = 0; s < 3; s++)
            if (!fail[s].empty()) throw std::runtime_error(fail[s]);
        return 0;
    } catch (const std::exception &e) {
        set_err(err, errlen, e.what());
        return 1;
    }
}

}  // extern "C"
