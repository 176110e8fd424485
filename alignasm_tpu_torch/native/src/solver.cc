#include "solver.h"

#include <algorithm>
#include <atomic>
#include <cassert>
#include <chrono>
#include <cstdlib>
#include <deque>
#include <limits>
#include <queue>
#include <stdexcept>
#include <thread>
#include <unordered_map>

namespace aln {

namespace {

constexpr i64 NO_CUT = std::numeric_limits<i64>::min();

struct Vert {  // working view of a vertex (Internal_Vertex analogue)
    i32 pre, cur;
    i64 qs, qe, rs, re;
    bool one() const { return pre == cur; }
};

// ---- cut-point two-pointer sweep (paf_data.cpp:294-378) -------------
struct CutRes {
    bool ok = false;
    i64 pe_q = 0, pe_r = 0, st_q = 0, st_r = 0;
};

// gap/inversion/translocation scoring between two internal vertices
// (get_score, paf_data.cpp:449-521); standalone so the single-piece
// upgrade can score candidate splices with the graph builder's math
Dist score_between(const Config &cfg, const Record &a, const Record &b,
                   i64 lqe, i64 lre, i64 lrs, i64 rqs, i64 rrs, i64 rre) {
    auto ref_abs = [&](i64 x) { return x < 0 ? -x * cfg.ref_negative_penalty : x; };
    i64 qry_diff = rqs - lqe - 1;
    i64 anom = 0, ref_diff = 0;
    if (a.ref_chr == b.ref_chr && a.fwd == b.fwd) {
        i64 sg = a.fwd ? rrs - (lre + 1) : lre - (rrs + 1);
        ref_diff = ref_abs(sg);
        if (ref_diff > cfg.sv_baseline) { anom++; ref_diff = cfg.sv_baseline; }
    } else if (a.ref_chr == b.ref_chr) {
        anom++;
        ref_diff = cfg.sv_inv_penalty +
                   (a.fwd ? ref_abs(rre - (lre + 1)) : ref_abs(rrs - (lrs + 1)));
        if (ref_diff > cfg.sv_baseline) { anom++; ref_diff = cfg.sv_baseline; }
    } else {
        anom++;
        ref_diff = cfg.sv_trans_penalty;
    }
    return {qry_diff * cfg.qry_weight, ref_diff * cfg.ref_weight, anom,
            b.map_qul ? 1 : 0, 1};
}

CutRes pair_cut(const Record &pre, const Record &cur) {
    const auto &pq = pre.qry_runs, &cq = cur.qry_runs;
    const auto &pr = pre.ref_runs, &cr = cur.ref_runs;
    i64 pn = (i64) pq.size(), cn = (i64) cq.size();
    i64 step = cur.fwd ? 1 : -1, step_pre = pre.fwd ? 1 : -1;
    i64 min_gap = -1, g_i = -1, g_j = -1;
    i64 pi = 0, pj = 0;
    while (pi < pn && pj < cn) {
        i64 li = pq[pi].first, ri = pq[pi].second;
        i64 lj = cq[pj].first, rj = cq[pj].second;
        if (li == lj) {
            if (lj == rj) { pj++; continue; }
            return {true, li, pr[pi].first, lj + 1, cr[pj].first + step};
        }
        if (li < lj) {
            if (lj <= ri + 1)
                return {true, lj - 1, pr[pi].first + (lj - 1 - li) * step_pre,
                        lj, cr[pj].first};
            i64 gap = lj - (ri + 1);
            if (min_gap == -1 || gap < min_gap) { min_gap = gap; g_i = pi; g_j = pj; }
            pi++;
        } else {
            if (li <= rj - 1)
                return {true, li, pr[pi].first, li + 1,
                        cr[pj].first + (li + 1 - cq[pj].first) * step};
            pj++;
        }
    }
    if (min_gap == -1) return {};
    i64 li = pq[g_i].first, ri = pq[g_i].second;
    return {true, ri, pr[g_i].first + (ri - li) * step_pre,
            cq[g_j].first, cr[g_j].first};
}

}  // namespace

// ---- graph construction (paf_data.cpp:531-696 semantics) ------------
Graph build_graph(std::vector<Record> &records, const Config &cfg) {
    Graph g;
    build_graph_into(records, cfg, g);
    return g;
}

// process-wide helper budget for intra-contig build parallelism
// (see solver.h set_solver_helper_cap)
static std::atomic<int> g_build_cap{0};
static std::atomic<int> g_build_helpers{0};

void set_solver_helper_cap(int cap) {
    g_build_cap.store(cap < 0 ? 0 : cap, std::memory_order_relaxed);
}

int acquire_solver_helpers(int want) {
    int got = 0;
    int cap = g_build_cap.load(std::memory_order_relaxed);
    int cur = g_build_helpers.load(std::memory_order_relaxed);
    while (got < want && cur < cap) {
        if (g_build_helpers.compare_exchange_weak(
                cur, cur + 1, std::memory_order_relaxed)) {
            ++got;
            ++cur;
        }
    }
    return got;
}

void release_solver_helpers(int n) {
    if (n) g_build_helpers.fetch_sub(n, std::memory_order_relaxed);
}

namespace {

// records-per-contig threshold below which helper threads cost more
// than the chunked work saves
constexpr i64 kParBuildMin = 64 << 10;

}  // namespace

// ALN_DEBUG_WALKS=1 prints each solve's walks to stderr; read once a
// process
static bool debug_walks() {
    static const bool on = std::getenv("ALN_DEBUG_WALKS") != nullptr;
    return on;
}

void build_graph_into(std::vector<Record> &records, const Config &cfg,
                      Graph &g) {
    g.n = (i64) records.size();
    g.recs.clear();
    g.part_idx.clear();
    g.parts.clear();
    g.vtx.clear();
    g.pair_vtx.clear();
    g.cut_pe_q.clear();
    g.cut_pe_r.clear();
    g.cut_st_q.clear();
    g.cut_st_r.clear();
    static thread_local std::vector<Record *> order;
    order.clear();
    order.reserve(g.n);
    for (auto &r : records) order.push_back(&r);
    // std::sort: same libstdc++ introsort element movement the
    // reference relies on for duplicate-key ordering
    std::sort(order.begin(), order.end(), [](const Record *a, const Record *b) {
        if (a->qry_str != b->qry_str) return a->qry_str < b->qry_str;
        return a->qry_end < b->qry_end;
    });
    g.recs.assign(order.begin(), order.end());
    for (i64 i = 0; i < g.n; i++) order[i]->sorted_index = (i32) i;

    // parts: maximal runs of query-overlapping records
    g.part_idx.resize(g.n);
    i64 part_end = -1;
    for (i64 i = 0; i < g.n; i++) {
        if (part_end < g.recs[i]->qry_str) g.parts.push_back(i);
        g.part_idx[i] = (i64) g.parts.size() - 1;
        part_end = std::max(part_end, g.recs[i]->qry_end);
    }
    g.parts.push_back(g.n);

    // vertices: one per record, then pair vertices in discovery order
    g.vtx.reserve((size_t) g.n);
    g.cut_pe_q.reserve((size_t) g.n); g.cut_pe_r.reserve((size_t) g.n);
    g.cut_st_q.reserve((size_t) g.n); g.cut_st_r.reserve((size_t) g.n);
    for (i64 i = 0; i < g.n; i++) {
        g.vtx.emplace_back((i32) i, (i32) i);
        g.cut_pe_q.push_back(NO_CUT); g.cut_pe_r.push_back(NO_CUT);
        g.cut_st_q.push_back(g.recs[i]->qry_str);
        g.cut_st_r.push_back(g.recs[i]->ref_str);
    }
    int cut_helpers = g.n >= kParBuildMin ? acquire_solver_helpers(3) : 0;
    if (cut_helpers == 0) {
        for (i64 i = 0; i < g.n; i++) {
            const Record &pre = *g.recs[i];
            for (i64 j = i + 1; j < g.n; j++) {
                const Record &cur = *g.recs[j];
                if (pre.qry_end < cur.qry_str) break;
                if (!partial_overlap(pre, cur)) continue;
                CutRes c = pair_cut(pre, cur);
                if (!c.ok)
                    throw std::runtime_error(
                        "overlapping records cannot connect");
                g.pair_vtx.put(i * g.n + j, (i32) g.vtx.size());
                g.vtx.emplace_back((i32) i, (i32) j);
                g.cut_pe_q.push_back(c.pe_q); g.cut_pe_r.push_back(c.pe_r);
                g.cut_st_q.push_back(c.st_q); g.cut_st_r.push_back(c.st_r);
            }
        }
    } else {
        // chunked two-phase: the pair_cut sweeps (pure functions of
        // the two records) run on contiguous i-ranges in parallel,
        // then one serial splice appends hits in the exact serial
        // discovery order (i asc, j asc) — vertex ids, cut tables, and
        // the first-bad-pair throw are all identical to the serial
        // loop
        struct PairHit { i32 i, j; CutRes c; };
        int nc = cut_helpers + 1;
        std::vector<std::vector<PairHit>> hits((size_t) nc);
        i64 step = (g.n + nc - 1) / nc;
        auto scan = [&](int c) {
            i64 lo = (i64) c * step, hi = std::min<i64>(g.n, lo + step);
            auto &out = hits[(size_t) c];
            for (i64 i = lo; i < hi; i++) {
                const Record &pre = *g.recs[i];
                for (i64 j = i + 1; j < g.n; j++) {
                    const Record &cur = *g.recs[j];
                    if (pre.qry_end < cur.qry_str) break;
                    if (!partial_overlap(pre, cur)) continue;
                    out.push_back({(i32) i, (i32) j, pair_cut(pre, cur)});
                }
            }
        };
        std::vector<std::thread> pool;
        for (int c = 1; c < nc; c++) pool.emplace_back(scan, c);
        scan(0);
        for (auto &t : pool) t.join();
        release_solver_helpers(cut_helpers);
        for (auto &hv : hits)
            for (auto &h : hv) {
                if (!h.c.ok)
                    throw std::runtime_error(
                        "overlapping records cannot connect");
                g.pair_vtx.put((i64) h.i * g.n + h.j, (i32) g.vtx.size());
                g.vtx.emplace_back(h.i, h.j);
                g.cut_pe_q.push_back(h.c.pe_q); g.cut_pe_r.push_back(h.c.pe_r);
                g.cut_st_q.push_back(h.c.st_q); g.cut_st_r.push_back(h.c.st_r);
            }
    }
    g.src = (i32) g.vtx.size();
    g.dest = g.src + 1;
    // grow-only + per-slot clear: a reused scratch graph keeps every
    // inner vector's capacity; slots beyond nv() are stale but no
    // consumer walks them (vertex loops bound by nv())
    if ((i64) g.adj.size() < g.nv()) g.adj.resize(g.nv());
    for (i64 u = 0; u < g.nv(); u++) g.adj[u].clear();

    auto vert = [&](i64 i, i64 j) -> Vert {
        i32 id = g.vid(i, j);
        return {(i32) i, (i32) j, g.cut_st_q[id], g.recs[j]->qry_end,
                g.cut_st_r[id], g.recs[j]->ref_end};
    };
    auto valid = [&](i64 i, i64 j) { return g.vid(i, j) >= 0; };
    auto linkable = [&](const Vert &l, const Vert &r) -> bool {
        if (!valid(l.pre, l.cur) || !valid(r.pre, r.cur)) return false;
        if (!r.one()) {
            if (l.cur != r.pre) return false;
            return l.qs < r.qs;
        }
        if (g.part_idx[l.cur] + 1 == g.part_idx[r.cur]) return true;
        if (g.part_idx[l.cur] != g.part_idx[r.cur]) return false;
        return l.qe < r.qs;
    };
    auto score = [&](Vert l, const Vert &r) -> Dist {
        if (!r.one()) {
            i32 id = g.vid(r.pre, r.cur);
            l.qe = g.cut_pe_q[id];
            l.re = g.cut_pe_r[id];
        }
        return score_between(cfg, *g.recs[l.cur], *g.recs[r.cur],
                             l.qe, l.re, l.rs, r.qs, r.rs, r.re);
    };
    auto add = [&](i32 u, i32 v, const Dist &w) { g.adj[u].push_back({v, w}); };
    const bool nsl = cfg.non_skip_linkable;
    const i64 BIG = std::numeric_limits<i64>::max();

    // src -> first part
    {
        i64 l = g.parts[0], r = g.parts[1];
        i64 min_qe = BIG;
        for (i64 i = l; i < r; i++) {
            if (nsl) {
                if (min_qe < g.recs[i]->qry_str) break;
                min_qe = std::min(min_qe, g.recs[i]->qry_end);
            }
            add(g.src, g.vid(i, i),
                {g.recs[i]->qry_str * cfg.sv_front_end_coefficient, 0, 0,
                 g.recs[i]->map_qul ? 1 : 0, 1});
        }
    }
    // last part (+ (j,i) vertices) -> dest
    {
        i64 l = g.parts[g.parts.size() - 2], r = g.parts.back();
        i64 max_qs = g.recs[r - 1]->qry_str;
        for (i64 i = r - 1; i >= l; i--) {
            if (nsl && g.recs[i]->qry_end < max_qs) continue;
            Dist d{(g.recs[i]->qry_total - g.recs[i]->qry_end - 1) *
                       cfg.sv_front_end_coefficient,
                   0, 0, 0, 0};
            add(g.vid(i, i), g.dest, d);
            for (i64 j = i - 1; j >= 0; j--) {
                if (g.recs[j]->contains(*g.recs[i])) continue;
                if (g.recs[j]->qry_end >= g.recs[i]->qry_str && valid(j, i))
                    add(g.vid(j, i), g.dest, d);
            }
        }
    }
    // intra-part edges of one block
    auto intra_blk = [&](i64 blk) {
        i64 l = g.parts[blk], r = g.parts[blk + 1];
        for (i64 i = l; i < r; i++) {
            i64 min_qe_ii = BIG;
            for (i64 j = i + 1; j < r; j++) {
                if (g.recs[i]->contains(*g.recs[j])) continue;
                if (nsl) {
                    if (min_qe_ii < g.recs[j]->qry_str) break;
                    if (g.recs[i]->qry_end < g.recs[j]->qry_str)
                        min_qe_ii = std::min(min_qe_ii, g.recs[j]->qry_end);
                }
                if (g.recs[i]->qry_end < g.recs[j]->qry_str) {
                    Vert a = vert(i, i), b = vert(j, j);
                    if (linkable(a, b)) add(g.vid(i, i), g.vid(j, j), score(a, b));
                } else if (valid(i, j)) {
                    Vert a = vert(i, i), b = vert(i, j);
                    if (linkable(a, b)) add(g.vid(i, i), g.vid(i, j), score(a, b));
                    i64 min_qe_ij = BIG;
                    for (i64 k = j + 1; k < r; k++) {
                        if (nsl) {
                            if (min_qe_ij < g.recs[k]->qry_str) break;
                            if (g.recs[j]->qry_end < g.recs[k]->qry_str)
                                min_qe_ij = std::min(min_qe_ij, g.recs[k]->qry_end);
                        }
                        Vert kk = vert(k, k);
                        if (linkable(b, kk))
                            add(g.vid(i, j), g.vid(k, k), score(b, kk));
                        if (valid(j, k)) {
                            Vert jk = vert(j, k);
                            if (linkable(b, jk))
                                add(g.vid(i, j), g.vid(j, k), score(b, jk));
                        }
                    }
                }
            }
        }
    };
    // part blk -> part blk+1 edges
    auto cross_blk = [&](i64 blk) {
        i64 l = g.parts[blk], r = g.parts[blk + 1];
        i64 l2 = g.parts[blk + 1], r2 = g.parts[blk + 2];
        for (i64 i = l; i < r; i++) {
            Vert a = vert(i, i);
            i64 min_qe_ii = BIG;
            for (i64 k = l2; k < r2; k++) {
                if (nsl) {
                    if (min_qe_ii < g.recs[k]->qry_str) break;
                    if (g.recs[i]->qry_end < g.recs[k]->qry_str)
                        min_qe_ii = std::min(min_qe_ii, g.recs[k]->qry_end);
                }
                Vert kk = vert(k, k);
                if (linkable(a, kk)) add(g.vid(i, i), g.vid(k, k), score(a, kk));
            }
            for (i64 j = i + 1; j < r; j++) {
                if (g.recs[i]->contains(*g.recs[j])) continue;
                if (g.recs[i]->qry_end < g.recs[j]->qry_str) break;
                if (!valid(i, j)) continue;
                Vert b = vert(i, j);
                i64 min_qe_ij = BIG;
                for (i64 k = l2; k < r2; k++) {
                    if (nsl) {
                        if (min_qe_ij < g.recs[k]->qry_str) break;
                        if (g.recs[j]->qry_end < g.recs[k]->qry_str)
                            min_qe_ij = std::min(min_qe_ij, g.recs[k]->qry_end);
                    }
                    Vert kk = vert(k, k);
                    if (linkable(b, kk)) add(g.vid(i, j), g.vid(k, k), score(b, kk));
                }
            }
        }
    };
    i64 nblk = (i64) g.parts.size() - 1;
    int edge_helpers = (g.n >= kParBuildMin && nblk >= 64)
                           ? acquire_solver_helpers(3) : 0;
    if (edge_helpers == 0) {
        for (i64 blk = 0; blk + 1 < (i64) g.parts.size(); blk++)
            intra_blk(blk);
        for (i64 blk = 0; blk + 2 < (i64) g.parts.size(); blk++)
            cross_blk(blk);
    } else {
        // Parallel over contiguous record-balanced BLOCK ranges, each
        // thread running intra then cross per block.  Byte-identity
        // argument: every edge's source vertex u (a record vertex
        // (i,i) or pair vertex (i,j)) belongs to exactly one part
        // block — the part of i — so adj[u] is only ever appended by
        // the one thread owning that block, and its per-u sequence
        // ([dest-block edge if last part,] intra edges in j order,
        // cross edges in k/j order) matches the serial loops exactly;
        // scoring reads only immutable record/cut tables.
        int nc = edge_helpers + 1;
        std::vector<i64> bounds((size_t) nc + 1, nblk);
        bounds[0] = 0;
        for (int c = 1; c < nc; c++) {
            i64 target = g.n * c / nc;
            i64 b = std::lower_bound(g.parts.begin(),
                                     g.parts.begin() + nblk, target)
                    - g.parts.begin();
            bounds[(size_t) c] = std::max(bounds[(size_t) c - 1],
                                          std::min(b, nblk));
        }
        auto run_range = [&](int c) {
            for (i64 blk = bounds[(size_t) c];
                 blk < bounds[(size_t) c + 1]; blk++) {
                intra_blk(blk);
                if (blk + 2 < (i64) g.parts.size()) cross_blk(blk);
            }
        };
        std::vector<std::thread> pool;
        for (int c = 1; c < nc; c++) pool.emplace_back(run_range, c);
        run_range(0);
        for (auto &t : pool) t.join();
        release_solver_helpers(edge_helpers);
    }
}

namespace {

// ---- Kahn FIFO topological order ------------------------------------
// The output vector doubles as the FIFO queue (every vertex is pushed
// exactly once and popped in append order, so the queue IS the order);
// indeg scratch is thread_local.  glibc malloc was >50% of -t1 solve
// time, and this ran 3x per contig with a deque + two vectors per call.
void topo_order_into(const std::vector<std::vector<Edge>> &adj, i64 n,
                     std::vector<i32> &out) {
    static thread_local std::vector<i32> indeg;
    indeg.assign((size_t) n, 0);
    out.clear();
    out.reserve(n);
    for (i64 u = 0; u < n; u++)
        for (const auto &e : adj[u]) indeg[e.to]++;
    for (i64 u = 0; u < n; u++)
        if (!indeg[u]) out.push_back((i32) u);
    for (size_t head = 0; head < out.size(); head++) {
        i32 u = out[head];
        for (const auto &e : adj[u])
            if (--indeg[e.to] == 0) out.push_back(e.to);
    }
    if ((i64) out.size() != n) throw std::runtime_error("cycle in contig DAG");
}


// ---- lazy Eppstein k-shortest walks ---------------------------------
// Persistent leftist heap in an arena; queue ties break on (arena
// index, emplace index), matching the deterministic-allocator oracle.
class Walks {
public:
    Walks() = default;
    explicit Walks(const Graph &g) { reset(g); }

    // reusable across contigs (thread_local in the solve entry):
    // every buffer keeps its capacity, heap/candidate indices restart
    // at 0 exactly as a fresh object's would
    void reset(const Graph &g) {
        gp_ = &g;
        V_ = g.nv();
        hk_.clear(); hu_.clear(); hv_.clear();
        hl_.clear(); hr_.clear(); hrank_.clear();
        cand_h_.clear(); cand_prev_.clear(); cand_d_.clear();
        qv_.clear();
        dists_.clear();
        last_.clear();
        heaps_ready_ = false;
    }

    // shortest-path pass only (d[] / best[]); returns false if dest
    // unreachable (cannot happen for valid contigs)
    bool prepare() {
        const Graph &g = *gp_;
        // reversed adjacency in CSR form (counting sort preserves the
        // u-major per-target order the nested-vector form had); the
        // nested form allocated V inner vectors per contig
        roff_.assign((size_t) V_ + 1, 0);
        i64 E = 0;
        for (i64 u = 0; u < V_; u++) E += (i64) g.adj[u].size();
        rsrc_.resize((size_t) E);
        rw_.resize((size_t) E);
        // >= 256k edges: parallel counting sort over edge-balanced
        // contiguous u-ranges (helpers from the shared solver budget).
        // Determinism: each target's range-base offsets place range
        // r's entries before range r+1's and each range fills in
        // ascending u — exactly the serial u-major per-target order,
        // so rsrc_/rw_ are bit-identical to the serial fill.
        int csr_helpers =
            E >= (128 << 10) ? acquire_solver_helpers(3) : 0;
        if (csr_helpers == 0) {
            for (i64 u = 0; u < V_; u++)
                for (const auto &e : g.adj[u]) roff_[(size_t) e.to + 1]++;
            for (i64 v = 0; v < V_; v++) roff_[v + 1] += roff_[v];
            static thread_local std::vector<i32> cur;
            cur.assign(roff_.begin(), roff_.end() - 1);
            for (i64 u = 0; u < V_; u++)
                for (const auto &e : g.adj[u]) {
                    i32 k = cur[e.to]++;
                    rsrc_[k] = (i32) u;
                    rw_[k] = e.w;
                }
        } else {
            const int R = csr_helpers + 1;
            std::vector<i64> ub((size_t) R + 1, V_);
            ub[0] = 0;
            {
                i64 acc = 0, r = 1;
                for (i64 u = 0; u < V_ && r < R; u++) {
                    acc += (i64) g.adj[u].size();
                    if (acc >= E * r / R) ub[(size_t) r++] = u + 1;
                }
            }
            for (int r = 1; r <= R; r++)  // monotone guard
                ub[(size_t) r] = std::max(ub[(size_t) r],
                                          ub[(size_t) r - 1]);
            csr_cnt_.assign((size_t) R * (size_t) V_, 0);
            auto run_par = [&](auto &&body) {
                std::vector<std::thread> pool;
                for (int r = 1; r < R; r++) pool.emplace_back(body, r);
                body(0);
                for (auto &t : pool) t.join();
            };
            run_par([&](int r) {  // per-range counts
                i32 *c = csr_cnt_.data() + (size_t) r * (size_t) V_;
                for (i64 u = ub[(size_t) r]; u < ub[(size_t) r + 1]; u++)
                    for (const auto &e : g.adj[u]) c[e.to]++;
            });
            for (i64 v = 0; v < V_; v++) {
                i64 t = 0;
                for (int r = 0; r < R; r++)
                    t += csr_cnt_[(size_t) r * (size_t) V_ + (size_t) v];
                roff_[(size_t) v + 1] = (i32) t;
            }
            for (i64 v = 0; v < V_; v++) roff_[v + 1] += roff_[v];
            run_par([&](int r0) {  // per-(range, target) bases
                i64 lo = V_ * r0 / R, hi = V_ * (r0 + 1) / R;
                for (i64 v = lo; v < hi; v++) {
                    i32 acc = roff_[(size_t) v];
                    for (int r = 0; r < R; r++) {
                        i32 &slot =
                            csr_cnt_[(size_t) r * (size_t) V_ + (size_t) v];
                        i32 t = slot;
                        slot = acc;
                        acc += t;
                    }
                }
            });
            run_par([&](int r) {  // fill
                i32 *c = csr_cnt_.data() + (size_t) r * (size_t) V_;
                for (i64 u = ub[(size_t) r]; u < ub[(size_t) r + 1]; u++)
                    for (const auto &e : g.adj[u]) {
                        i32 k = c[e.to]++;
                        rsrc_[k] = (i32) u;
                        rw_[k] = e.w;
                    }
            });
            release_solver_helpers(csr_helpers);
        }
        // Kahn order of the reversed graph (in-degree there = forward
        // out-degree); the output vector doubles as the FIFO queue
        {
            static thread_local std::vector<i32> indeg;
            indeg.assign((size_t) V_, 0);
            for (i64 u = 0; u < V_; u++) indeg[u] = (i32) g.adj[u].size();
            rev_order_.clear();
            rev_order_.reserve(V_);
            for (i64 v = 0; v < V_; v++)
                if (!indeg[v]) rev_order_.push_back((i32) v);
            for (size_t head = 0; head < rev_order_.size(); head++) {
                i32 v = rev_order_[head];
                for (i32 k = roff_[v]; k < roff_[(size_t) v + 1]; k++)
                    if (--indeg[rsrc_[k]] == 0) rev_order_.push_back(rsrc_[k]);
            }
            if ((i64) rev_order_.size() != V_)
                throw std::runtime_error("cycle in contig DAG");
        }
        d_.assign(V_, Dist{});
        reach_.assign(V_, false);
        best_.assign(V_, -1);
        reach_[g.dest] = true;
        for (i32 v : rev_order_) {
            if (!reach_[v]) continue;
            for (i32 k = roff_[v]; k < roff_[(size_t) v + 1]; k++) {
                i32 to = rsrc_[k];
                Dist nd = d_[v] + rw_[k];
                if (!reach_[to] || dist_less(nd, d_[to], Mode::CalcSum)) {
                    reach_[to] = true;
                    d_[to] = nd;
                    best_[to] = v;
                }
            }
        }
        if (!reach_[g.src]) return false;
        dists_.push_back(d_[g.src]);
        last_.push_back(-1);
        return true;
    }

    // number of walks achieving the minimum (sum, anom), saturated at
    // `cap` — decides whether sidetrack heaps are needed at all
    i64 count_min_walks(i64 cap) const {
        const Graph &g = *gp_;
        static thread_local std::vector<i64> cnt;
        cnt.assign(V_, 0);
        cnt[g.dest] = 1;
        for (i32 v : rev_order_) {
            if (!cnt[v]) continue;
            for (i32 k = roff_[v]; k < roff_[(size_t) v + 1]; k++) {
                i32 to = rsrc_[k];
                if (!reach_[to]) continue;
                Dist nd = d_[v] + rw_[k];
                if (nd.sum() == d_[to].sum() && nd.a == d_[to].a)
                    cnt[to] = std::min(cnt[to] + cnt[v], cap);
            }
        }
        return cnt[g.src];
    }

    // builds the persistent sidetrack heaps (the expensive part of
    // Eppstein prep); lazily called before the first next()
    void ensure_heaps() {
        if (heaps_ready_) return;
        heaps_ready_ = true;
        const Graph &g = *gp_;
        // shortest-path tree children in CSR (u-ascending per parent,
        // the order the nested push_back form produced)
        static thread_local std::vector<i32> toff, tch, q;
        toff.assign((size_t) V_ + 1, 0);
        for (i64 u = 0; u < V_; u++)
            if (best_[u] != -1) toff[(size_t) best_[u] + 1]++;
        for (i64 v = 0; v < V_; v++) toff[v + 1] += toff[v];
        tch.resize(toff[V_]);
        {
            static thread_local std::vector<i32> cur;
            cur.assign(toff.begin(), toff.end() - 1);
            for (i64 u = 0; u < V_; u++)
                if (best_[u] != -1) tch[(size_t) cur[best_[u]]++] = (i32) u;
        }
        heap_of_.assign(V_, -1);
        q.clear();
        q.push_back((i32) g.dest);
        for (size_t head = 0; head < q.size(); head++) {
            i32 u = q[head];
            bool seen_best = false;
            i32 h = heap_of_[u];
            for (const auto &e : g.adj[u]) {
                if (!reach_[e.to]) continue;
                Dist c = e.w + d_[e.to] - d_[u];
                if (!seen_best && e.to == best_[u] && c.is_zero_like()) {
                    seen_best = true;  // the tree edge is skipped exactly once
                    continue;
                }
                h = heap_insert(h, c, u, e.to);
            }
            heap_of_[u] = h;
            for (i32 k = toff[u]; k < toff[(size_t) u + 1]; k++) {
                heap_of_[tch[k]] = h;
                q.push_back(tch[k]);
            }
        }
        if (heap_of_[g.src] != -1)
            emplace(d_[g.src] + hk_[heap_of_[g.src]], heap_of_[g.src], -1);
    }

    // emit the next walk; returns false when exhausted.  Walk i's
    // distance lands in dists()[i].
    bool next() {
        ensure_heaps();
        if (qv_.empty()) return false;
        // exactly libstdc++ priority_queue<QE, vector, greater>: its
        // top()/pop() are front + pop_heap/pop_back on the same heap
        QE top = qv_.front();
        std::pop_heap(qv_.begin(), qv_.end(), std::greater<QE>{});
        qv_.pop_back();
        i32 cur = top.cand;
        Dist cd = cand_d_[cur];
        dists_.push_back(cd);
        last_.push_back(cur);
        i32 ch = cand_h_[cur];
        i32 hv = heap_of_[hv_[ch]];
        if (hv != -1) emplace(cd + hk_[hv], hv, cur);
        if (hl_[ch] != -1) emplace(cd + hk_[hl_[ch]] - hk_[ch], hl_[ch], cand_prev_[cur]);
        if (hr_[ch] != -1) emplace(cd + hk_[hr_[ch]] - hk_[ch], hr_[ch], cand_prev_[cur]);
        return true;
    }

    const std::vector<Dist> &dists() const { return dists_; }

    // the k-th walk as explicit (u, v, w) edges; fills (and returns)
    // the reusable member scratch — consumed before the next call
    std::vector<std::tuple<i32, i32, Dist>> &recover(i64 k) const {
        auto &side = side_scratch_;
        auto &path = path_scratch_;
        side.clear();
        path.clear();
        i32 cur = last_[k];
        while (cur != -1) {
            i32 h = cand_h_[cur];
            side.emplace_back(hu_[h], hv_[h], hk_[h] + d_[hu_[h]] - d_[hv_[h]]);
            cur = cand_prev_[cur];
        }
        std::reverse(side.begin(), side.end());
        size_t idx = 0;
        i32 at = gp_->src;
        while (at != gp_->dest || idx < side.size()) {
            if (idx < side.size() && at == std::get<0>(side[idx])) {
                path.push_back(side[idx]);
                at = std::get<1>(side[idx]);
                idx++;
            } else {
                i32 nx = best_[at];
                path.emplace_back(at, nx, d_[at] - d_[nx]);
                at = nx;
            }
        }
        return path;
    }

    const std::vector<Dist> &d() const { return d_; }
    const std::vector<char> &reach() const { return reach_; }
    const std::vector<i32> &best() const { return best_; }

private:
    i32 heap_insert(i32 a, const Dist &k, i32 u, i32 v) {
        if (a == -1 || !dist_less(hk_[a], k, Mode::CalcSum)) {
            hk_.push_back(k); hu_.push_back(u); hv_.push_back(v);
            hl_.push_back(a); hr_.push_back(-1); hrank_.push_back(1);
            return (i32) hk_.size() - 1;
        }
        i32 l = hl_[a], r = heap_insert(hr_[a], k, u, v);
        if (l == -1 || hrank_[l] < hrank_[r]) std::swap(l, r);
        i32 rank = r != -1 ? hrank_[r] + 1 : 0;
        hk_.push_back(hk_[a]); hu_.push_back(hu_[a]); hv_.push_back(hv_[a]);
        hl_.push_back(l); hr_.push_back(r); hrank_.push_back(rank);
        return (i32) hk_.size() - 1;
    }

    struct QE {
        Dist d;
        i32 heap;
        i32 cand;
        bool operator>(const QE &o) const {
            if (dist_less(d, o.d, Mode::CalcSum)) return false;
            if (dist_less(o.d, d, Mode::CalcSum)) return true;
            if (heap != o.heap) return heap > o.heap;
            return cand > o.cand;
        }
    };

    void emplace(const Dist &d, i32 h, i32 pre) {
        i32 cur = (i32) cand_h_.size();
        cand_h_.push_back(h);
        cand_prev_.push_back(pre);
        cand_d_.push_back(d);
        qv_.push_back({d, h, cur});
        std::push_heap(qv_.begin(), qv_.end(), std::greater<QE>{});
    }

    const Graph *gp_ = nullptr;
    i64 V_ = 0;
    // reversed adjacency in CSR form + its Kahn topo order (prepare)
    std::vector<i32> roff_, rsrc_;
    std::vector<Dist> rw_;
    std::vector<i32> csr_cnt_;  // parallel counting-sort scratch
    std::vector<i32> rev_order_;
    std::vector<Dist> d_;
    std::vector<char> reach_;
    std::vector<i32> best_;
    // heap arena
    std::vector<Dist> hk_;
    std::vector<i32> hu_, hv_, hl_, hr_, hrank_;
    std::vector<i32> heap_of_;
    // candidates
    std::vector<i32> cand_h_, cand_prev_;
    std::vector<Dist> cand_d_;
    // binary heap over QE, maintained with push_heap/pop_heap — the
    // exact algorithm std::priority_queue runs, but on a vector whose
    // capacity survives reset()
    std::vector<QE> qv_;
    std::vector<Dist> dists_;
    std::vector<i32> last_;
    // recover() scratch
    mutable std::vector<std::tuple<i32, i32, Dist>> side_scratch_, path_scratch_;
    bool heaps_ready_ = false;
};

using EdgePath = std::vector<std::tuple<i32, i32, Dist>>;

// ---- QRY_SCORE-mode gap re-solve (paf_data.cpp:750-792) -------------
struct Upgrader {
    // reusable across contigs (thread_local in the solve entry points):
    // scratch keeps its capacity, the epoch stamps never reset — stale
    // entries from a previous contig always carry an older epoch
    const Graph *gp = nullptr;
    std::vector<i32> order_pos;
    std::vector<i32> order_vtx;
    // epoch-stamped scratch: recover() runs once per path edge, so a
    // hash map per call dominates on dense graphs; stamps make reuse O(1)
    mutable std::vector<Dist> dist_;
    mutable std::vector<i32> prev_;
    mutable std::vector<i64> stamp_;
    mutable i64 epoch_ = 0;

    Upgrader() = default;
    explicit Upgrader(const Graph &g_) { reset(g_); }

    // `fwd` = the contig's forward Kahn order if the caller already
    // computed it (identical to recomputing: Kahn is deterministic)
    void reset(const Graph &g_, const std::vector<i32> *fwd = nullptr) {
        gp = &g_;
        const auto &g = g_;
        if (fwd) order_vtx.assign(fwd->begin(), fwd->end());
        else topo_order_into(g.adj, g.nv(), order_vtx);
        order_pos.resize(order_vtx.size());
        for (i64 i = 0; i < (i64) order_vtx.size(); i++)
            order_pos[order_vtx[i]] = (i32) i;
        if ((i64) dist_.size() < g.nv()) {
            dist_.resize(g.nv());
            prev_.resize(g.nv());
            stamp_.resize(g.nv(), 0);
        }
    }

    // fills (and returns) the reusable member scratch — callers consume
    // the path before the next recover() call, which overwrites it
    EdgePath &recover(i32 s, i32 t, bool wl_flag = false, i32 wl = -1) const {
        const Graph &g = *gp;
        rec_scratch_.clear();
        if (s == t) return rec_scratch_;
        ++epoch_;
        auto seen = [&](i32 v) { return stamp_[v] == epoch_; };
        auto set = [&](i32 v, const Dist &d, i32 p) {
            stamp_[v] = epoch_;
            dist_[v] = d;
            prev_[v] = p;
        };
        set(s, Dist{}, -1);
        for (i32 i = order_pos[s]; i < order_pos[t]; i++) {
            i32 u = order_vtx[i];
            if (!seen(u)) continue;
            Dist du = dist_[u];
            for (const auto &e : g.adj[u]) {
                if (wl_flag && e.to == t) {
                    if (u == g.src || u == g.dest) continue;
                    if (g.vtx[u].second != wl) continue;
                }
                Dist nd = du + e.w;
                if (!seen(e.to) || dist_less(nd, dist_[e.to], Mode::QryScore))
                    set(e.to, nd, u);
            }
        }
        if (!seen(t)) throw std::runtime_error("gap re-solve: unreachable");
        EdgePath &path = rec_scratch_;
        i32 at = t;
        while (at != s) {
            i32 p = prev_[at];
            path.emplace_back(p, at, dist_[at] - dist_[p]);
            at = p;
        }
        std::reverse(path.begin(), path.end());
        return path;
    }

    // upgrade_edge_path_with_alt_path (paf_data.cpp:795-921); builds
    // the upgraded path in reusable scratch and swaps it into `path`
    // (the swap hands path's old buffer back to the scratch for reuse)
    void upgrade_inplace(EdgePath &path) const {
        const Graph &g = *gp;
        EdgePath &out = up_out_;
        out.clear();
        i64 n = (i64) path.size();
        for (i64 i = 0; i < n; i++) {
            auto [u, v, w] = path[i];
            if (u == g.src) {
                i32 y = g.vtx[v].second;
                auto [nu, nv, nw] = path[i + 1];
                if (nv == g.dest) {
                    auto &alt = recover(u, nv, true, y);
                    if (alt.empty()) out.push_back(path[i]);
                    else { alt.pop_back(); out.insert(out.end(), alt.begin(), alt.end()); }
                } else if (g.vtx[nv].first == g.vtx[nv].second) {
                    auto &alt = recover(u, nv, true, y);
                    if (alt.empty()) out.push_back(path[i]);
                    else { alt.pop_back(); out.insert(out.end(), alt.begin(), alt.end()); }
                } else {
                    auto &alt = recover(u, nv, false);
                    if (alt.empty()) { out.push_back(path[i]); out.push_back(path[i + 1]); }
                    else out.insert(out.end(), alt.begin(), alt.end());
                    i++;
                }
            } else if (v == g.dest) {
                i32 cont = std::get<1>(out.back());
                auto &alt = recover(cont, v, false);
                if (!alt.empty()) out.insert(out.end(), alt.begin(), alt.end());
            } else {
                i32 cont = std::get<1>(out.back());
                auto [x, y] = g.vtx[v];
                if (x != y) { out.push_back(path[i]); continue; }
                auto [nu, nv, nw] = path[i + 1];
                if (nv == g.dest || g.vtx[nv].first == g.vtx[nv].second) {
                    auto &alt = recover(cont, nv, true, y);
                    if (alt.empty()) out.push_back(path[i]);
                    else { alt.pop_back(); out.insert(out.end(), alt.begin(), alt.end()); }
                } else {
                    auto &alt = recover(cont, nv, false);
                    if (alt.empty()) { out.push_back(path[i]); out.push_back(path[i + 1]); }
                    else out.insert(out.end(), alt.begin(), alt.end());
                    i++;
                }
            }
        }
        path.swap(out);
    }

    mutable EdgePath rec_scratch_;
    mutable EdgePath up_out_;
};

}  // namespace

// ---- SINGLE_PIECE upgrade (paf_data.cpp:932-1486) -------------------
// Gap filling with one covering piece; runtime port of the reference's
// compile-time third mode.  Mirrors alignasm_tpu/engine/singlepiece.py
// (byte-validated against a constant-flipped reference build); the
// candidate loops iterate the RAW heap array of a libstdc++
// priority_queue — which this IS, so the order is exact by construction.
namespace {

struct PQV : std::priority_queue<std::pair<i64, i64>,
                                 std::vector<std::pair<i64, i64>>,
                                 std::greater<>> {
    const std::vector<std::pair<i64, i64>> &vec() const { return c; }
};

i64 run_containing(const RunSpan &runs, i64 x) {
    auto it = std::lower_bound(runs.begin(), runs.end(),
                               std::pair<i64, i64>(x + 1, -1));
    if (it != runs.begin() && std::prev(it)->second >= x)
        return (it - runs.begin()) - 1;
    return -1;
}

struct SweepHit {
    bool ok = false;
    i64 pe_q = 0, pe_r = 0, st_q = 0, st_r = 0;
    i64 range_idx = 0;
};

// two-pointer l-boundary search (paf_data.cpp:1166-1223)
SweepHit sweep_l(const Record &ldata, i64 pre_qs, const Record &data,
                 i64 range_idx) {
    SweepHit h;
    const auto &lq = ldata.qry_runs;
    const auto &lr = ldata.ref_runs;
    const auto &cq = data.qry_runs;
    const auto &cr = data.ref_runs;
    i64 step_pre = ldata.fwd ? 1 : -1;
    i64 step = data.fwd ? 1 : -1;
    i64 p = 0;
    while (p < (i64) lq.size() && range_idx < (i64) cq.size()) {
        if (lq[p].second < pre_qs) { p++; continue; }
        i64 l_i = lq[p].first, r_i = lq[p].second;
        i64 l_j = cq[range_idx].first, r_j = cq[range_idx].second;
        if (l_i < pre_qs) l_i = pre_qs;
        if (l_i == l_j) {
            if (l_j == r_j) { range_idx++; continue; }
            h = {true, l_i, lr[p].first + (l_i - lq[p].first) * step_pre,
                 l_j + 1, cr[range_idx].first + step, range_idx};
            return h;
        }
        if (l_i < l_j) {
            if (l_j <= r_i + 1) {
                h = {true, l_j - 1,
                     lr[p].first + (l_j - 1 - lq[p].first) * step_pre,
                     l_j, cr[range_idx].first, range_idx};
                return h;
            }
            p++;
        } else {
            if (l_i <= r_j - 1) {
                h = {true, l_i, lr[p].first + (l_i - lq[p].first) * step_pre,
                     l_i + 1, cr[range_idx].first + (l_i + 1 - l_j) * step,
                     range_idx};
                return h;
            }
            range_idx++;
        }
    }
    h.range_idx = range_idx;
    return h;
}

// two-pointer r-boundary search (paf_data.cpp:1011-1062)
SweepHit sweep_r(const Record &data, i64 range_idx, const Record &rdata,
                 i64 cur_qe) {
    SweepHit h;
    const auto &cq = data.qry_runs;
    const auto &cr = data.ref_runs;
    const auto &rq = rdata.qry_runs;
    const auto &rr = rdata.ref_runs;
    i64 step_pre = data.fwd ? 1 : -1;
    i64 step = rdata.fwd ? 1 : -1;
    i64 p = 0;
    while (p < (i64) rq.size() && range_idx < (i64) cq.size()) {
        if (rq[p].first > cur_qe) break;
        i64 l_i = cq[range_idx].first, r_i = cq[range_idx].second;
        i64 l_j = rq[p].first, r_j = rq[p].second;
        if (r_j > cur_qe) r_j = cur_qe;
        if (l_i == l_j) {
            if (l_j == r_j) { range_idx++; continue; }
            h = {true, l_i, cr[range_idx].first,
                 l_j + 1, rr[p].first + step, range_idx};
            return h;
        }
        if (l_i < l_j) {
            if (l_j <= r_i + 1) {
                h = {true, l_j - 1,
                     cr[range_idx].first + (l_j - 1 - l_i) * step_pre,
                     l_j, rr[p].first, range_idx};
                return h;
            }
            range_idx++;
        } else {
            if (l_i <= r_j - 1) {
                h = {true, l_i, cr[range_idx].first,
                     l_i + 1, rr[p].first + (l_i + 1 - l_j) * step, range_idx};
                return h;
            }
            p++;
        }
    }
    return h;
}

std::vector<OutRow> upgrade_single_piece(const Graph &g, const Config &cfg,
                                         std::vector<OutRow> rows) {
    if (rows.empty()) return rows;
    const auto &recs = g.recs;
    std::vector<const Record *> orig(g.n);
    for (const Record *r : recs) orig[r->ctg_index] = r;

    i64 qry_min = std::numeric_limits<i64>::max();
    i64 qry_max = std::numeric_limits<i64>::min();
    for (const Record *r : recs) {
        qry_min = std::min(qry_min, r->qry_str);
        qry_max = std::max(qry_max, r->qry_end);
    }

    PQV pq;
    i64 it_cur = 0;  // sorted-record sweep cursor (persists across gaps)
    auto advance = [&](i64 l, i64 r) {
        while (!pq.empty() && pq.top().first < r) pq.pop();
        while (it_cur < (i64) recs.size() && recs[it_cur]->qry_str <= l) {
            if (recs[it_cur]->qry_end >= r)
                pq.emplace(recs[it_cur]->qry_end, it_cur);
            it_cur++;
        }
    };
    auto node = [&](i64 sorted_idx, i64 qs, i64 qe, i64 rs, i64 re) -> OutRow {
        return {recs[sorted_idx]->ctg_index, qs, qe, rs, re, false};
    };
    auto ref_at = [](const Record &d, i64 run, i64 x) {
        i64 step = d.fwd ? 1 : -1;
        return d.ref_runs[run].first + (x - d.qry_runs[run].first) * step;
    };

    std::vector<OutRow> out;

    // ---- first node (paf_data.cpp:943-1095) -------------------------
    {
        const OutRow &cur = rows[0];
        i64 l = qry_min, r = cur.qs - 1;
        if (l >= r) {
            out.push_back(cur);
        } else {
            advance(l, r);
            if (pq.empty()) {
                out.push_back(cur);
            } else {
                const Record &rdata = *orig[cur.ctg_index];
                i64 r_sorted = rdata.sorted_index;
                Dist best_sc{};
                bool have = false;
                struct { i64 si, qs, qe, rs, re, ivr_q, ivr_r; } ans{};
                for (auto [end_, si] : pq.vec()) {
                    (void) end_;
                    const Record &data = *recs[si];
                    i64 iv_qs = data.qry_str, iv_rs = data.ref_str;
                    i64 iv_qe, iv_re, ivr_q, ivr_r;
                    i64 ri = run_containing(data.qry_runs, r);
                    if (ri >= 0) {
                        iv_qe = r;
                        iv_re = ref_at(data, ri, r);
                        ivr_q = cur.qs;
                        ivr_r = cur.rs;
                    } else {
                        SweepHit h = sweep_r(data, 0, rdata, cur.qe);
                        if (!h.ok) continue;
                        iv_qe = h.pe_q; iv_re = h.pe_r;
                        ivr_q = h.st_q; ivr_r = h.st_r;
                    }
                    Dist sc = score_between(cfg, data, *recs[r_sorted],
                                            iv_qe, iv_re, iv_rs,
                                            ivr_q, ivr_r, cur.re);
                    if (!have || dist_less(sc, best_sc, Mode::CalcSum)) {
                        have = true;
                        best_sc = sc;
                        ans = {si, iv_qs, iv_qe, iv_rs, iv_re, ivr_q, ivr_r};
                    }
                }
                if (!have) {
                    out.push_back(cur);
                } else {
                    out.push_back(node(ans.si, ans.qs, ans.qe, ans.rs, ans.re));
                    out.push_back(node(r_sorted, ans.ivr_q, cur.qe,
                                       ans.ivr_r, cur.re));
                }
            }
        }
    }

    // ---- main nodes (paf_data.cpp:1096-1336) ------------------------
    for (i64 i = 1; i < (i64) rows.size(); i++) {
        OutRow pre = out.back();
        const OutRow &cur = rows[i];
        i64 l = pre.qe + 1, r = cur.qs - 1;
        if (l >= r) { out.push_back(cur); continue; }
        advance(l, r);
        if (pq.empty()) { out.push_back(cur); continue; }
        const Record &ldata = *orig[pre.ctg_index];
        const Record &rdata = *orig[cur.ctg_index];
        Dist best_sc{};
        bool have = false;
        struct { i64 si, ivl_q, ivl_r, qs, qe, rs, re, ivr_q, ivr_r; } ans{};
        for (auto [end_, si] : pq.vec()) {
            (void) end_;
            const Record &data = *recs[si];
            i64 ivl_q, ivl_r, iv_qs, iv_rs, range_idx;
            i64 li = run_containing(data.qry_runs, l);
            if (li >= 0) {
                ivl_q = pre.qe; ivl_r = pre.re;
                iv_qs = l;
                iv_rs = ref_at(data, li, l);
                range_idx = li;
            } else {
                SweepHit h = sweep_l(ldata, pre.qs, data, 0);
                if (!h.ok) continue;
                ivl_q = h.pe_q; ivl_r = h.pe_r;
                iv_qs = h.st_q; iv_rs = h.st_r;
                range_idx = h.range_idx;
            }
            i64 iv_qe, iv_re, ivr_q, ivr_r;
            i64 ri = run_containing(data.qry_runs, r);
            if (ri >= 0) {
                iv_qe = r;
                iv_re = ref_at(data, ri, r);
                ivr_q = cur.qs; ivr_r = cur.rs;
            } else {
                SweepHit h = sweep_r(data, range_idx, rdata, cur.qe);
                if (!h.ok) continue;
                iv_qe = h.pe_q; iv_re = h.pe_r;
                ivr_q = h.st_q; ivr_r = h.st_r;
            }
            Dist sc = score_between(cfg, ldata, data,
                                    ivl_q, ivl_r, pre.rs,
                                    iv_qs, iv_rs, iv_re) +
                      score_between(cfg, data, rdata,
                                    iv_qe, iv_re, iv_rs,
                                    ivr_q, ivr_r, cur.re);
            if (!have || dist_less(sc, best_sc, Mode::CalcSum)) {
                have = true;
                best_sc = sc;
                ans = {si, ivl_q, ivl_r, iv_qs, iv_qe, iv_rs, iv_re,
                       ivr_q, ivr_r};
            }
        }
        if (!have) {
            out.push_back(cur);
        } else {
            out.pop_back();
            out.push_back(node(ldata.sorted_index, pre.qs, ans.ivl_q,
                               pre.rs, ans.ivl_r));
            out.push_back(node(ans.si, ans.qs, ans.qe, ans.rs, ans.re));
            out.push_back(node(rdata.sorted_index, ans.ivr_q, cur.qe,
                               ans.ivr_r, cur.re));
        }
    }

    // ---- last node (paf_data.cpp:1337-1481) -------------------------
    {
        OutRow pre = out.back();
        i64 l = pre.qe + 1, r = qry_max;
        if (l < r) {
            advance(l, r);
            if (!pq.empty()) {
                const Record &ldata = *orig[pre.ctg_index];
                Dist best_sc{};
                bool have = false;
                struct { i64 si, ivl_q, ivl_r, qs, qe, rs, re; } ans{};
                for (auto [end_, si] : pq.vec()) {
                    (void) end_;
                    const Record &data = *recs[si];
                    i64 ivl_q, ivl_r, iv_qs, iv_rs;
                    i64 li = run_containing(data.qry_runs, l);
                    if (li >= 0) {
                        ivl_q = pre.qe; ivl_r = pre.re;
                        iv_qs = l;
                        iv_rs = ref_at(data, li, l);
                    } else {
                        SweepHit h = sweep_l(ldata, pre.qs, data, 0);
                        if (!h.ok) continue;
                        ivl_q = h.pe_q; ivl_r = h.pe_r;
                        iv_qs = h.st_q; iv_rs = h.st_r;
                    }
                    i64 iv_qe = data.qry_end, iv_re = data.ref_end;
                    Dist sc = score_between(cfg, ldata, data,
                                            ivl_q, ivl_r, pre.rs,
                                            iv_qs, iv_rs, iv_re);
                    if (!have || dist_less(sc, best_sc, Mode::CalcSum)) {
                        have = true;
                        best_sc = sc;
                        ans = {si, ivl_q, ivl_r, iv_qs, iv_qe, iv_rs, iv_re};
                    }
                }
                if (have) {
                    out.pop_back();
                    out.push_back(node(ldata.sorted_index, pre.qs, ans.ivl_q,
                                       pre.rs, ans.ivl_r));
                    out.push_back(node(ans.si, ans.qs, ans.qe, ans.rs, ans.re));
                }
            }
        }
    }
    return out;
}

}  // namespace

// ---- edge path -> output rows (paf_data.cpp:1489-1568) --------------
// per-contig "not alt" record set.  The reference stores only `true`
// values and tests membership, so an epoch-stamped flat set reproduces
// it exactly without the per-insert node mallocs of unordered_map
// (8% of the pipeline's allocation sites); epochs stay monotone across
// contigs, so stale stamps never match.
struct NotAlt {
    std::vector<i64> stamp;
    i64 epoch = 0;
    void begin_contig() { ++epoch; }
    void add(i64 i) {
        if ((i64) stamp.size() <= i) stamp.resize((size_t) i + 1, 0);
        stamp[(size_t) i] = epoch;
    }
    bool has(i64 i) const {
        return i >= 0 && i < (i64) stamp.size() && stamp[(size_t) i] == epoch;
    }
};

// `path` is consumed (upgraded in place, then read) — callers pass a
// scratch buffer they no longer need
static std::vector<OutRow> to_rows(const Graph &g, const Upgrader &up,
                                   EdgePath &path, NotAlt &not_alt,
                                   const Config &cfg) {
    for (auto &[u, v, w] : path) {
        if (v != g.dest) {
            auto [x, y] = g.vtx[v];
            not_alt.add(g.recs[x]->ctg_index);
            not_alt.add(g.recs[y]->ctg_index);
        }
    }
    if (cfg.upgrade_mode == 0)
        up.upgrade_inplace(path);
    if (debug_walks()) {
        fprintf(stderr, "upgraded:");
        for (auto &[u, v, w] : path) fprintf(stderr, " %d->%d", u, v);
        fprintf(stderr, "\n");
    }
    std::vector<OutRow> rows;
    auto push = [&](i64 rec_sorted) {
        const Record &r = *g.recs[rec_sorted];
        rows.push_back({r.ctg_index, r.qry_str, r.qry_end, r.ref_str, r.ref_end, false});
    };
    auto cut_between = [&](i64 a, i64 b) {
        i32 id = g.vid(a, b);
        auto &px = rows[rows.size() - 2];
        px.qe = g.cut_pe_q[id];
        px.re = g.cut_pe_r[id];
        auto &py = rows.back();
        py.qs = g.cut_st_q[id];
        py.rs = g.cut_st_r[id];
    };
    for (const auto &[u, v, w] : path) {
        if (u == g.src) {
            push(g.vtx[v].first);
        } else if (v == g.dest) {
            // nothing
        } else {
            auto [x1, x2] = g.vtx[u];
            auto [y1, y2] = g.vtx[v];
            if (x1 == x2) {
                if (y1 == y2) push(y1);
                else { push(y2); cut_between(y1, y2); }
            } else {
                if (y1 == y2) push(y2);
                else { push(y2); cut_between(x2, y2); }
            }
        }
    }
    if (cfg.upgrade_mode == 1)
        rows = upgrade_single_piece(g, cfg, std::move(rows));
    for (auto &row : rows)
        row.alt_flag = !not_alt.has(row.ctg_index);
    return rows;
}

static i64 coverage(const std::vector<OutRow> &rows) {
    i64 c = 0;
    for (const auto &r : rows) c += (r.qe - r.qs) + std::abs(r.re - r.rs);
    return c;
}

// min-anomaly floor, computed as a DAG DP (value-equal to the
// reference's Dial BFS, k_weighted_bfs.hpp:16).  `order` is the
// caller's forward Kahn order — the min-DP result is order-independent
// for any topological order, and sharing one per contig saves two of
// the three per-contig topo passes.
static i64 anom_floor(const Graph &g, const std::vector<i32> &order) {
    static thread_local std::vector<i64> f;
    f.assign(g.nv(), std::numeric_limits<i64>::max());
    f[g.src] = 0;
    for (i32 u : order) {
        if (f[u] == std::numeric_limits<i64>::max()) continue;
        for (const auto &e : g.adj[u]) f[e.to] = std::min(f[e.to], f[u] + e.w.a);
    }
    return f[g.dest];
}

// per-anomaly-level minimum score sums to dest (for the lazy-walk
// early-stop bound); levels above `cap` are ignored
static std::vector<i64> level_min_sums(const Graph &g, i64 cap,
                                       const std::vector<i32> &order) {
    const i64 INF = std::numeric_limits<i64>::max();
    i64 W = cap + 1;
    // flat (V, cap+1) row-major table in thread_local scratch (the
    // nested-vector form allocated V inner vectors per call)
    static thread_local std::vector<i64> f;
    f.assign(g.nv() * W, INF);
    f[g.src * W] = 0;
    for (i32 u : order) {
        const i64 *fu = &f[(i64) u * W];
        for (i64 a = 0; a <= cap; a++) {
            if (fu[a] == INF) continue;
            for (const auto &e : g.adj[u]) {
                i64 a2 = a + e.w.a;
                if (a2 > cap) continue;
                i64 &cell = f[(i64) e.to * W + a2];
                cell = std::min(cell, fu[a] + e.w.sum());
            }
        }
    }
    return std::vector<i64>(f.begin() + g.dest * W,
                            f.begin() + (g.dest + 1) * W);
}

const char *const trace_names[kTraceSlots] = {
    "solve_build", "topo", "walk_dp", "fast_rows", "lazy_enum", "select",
    "parse", "format", "scan", "build", "fast", "fallback", "flush", "solve",
    "teardown", "alt_merge", "alt_build"};
std::atomic<bool> trace_flag{false};
namespace {
std::atomic<long long> trace_ns[kTraceSlots], trace_n[kTraceSlots];
// one thread's sums; a worker thread's reach the table when it ends
struct TraceLocal {
    long long ns[kTraceSlots] = {}, n[kTraceSlots] = {};
    bool any = false;
    ~TraceLocal() { flush(); }
    void flush() {
        if (!any) return;
        for (int k = 0; k < kTraceSlots; k++) {
            if (!n[k]) continue;
            trace_ns[k].fetch_add(ns[k], std::memory_order_relaxed);
            trace_n[k].fetch_add(n[k], std::memory_order_relaxed);
            ns[k] = n[k] = 0;
        }
        any = false;
    }
};
thread_local TraceLocal trace_local;
}  // namespace
void trace_add(int slot, long long ns) {
    trace_local.ns[slot] += ns;
    trace_local.n[slot]++;
    trace_local.any = true;
}
void trace_count(int slot, long long ns) {
    trace_ns[slot].fetch_add(ns, std::memory_order_relaxed);
    trace_n[slot].fetch_add(1, std::memory_order_relaxed);
}
void trace_flush() { trace_local.flush(); }
void trace_take(long long *ns, long long *n) {
    trace_flush();
    for (int k = 0; k < kTraceSlots; k++) {
        ns[k] = trace_ns[k].exchange(0, std::memory_order_relaxed);
        n[k] = trace_n[k].exchange(0, std::memory_order_relaxed);
    }
}

ContigResult solve_contig(std::vector<Record> &records, const Config &cfg) {
    ContigResult res;
    if (records.size() == 1) {
        records[0].sorted_index = 0;
        const Record &r = records[0];
        res.out.push_back({r.ctg_index, r.qry_str, r.qry_end, r.ref_str, r.ref_end, false});
        return res;
    }
    // per-thread scratch graph: the fused pipeline discards the graph
    // after the solve, so its ~V inner edge vectors + tables keep
    // their capacity across this thread's contigs
    static thread_local Graph g;
    {
        TraceScope ps(kSolveBuild);
        build_graph_into(records, cfg, g);
    }
    return solve_from_graph(g, cfg);
}

// Steps 6-10 of solve_ctg_read on an already-built DAG — the device
// engine's fallback target reuses graphs built at export time instead
// of rebuilding them.
ContigResult solve_from_graph(const Graph &g, const Config &cfg) {
    ContigResult res;
    // per-thread reusable solver state: one contig is solved at a time
    // per worker thread and solve_from_graph never re-enters itself
    // (to_rows/upgrade never solve), so thread_local instances whose
    // buffers keep their capacity across contigs are behavior-identical
    // to fresh objects — glibc malloc was >50% of -t1 solve time
    static thread_local std::vector<i32> fwd_order;
    static thread_local Walks walks;
    static thread_local Upgrader up_tl;
    i64 floor_a;
    {
        TraceScope ps(kTopo);
        topo_order_into(g.adj, g.nv(), fwd_order);
        floor_a = anom_floor(g, fwd_order);
    }
    {
        TraceScope ps(kWalkDp);
        walks.reset(g);
        if (!walks.prepare()) throw std::runtime_error("dest unreachable");
    }

    // by value: the dists vector reallocates as walks are emitted
    const Dist min_d = walks.dists()[0];

    // fast path: unique best walk, no anomaly tradeoff possible — the
    // tie sweep and alt scan are both no-ops, so skip Eppstein entirely
    if (cfg.lazy_walks && min_d.a == floor_a &&
        walks.count_min_walks(2) == 1) {
        TraceScope ps(kFastRows);
        up_tl.reset(g, &fwd_order);
        static thread_local NotAlt not_alt0;
        not_alt0.begin_contig();
        EdgePath &p0 = walks.recover(0);
        res.out = to_rows(g, up_tl, p0, not_alt0, cfg);
        return res;
    }

    // lazy enumeration budget: the reference always enumerates k=10000
    // walks; walks beyond max(level-min k1 bound) provably cannot
    // change any output (see engine/device.py finish logic), so stop
    // early while keeping the scan semantics identical.
    i64 k_budget = cfg.max_path_count;
    i64 stop_sum = std::numeric_limits<i64>::max();
    i64 stop_anom = std::numeric_limits<i64>::max();
    bool need_alt = min_d.a != floor_a;
    if (cfg.lazy_walks) {
        i64 tie_bound_sum = min_d.sum(), tie_bound_anom = min_d.a;
        if (!need_alt) {
            stop_sum = tie_bound_sum;
            stop_anom = tie_bound_anom;
        } else {
            auto lv = level_min_sums(g, min_d.a - 1, fwd_order);
            // improving sequence: levels in ascending (sum, anom);
            // only improving levels' groups are ever converted
            std::vector<std::pair<i64, i64>> cand;  // (sum, anom)
            for (i64 a = 0; a < (i64) lv.size(); a++)
                if (lv[a] != std::numeric_limits<i64>::max())
                    cand.emplace_back(lv[a], a);
            std::sort(cand.begin(), cand.end());
            i64 best_up = 0, best_down = 0;
            bool have = false;
            i64 bound_sum = tie_bound_sum, bound_anom = tie_bound_anom;
            for (auto [s, a] : cand) {
                i64 up = s - min_d.sum(), down = min_d.a - a;
                if (!have || up * best_down < down * best_up) {
                    have = true;
                    best_up = up;
                    best_down = down;
                    if (s > bound_sum || (s == bound_sum && a > bound_anom)) {
                        bound_sum = s;
                        bound_anom = a;
                    }
                }
            }
            stop_sum = bound_sum;
            stop_anom = bound_anom;
        }
    }
    // enumerate until the bound (exclusive of walks strictly beyond it)
    {
        TraceScope ps(kLazyEnum);
        while ((i64) walks.dists().size() < k_budget) {
            if (!walks.next()) break;
            const Dist &d = walks.dists().back();
            if (d.sum() > stop_sum
                || (d.sum() == stop_sum && d.a > stop_anom)) break;
        }
    }
    TraceScope ps_sel(kSelect);
    const auto &kd = walks.dists();

    if (debug_walks()) {
        for (i64 i = 0; i < (i64) kd.size(); i++) {
            const Dist &d = kd[i];
            fprintf(stderr, "walk %lld: %lld %lld %lld %lld %lld |", (long long) i,
                    (long long) d.q, (long long) d.r, (long long) d.a,
                    (long long) d.nz, (long long) d.tot);
            for (auto &[u, v, w] : walks.recover(i))
                fprintf(stderr, " %d->%d", u, v);
            fprintf(stderr, "\n");
        }
    }

    up_tl.reset(g, &fwd_order);
    Upgrader &up = up_tl;
    // accumulates across converts within the contig, like the
    // reference's shared map
    static thread_local NotAlt not_alt;
    not_alt.begin_contig();
    auto convert = [&](i64 k) { return to_rows(g, up, walks.recover(k), not_alt, cfg); };

    res.out = convert(0);
    i64 max_cov = coverage(res.out);
    auto eq_sum_anom = [](const Dist &a, const Dist &b) {
        return a.sum() == b.sum() && a.a == b.a;
    };
    for (i64 idx = 1; idx < (i64) kd.size() && eq_sum_anom(min_d, kd[idx]); idx++) {
        auto rows = convert(idx);
        i64 cov = coverage(rows);
        if (cov > max_cov) {
            max_cov = cov;
            res.out = std::move(rows);
            res.max_out.clear();
        } else if (cov == max_cov) {
            res.max_out.push_back(std::move(rows));
        }
    }

    max_cov = -1;
    if ((i64) kd.size() >= 2 && need_alt) {
        i64 ans_up = 0, ans_down = 0, ans_idx = -1;
        for (i64 i = 1; i < (i64) kd.size(); i++) {
            const Dist &d = kd[i];
            if (d.a >= min_d.a) continue;
            i64 u2 = d.sum() - min_d.sum();
            i64 dn = min_d.a - d.a;
            if (ans_idx == -1 || u2 * ans_down < dn * ans_up) {
                ans_up = u2;
                ans_down = dn;
                ans_idx = i;
                res.alt = convert(ans_idx);
                max_cov = coverage(res.alt);
            } else if (ans_idx != -1 && eq_sum_anom(d, kd[ans_idx])) {
                auto rows = convert(i);
                i64 cov = coverage(rows);
                if (cov > max_cov) {
                    max_cov = cov;
                    res.alt = std::move(rows);
                }
            }
        }
    }
    return res;
}

// Device-assisted finish: verts is the device-chased min-walk vertex
// sequence (src..dest, n entries).  The caller guarantees the provably
// order-insensitive case (cnt_min == 1, no alt scan — see
// engine/device.py docstring), which makes the achieving path UNIQUE,
// so no fraction/rank tie-breaks are needed to reproduce the
// reference's best walk; (u, v) determines the edge because
// parallel-edge contigs never enter the dense path (export.cc's
// duplicate-cell status).
ContigResult finish_from_path(const Graph &g, const i32 *verts, int n,
                              const Config &cfg) {
    EdgePath path;
    for (int k = 0; k + 1 < n; k++) {
        i32 u = verts[k], v = verts[k + 1];
        const Edge *hit = nullptr;
        for (const auto &e : g.adj[u]) {
            if (e.to == v) {
                hit = &e;
                break;
            }
        }
        if (!hit) throw std::runtime_error("device path edge missing");
        path.emplace_back(u, v, hit->w);
    }
    static thread_local Upgrader up_tl;
    up_tl.reset(g);
    static thread_local NotAlt not_alt;
    not_alt.begin_contig();
    ContigResult res;
    res.out = to_rows(g, up_tl, path, not_alt, cfg);
    return res;
}

}  // namespace aln
