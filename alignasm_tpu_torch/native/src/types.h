// Core value types of the native host plane.
//
// Behavioral parity targets live in the Python exact engine
// (alignasm_tpu/engine/*.py), which is byte-identical to the C++
// reference; this C++ layer mirrors that engine for host throughput.
// Reference citations: scoring semiring paf_data.hpp:115-189, record
// model paf_data.hpp:51-87.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <string_view>
#include <utility>
#include <vector>

namespace aln {

using i64 = int64_t;
using i32 = int32_t;

struct Config {
    i64 qry_weight = 1;
    i64 ref_weight = 1;
    i64 ref_negative_penalty = 2;
    i64 sv_baseline = 1'000'000;
    i64 sv_trans_penalty = 2000;
    i64 sv_inv_penalty = 500;
    i64 sv_front_end_coefficient = 2;
    i64 max_path_count = 10'000;
    i64 max_anom = 1;
    double alt_baseline = 0.5;
    bool non_skip_linkable = false;
    bool lazy_walks = true;  // early-stopped enumeration (same results)
    // the reference's compile-time UPGRADE_MODE (paf_data.hpp:13-18),
    // runtime here: 0 = alt_path, 1 = single_piece, 2 = no_update
    int upgrade_mode = 0;
};

// The scoring semiring value.  Comparison modes: CALC_SUM orders by
// (qry+ref, anom, mapq-fraction desc); QRY_SCORE by (qry, ref, anom,
// fraction desc).  Fraction ties compare by cross-multiplication.
struct Dist {
    i64 q = 0, r = 0, a = 0, nz = 0, tot = 0;

    Dist operator+(const Dist &o) const {
        return {q + o.q, r + o.r, a + o.a, nz + o.nz, tot + o.tot};
    }
    Dist operator-(const Dist &o) const {
        return {q - o.q, r - o.r, a - o.a, nz - o.nz, tot - o.tot};
    }
    i64 sum() const { return q + r; }

    // full equality as the reference defines it (fraction cross-mult)
    bool eq(const Dist &o) const {
        i64 t1 = tot ? tot : 1, t2 = o.tot ? o.tot : 1;
        return q == o.q && r == o.r && a == o.a && nz * t2 == o.nz * t1;
    }
    bool is_zero_like() const {  // == identity under eq()
        return q == 0 && r == 0 && a == 0 && nz == 0;
    }
};

enum class Mode { CalcSum, QryScore };

// strict-weak "less" of the chosen mode (never call with MAX sentinels;
// the solver tracks reachability separately)
inline bool dist_less(const Dist &x, const Dist &y, Mode m) {
    if (m == Mode::CalcSum) {
        if (x.sum() != y.sum()) return x.sum() < y.sum();
    } else {
        if (x.q != y.q) return x.q < y.q;
        if (x.r != y.r) return x.r < y.r;
    }
    if (x.a != y.a) return x.a < y.a;
    i64 t1 = x.tot ? x.tot : 1, t2 = y.tot ? y.tot : 1;
    return x.nz * t2 > y.nz * t1;  // larger fraction = smaller distance
}

// borrowed view of a record's match runs, stored in a RunArena whose
// blocks never move — valid for the owning Dataset's lifetime.  Two
// heap vectors per record were the single largest allocation site of
// the whole pipeline (~2 x 850k per 50k-contig corpus).
struct RunSpan {
    const std::pair<i64, i64> *ptr = nullptr;
    i64 len = 0;
    const std::pair<i64, i64> *begin() const { return ptr; }
    const std::pair<i64, i64> *end() const { return ptr + len; }
    i64 size() const { return len; }
    bool empty() const { return len == 0; }
    const std::pair<i64, i64> &operator[](i64 i) const { return ptr[i]; }
};

// bump arena for match runs: one per parse worker (no locking), block
// addresses stable forever, freed with the Dataset
struct RunArena {
    std::vector<std::unique_ptr<std::pair<i64, i64>[]>> blocks;
    size_t cap = 0, used = 0;
    std::pair<i64, i64> *alloc(size_t n) {
        if (used + n > cap) {
            size_t bs = std::max<size_t>(n, size_t(1) << 15);
            blocks.emplace_back(new std::pair<i64, i64>[bs]);
            cap = bs;
            used = 0;
        }
        auto *p = blocks.back().get() + used;
        used += n;
        return p;
    }
};

struct Record {
    i32 ctg_index = -1;
    i32 sorted_index = -1;
    std::string_view cs;     // full cs:Z: tag (points into the file buffer)
    i32 mat_num = 0;
    i32 aln_len = 0;
    // match-run closed intervals, query orientation
    RunSpan qry_runs;
    RunSpan ref_runs;
    i64 qry_total = 0, ref_total = 0;
    i64 qry_str = 0, qry_end = 0;   // closed
    i64 ref_str = 0, ref_end = 0;   // closed, strand-swapped
    i32 ref_chr = -1;
    uint8_t map_qul = 0;
    bool fwd = true;
    i32 cord_type = 0;   // 0 = main PAF row, 1 = alt PAF row
    i32 cord_row = -1;

    bool contains(const Record &o) const {
        return qry_str <= o.qry_str && o.qry_end <= qry_end;
    }
};

inline bool partial_overlap(const Record &a, const Record &b) {
    if (a.qry_str < b.qry_str)
        return b.qry_str <= a.qry_end && a.qry_end < b.qry_end;
    if (b.qry_str < a.qry_str)
        return a.qry_str <= b.qry_end && b.qry_end < a.qry_end;
    return false;
}

struct OutRow {
    i32 ctg_index = -1;
    i64 qs = 0, qe = 0, rs = 0, re = 0;  // edited coords (closed)
    bool alt_flag = false;
};

}  // namespace aln
