#include "cs.h"

#include <algorithm>
#include <charconv>
#include <cstdlib>
#include <stdexcept>

namespace aln {

static bool alpha(char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}

CsOps parse_cs(std::string_view cs) {
    CsOps ops;
    parse_cs_into(cs, ops);
    return ops;
}

void parse_cs_into(std::string_view cs, CsOps &ops, bool with_spans) {
    if (cs.substr(0, 5) != "cs:Z:")
        throw std::runtime_error("record lacks a short-form cs:Z tag");
    ops.op.clear();
    ops.len.clear();
    ops.beg.clear();
    ops.end.clear();
    size_t pos = 5, n = cs.size();
    while (pos < n) {
        size_t beg = pos;
        char t = cs[pos++];
        i64 len = 0;
        if (t == ':') {
            auto res = std::from_chars(cs.data() + pos, cs.data() + n, len);
            if (res.ec != std::errc{} || res.ptr == cs.data() + pos || len <= 0)
                throw std::runtime_error("invalid :length op in cs tag");
            pos = res.ptr - cs.data();
        } else if (t == '*') {
            if (pos + 2 > n || !alpha(cs[pos]) || !alpha(cs[pos + 1]))
                throw std::runtime_error("invalid substitution op in cs tag");
            pos += 2;
            len = 1;
        } else if (t == '+' || t == '-') {
            size_t s = pos;
            while (pos < n && alpha(cs[pos])) ++pos;
            len = (i64) (pos - s);
            if (!len) throw std::runtime_error("empty indel op in cs tag");
        } else {
            throw std::runtime_error("unsupported op in cs tag");
        }
        ops.op.push_back(t);
        ops.len.push_back(len);
        if (with_spans) {
            ops.beg.push_back((i32) beg);
            ops.end.push_back((i32) pos);
        }
    }
}

// iterate ops in query orientation (file order reversed for '-' strand)
template <typename F>
static void for_query_oriented(const CsOps &ops, bool fwd, F fn) {
    i64 n = (i64) ops.op.size();
    if (fwd)
        for (i64 i = 0; i < n; i++) fn(ops.op[i], ops.len[i], i);
    else
        for (i64 i = n - 1; i >= 0; i--) fn(ops.op[i], ops.len[i], i);
}

void build_runs(Record &rec, RunArena &arena) {
    std::string_view cs = rec.cs;
    // ':' appears ONLY as a match-op introducer (lengths are digits,
    // indel/sub payloads are bases), so the match-run count is one
    // vectorized scan — the arena slab can be sized before the walk
    if (cs.substr(0, 5) != "cs:Z:")
        throw std::runtime_error("record lacks a short-form cs:Z tag");
    size_t n_match = (size_t) std::count(cs.begin() + 5, cs.end(), ':');
    std::pair<i64, i64> *q = arena.alloc(2 * n_match);
    std::pair<i64, i64> *r = q + n_match;
    i64 step = rec.fwd ? 1 : -1;
    i64 ri = rec.ref_str, qi = rec.qry_str;
    i64 k = 0;
    if (rec.fwd) {
        // fused single pass: decode ops and emit runs directly — the
        // CsOps vectors (4 push_back streams per op) were the hot half
        // of the parallel parse at 100k-contig scale
        const char *p = cs.data() + 5, *e = cs.data() + cs.size();
        while (p < e) {
            char t = *p++;
            if (t == ':') {
                i64 len = 0;
                auto res = std::from_chars(p, e, len);
                if (res.ec != std::errc{} || res.ptr == p || len <= 0)
                    throw std::runtime_error("invalid :length op in cs tag");
                p = res.ptr;
                r[k] = {ri, ri + len - 1};
                q[k] = {qi, qi + len - 1};
                k++;
                ri += len;
                qi += len;
            } else if (t == '*') {
                if (p + 2 > e || !alpha(p[0]) || !alpha(p[1]))
                    throw std::runtime_error(
                        "invalid substitution op in cs tag");
                p += 2;
                ri += 1;
                qi += 1;
            } else if (t == '+' || t == '-') {
                const char *s0 = p;
                while (p < e && alpha(*p)) ++p;
                if (p == s0)
                    throw std::runtime_error("empty indel op in cs tag");
                if (t == '+') qi += p - s0;
                else ri += p - s0;
            } else {
                throw std::runtime_error("unsupported op in cs tag");
            }
        }
    } else {
        // reverse strand iterates ops in reversed file order: decode
        // into the reusable op list first, then walk it backwards
        static thread_local CsOps ops;
        parse_cs_into(cs, ops, /*with_spans=*/false);
        for_query_oriented(ops, false, [&](char t, i64 len, i64) {
            if (t == ':') {
                r[k] = {ri, ri + (len - 1) * step};
                q[k] = {qi, qi + len - 1};
                k++;
                ri += len * step;
                qi += len;
            } else if (t == '+') {
                qi += len;
            } else if (t == '-') {
                ri += len * step;
            } else {
                ri += step;
                qi += 1;
            }
        });
    }
    rec.qry_runs = {q, (i64) n_match};
    rec.ref_runs = {r, (i64) n_match};
    if ((i64) n_match != k)
        throw std::runtime_error("invalid :length op in cs tag");
    if (qi != rec.qry_end + 1 || ri != rec.ref_end + step)
        throw std::runtime_error("cs consumption does not match PAF coords");
}

std::string_view clip_cs_view(const Record &rec, i64 eqs, i64 eqe, i64 ers,
                              i64 ere, std::string &scratch, i32 &mat_num,
                              i32 &aln_len) {
    if (eqs == rec.qry_str && eqe == rec.qry_end) {
        mat_num = rec.mat_num;
        aln_len = rec.aln_len;
        return rec.cs;
    }
    // scratch-backed cut path: the op decode and kept-op list reuse
    // thread-local capacity — this runs once per CUT output row inside
    // the parallel format workers, and per-row vector allocations were
    // a measurable share of that phase
    static thread_local CsOps ops;
    parse_cs_into(rec.cs, ops);
    struct Kept { char t; i64 len; i32 beg, end; };
    static thread_local std::vector<Kept> kept;
    kept.clear();
    i64 qi = rec.qry_str;
    for_query_oriented(ops, rec.fwd, [&](char t, i64 len, i64 i) {
        if (t == ':') {
            i64 op_end = qi + len - 1;
            i64 ks = std::max(qi, eqs), ke = std::min(op_end, eqe);
            if (ks <= ke) kept.push_back({':', ke - ks + 1, 0, 0});
            qi += len;
        } else if (t == '+') {
            i64 op_end = qi + len - 1;
            if (qi <= eqe && eqs <= op_end) {
                if (qi < eqs || eqe < op_end)
                    throw std::runtime_error("alignment clipped inside insertion");
                kept.push_back({'+', len, ops.beg[i], ops.end[i]});
            }
            qi += len;
        } else if (t == '*') {
            if (eqs <= qi && qi <= eqe)
                kept.push_back({'*', 1, ops.beg[i], ops.end[i]});
            qi += 1;
        } else {  // '-': deletion kept only strictly inside the left cut
            if (eqs < qi && qi <= eqe)
                kept.push_back({'-', len, ops.beg[i], ops.end[i]});
        }
    });
    if (!rec.fwd) std::reverse(kept.begin(), kept.end());

    mat_num = 0;
    aln_len = 0;
    scratch.clear();
    scratch += "cs:Z:";
    i64 qbases = 0, rbases = 0;
    char buf[24];
    for (const auto &k : kept) {
        if (k.t == ':') {
            scratch += ':';
            auto r = std::to_chars(buf, buf + sizeof(buf), k.len);
            scratch.append(buf, r.ptr);
            mat_num += (i32) k.len;
            aln_len += (i32) k.len;
            qbases += k.len;
            rbases += k.len;
        } else {
            scratch.append(rec.cs.substr(k.beg, k.end - k.beg));
            aln_len += (i32) k.len;
            if (k.t == '+') qbases += k.len;
            else if (k.t == '-') rbases += k.len;
            else { qbases += 1; rbases += 1; }
        }
    }
    if (qbases != eqe - eqs + 1 || rbases != std::abs(ere - ers) + 1)
        throw std::runtime_error("edited cs does not match edited coords");
    return scratch;
}

}  // namespace aln
