// Short-form cs:Z: tag machinery (parse / match-run ranges / clip).
// Parity: paf_data.cpp:29-220 via the validated Python engine
// (alignasm_tpu/io/cs.py).
#pragma once

#include <string>
#include <string_view>

#include "types.h"

namespace aln {

// Decoded op stream: one byte code + length + source span per op.
struct CsOps {
    std::vector<char> op;       // ':', '*', '+', '-'
    std::vector<i64> len;
    std::vector<i32> beg, end;  // char spans in the raw tag
};

// throws std::runtime_error on malformed tags (reference throws too)
CsOps parse_cs(std::string_view cs);
// same, reusing the caller's CsOps capacity (hot parse path).
// with_spans=false skips the beg/end char-span vectors — build_runs
// never reads them (only the clip path slices the raw tag), and the
// two extra push_backs per op were a measurable share of the parse
void parse_cs_into(std::string_view cs, CsOps &ops,
                   bool with_spans = true);

// fills rec.qry_runs / rec.ref_runs (spans into `arena`, which must
// outlive the record) and validates consumption against the record's
// (closed, strand-swapped) coordinates
void build_runs(Record &rec, RunArena &arena);

// allocation-free form for the hot format path: returns the edited cs
// text as a view into rec.cs (uncut row) or into `scratch` (cut row —
// cleared and refilled); mat_num/aln_len are written out-params
std::string_view clip_cs_view(const Record &rec, i64 eqs, i64 eqe, i64 ers,
                              i64 ere, std::string &scratch, i32 &mat_num,
                              i32 &aln_len);

}  // namespace aln
