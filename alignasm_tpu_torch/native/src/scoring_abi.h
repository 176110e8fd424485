// Scoring knobs crossing the C ABI (mirrors
// alignasm_tpu.native.ScoringParams).  Reference defaults when null.
#pragma once

#include "types.h"

struct AlnScoring {
    long long qry_weight, ref_weight, ref_negative_penalty;
    long long sv_baseline, sv_trans_penalty, sv_inv_penalty;
    long long sv_front_end_coefficient, max_path_count;
    long long upgrade_mode;  // 0 alt_path, 1 single_piece, 2 no_update
};

namespace aln {
inline void apply_scoring(Config &cfg, const AlnScoring *s) {
    if (!s) return;
    cfg.qry_weight = s->qry_weight;
    cfg.ref_weight = s->ref_weight;
    cfg.ref_negative_penalty = s->ref_negative_penalty;
    cfg.sv_baseline = s->sv_baseline;
    cfg.sv_trans_penalty = s->sv_trans_penalty;
    cfg.sv_inv_penalty = s->sv_inv_penalty;
    cfg.sv_front_end_coefficient = s->sv_front_end_coefficient;
    cfg.max_path_count = s->max_path_count;
    cfg.upgrade_mode = (int) s->upgrade_mode;
}
}  // namespace aln
