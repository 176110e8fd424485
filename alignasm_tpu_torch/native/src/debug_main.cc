// Debug driver: same stdin protocol as tests/oracle/solve_harness.cpp,
// so the native solver can be diffed against the reference directly.
#include <iostream>

#include "cs.h"
#include "solver.h"

int main(int argc, char **argv) {
    aln::Config cfg;
    for (int i = 1; i < argc; i++) {
        std::string a = argv[i];
        if (a == "--non-skip-linkable") cfg.non_skip_linkable = true;
        if (a == "--no-lazy") cfg.lazy_walks = false;
    }
    int64_t n;
    int64_t contig_no = 0;
    std::vector<std::string> cs_store;
    aln::RunArena arena;
    while (std::cin >> n) {
        cs_store.clear();
        cs_store.reserve(n);
        std::vector<aln::Record> recs(n);
        for (auto &r : recs) {
            int fwd, qul;
            int64_t chr;
            std::string cs;
            std::cin >> r.ctg_index >> r.qry_total >> r.qry_str >> r.qry_end >>
                r.ref_total >> r.ref_str >> r.ref_end >> chr >> qul >> fwd >>
                r.mat_num >> r.aln_len >> cs;
            r.ref_chr = (aln::i32) chr;
            r.map_qul = (uint8_t) qul;
            r.fwd = fwd != 0;
            cs_store.push_back(std::move(cs));
            r.cs = cs_store.back();
            r.cord_type = 0;
            r.cord_row = r.ctg_index;
            aln::build_runs(r, arena);
        }
        aln::ContigResult res = aln::solve_contig(recs, cfg);
        auto dump = [&](const char *name, const std::vector<aln::OutRow> &rows) {
            std::cout << "ctg" << contig_no << ' ' << name << '\n';
            for (const auto &r : rows)
                std::cout << r.ctg_index << ' ' << r.qs << ' ' << r.qe << ' '
                          << r.rs << ' ' << r.re << ' ' << (r.alt_flag ? 1 : 0)
                          << '\n';
        };
        dump("MAIN", res.out);
        dump("ALT", res.alt);
        for (size_t i = 0; i < res.max_out.size(); i++)
            dump(("MAX" + std::to_string(i)).c_str(), res.max_out[i]);
        ++contig_no;
    }
    return 0;
}
