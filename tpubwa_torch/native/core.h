// Host-engine internals: seed chaining + chain filtering structures used
// by the chaining entry point (chain.cpp) and the extension orchestrator
// (extension.cpp).
//
// Semantics of bwa-mem's mem_chain / mem_chain_flt (reference call stack
// SURVEY.md §3.1 worker_aln -> mem_chain_seeds, [src] bwamem.cpp:808),
// pinned to the Python reference tpubwa/align/chain.py by
// tests/test_chain_native.py.
#pragma once

#include <cstdint>
#include <vector>
#include <algorithm>

namespace tpubwa {

struct SeedRef {
    int64_t rbeg, qbeg, len;
};

struct Ch {
    int64_t pos;               // anchor: rbeg of the founding seed
    int32_t rid;
    int32_t w = 0;             // weight (set by filter)
    int32_t kept = 0;
    int64_t first = -1;
    std::vector<int64_t> seeds;  // indices into the batch seed_rows
};

struct ChainOpts {
    int32_t w;
    int32_t max_chain_gap;
    int32_t min_chain_weight;
    int64_t max_chain_extend;
    double mask_level;
    double drop_ratio;
    int32_t min_seed_len;
};

inline SeedRef seed_at(const int64_t* rows, int64_t i) {
    return SeedRef{rows[i * 4 + 1], rows[i * 4 + 2], rows[i * 4 + 3]};
}

// np.searchsorted(offsets, pos, side="right") - 1
inline int64_t pos_to_rid(const int64_t* offs, int64_t n_contigs,
                          int64_t l_pac, int64_t pos) {
    if (pos < 0 || pos >= l_pac) return -1;
    const int64_t* ub = std::upper_bound(offs, offs + n_contigs, pos);
    return (ub - offs) - 1;
}

// bns_intv2rid semantics (chain.py intv_to_rid)
inline int64_t intv_to_rid(const int64_t* offs, int64_t n_contigs,
                           int64_t l_pac, int64_t rb, int64_t re) {
    if (rb < l_pac && re > l_pac) return -2;
    int64_t b = rb, e = re - 1;
    if (rb >= l_pac) {
        b = 2 * l_pac - 1 - (re - 1);
        e = 2 * l_pac - 1 - rb;
    }
    int64_t rid_b = pos_to_rid(offs, n_contigs, l_pac, b);
    int64_t rid_e = pos_to_rid(offs, n_contigs, l_pac, e);
    return rid_b == rid_e ? rid_b : -1;
}

// bwa test_and_merge (chain.py _test_and_merge)
inline bool test_and_merge(const ChainOpts& o, int64_t l_pac,
                           const int64_t* rows, Ch& c, const SeedRef& s,
                           int64_t s_idx, int64_t rid) {
    SeedRef last = seed_at(rows, c.seeds.back());
    SeedRef first = seed_at(rows, c.seeds.front());
    int64_t qend = last.qbeg + last.len;
    int64_t rend = last.rbeg + last.len;
    if (rid != c.rid) return false;
    if (s.qbeg >= first.qbeg && s.qbeg + s.len <= qend &&
        s.rbeg >= first.rbeg && s.rbeg + s.len <= rend)
        return true;  // contained seed; do nothing
    if ((last.rbeg < l_pac || first.rbeg < l_pac) && s.rbeg >= l_pac)
        return false;  // don't chain across strands
    int64_t x = s.qbeg - last.qbeg;  // non-negative (seeds sorted by qbeg)
    int64_t y = s.rbeg - last.rbeg;
    if (y >= 0 && x - y <= o.w && y - x <= o.w &&
        x - last.len < o.max_chain_gap && y - last.len < o.max_chain_gap) {
        c.seeds.push_back(s_idx);
        return true;
    }
    return false;
}

// min(query coverage, reference coverage) — chain.py chain_weight
inline int32_t chain_weight(const int64_t* rows, const Ch& c) {
    int64_t w_q = 0, end = 0;
    for (int64_t i : c.seeds) {
        SeedRef s = seed_at(rows, i);
        if (s.qbeg >= end) w_q += s.len;
        else if (s.qbeg + s.len > end) w_q += s.qbeg + s.len - end;
        end = std::max(end, s.qbeg + s.len);
    }
    std::vector<int64_t> by_r(c.seeds);
    std::stable_sort(by_r.begin(), by_r.end(), [&](int64_t a, int64_t b) {
        return seed_at(rows, a).rbeg < seed_at(rows, b).rbeg;
    });
    int64_t w_r = 0;
    end = 0;
    for (int64_t i : by_r) {
        SeedRef s = seed_at(rows, i);
        if (s.rbeg >= end) w_r += s.len;
        else if (s.rbeg + s.len > end) w_r += s.rbeg + s.len - end;
        end = std::max(end, s.rbeg + s.len);
    }
    int64_t w = std::min(w_q, w_r);
    return (int32_t)std::min(w, (int64_t)((1u << 30) - 1));
}

inline int64_t ch_qbeg(const int64_t* rows, const Ch& c) {
    return seed_at(rows, c.seeds.front()).qbeg;
}
inline int64_t ch_qend(const int64_t* rows, const Ch& c) {
    SeedRef s = seed_at(rows, c.seeds.back());
    return s.qbeg + s.len;
}

// mem_chain_flt (chain.py filter_chains); chains enter in anchor-pos order
// and leave filtered, in weight-descending order.
inline void filter_chains(const ChainOpts& o, const int64_t* rows,
                          std::vector<Ch>& chains, std::vector<Ch>& out) {
    if (chains.empty()) return;
    for (Ch& c : chains) {
        c.first = -1;
        c.kept = 0;
        c.w = chain_weight(rows, c);
    }
    std::vector<Ch> kept_v;
    kept_v.reserve(chains.size());
    for (Ch& c : chains)
        if (c.w >= o.min_chain_weight) kept_v.push_back(std::move(c));
    if (kept_v.empty()) return;
    // stable sort by weight desc (ties keep pos order)
    std::stable_sort(kept_v.begin(), kept_v.end(),
                     [](const Ch& a, const Ch& b) { return a.w > b.w; });
    kept_v[0].kept = 3;
    std::vector<int64_t> kept_idx{0};
    for (size_t i = 1; i < kept_v.size(); i++) {
        Ch& c = kept_v[i];
        bool large_ovlp = false, drop = false;
        for (int64_t j : kept_idx) {
            Ch& cj = kept_v[j];
            int64_t b_max = std::max(ch_qbeg(rows, cj), ch_qbeg(rows, c));
            int64_t e_min = std::min(ch_qend(rows, cj), ch_qend(rows, c));
            if (e_min > b_max) {  // overlap on the query
                int64_t li = ch_qend(rows, c) - ch_qbeg(rows, c);
                int64_t lj = ch_qend(rows, cj) - ch_qbeg(rows, cj);
                int64_t min_l = std::min(li, lj);
                if ((double)(e_min - b_max) >= (double)min_l * o.mask_level
                    && min_l < o.max_chain_gap) {
                    large_ovlp = true;
                    if (cj.first < 0) cj.first = (int64_t)i;
                    if ((double)c.w < (double)cj.w * o.drop_ratio
                        && cj.w - c.w >= o.min_seed_len * 2) {
                        drop = true;
                        break;
                    }
                }
            }
        }
        if (!drop) {
            kept_idx.push_back((int64_t)i);
            c.kept = large_ovlp ? 2 : 3;
        }
    }
    for (int64_t j : kept_idx) {
        int64_t f = kept_v[j].first;
        if (f >= 0) kept_v[f].kept = 1;
    }
    // cap the number of kept==1/2 chains at max_chain_extend
    int64_t k = 0, stop_i = (int64_t)kept_v.size();
    for (size_t i = 0; i < kept_v.size(); i++) {
        Ch& c = kept_v[i];
        if (c.kept == 0 || c.kept == 3) continue;
        k++;
        if (k >= o.max_chain_extend) {
            stop_i = (int64_t)i;
            break;
        }
    }
    for (size_t i = (size_t)(stop_i + 1); i < kept_v.size(); i++)
        if (kept_v[i].kept < 3) kept_v[i].kept = 0;
    for (Ch& c : kept_v)
        if (c.kept > 0) out.push_back(std::move(c));
}

// Chain + filter one read's seeds (rows [read_bounds0, read_bounds1)),
// appending kept chains to `out`.
inline void chain_one_read(const ChainOpts& o, const int64_t* seed_rows,
                           int64_t b0, int64_t b1,
                           const int64_t* contig_offsets, int64_t n_contigs,
                           int64_t l_pac, std::vector<Ch>& scratch,
                           std::vector<Ch>& out) {
    scratch.clear();
    for (int64_t i = b0; i < b1; i++) {
        SeedRef s = seed_at(seed_rows, i);
        int64_t rid = intv_to_rid(contig_offsets, n_contigs, l_pac,
                                  s.rbeg, s.rbeg + s.len);
        if (rid < 0) continue;
        bool merged = false;
        if (!scratch.empty()) {
            // chain with the largest anchor <= s.rbeg
            auto it = std::upper_bound(
                scratch.begin(), scratch.end(), s.rbeg,
                [](int64_t v, const Ch& c) { return v < c.pos; });
            if (it != scratch.begin())
                merged = test_and_merge(o, l_pac, seed_rows, *(it - 1),
                                        s, i, rid);
        }
        if (!merged) {
            auto it = std::upper_bound(
                scratch.begin(), scratch.end(), s.rbeg,
                [](int64_t v, const Ch& c) { return v < c.pos; });
            Ch nc;
            nc.pos = s.rbeg;
            nc.rid = (int32_t)rid;
            nc.seeds.push_back(i);
            scratch.insert(it, std::move(nc));
        }
    }
    filter_chains(o, seed_rows, scratch, out);
}

}  // namespace tpubwa
