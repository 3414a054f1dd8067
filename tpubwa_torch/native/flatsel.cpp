// The flat tier's selection for a whole read batch in one call, single
// end (se_select_flat) and paired end (pe_select_flat): sort_dedup's
// exact-duplicate drop (SE), mark_primary, mem_pair (PE), the XA group
// and the test that keeps a read or a pair on the flat tier of
// align/flatsam.py::se_text_batch / align/pair.py::pe_sam_text.
//
// Exact re-implementation of align/finalize.py::mark_primary (bwa-mem's
// mem_mark_primary_se), align/pair.py::mem_pair (mem_pair) and gen_xa_g's
// ratio filter and count cap.  The Python functions remain the reference
// and the generator tier's code; tests/test_torch_pe_select.py and
// tests/test_torch_se_select.py pin this code to them with exact-equality
// tests.
//
// Regions arrive as CSR columns: SE over B reads, PE over 2B ends, pair
// i's ends at 2i and 2i + 1, each read's or end's regions in the order
// of its list.  Nothing here computes a float beyond what Python
// computes: the insert-size term of mem_pair is tabulated by the caller
// over [low, high] of each direction with Python's own math.erfc /
// math.log, and the pair score is (double)(s_i + s_k) + term + 0.499,
// truncated, Python's order.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

// finalize.hash_64 (Wang's 64-bit mix) on uint64
inline uint64_t hash_64(uint64_t key) {
    key += ~(key << 32);
    key ^= key >> 22;
    key += ~(key << 13);
    key ^= key >> 8;
    key += key << 3;
    key ^= key >> 15;
    key += ~(key << 27);
    key ^= key >> 31;
    return key;
}

// Python's (a << 32) | b on ints that fit in 64 bits
inline int64_t hi_lo(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a << 32) | b;
}

struct Sel {
    int64_t n_contigs, l_pac;
    const int64_t* contig_off;
    double mask_level;
    int64_t tmp;                      // max(a + b, o_del + e_del, ...)
    int64_t T, pen_unpaired;
    double xa_drop_ratio;
    int64_t max_xa_hits;
    int64_t sam_q, sam_t;
    const uint8_t* pe_failed;         // [4]
    const int64_t* pe_low;            // [4]
    const int64_t* pe_high;           // [4]
    const int64_t* tab_off;           // [4] into tab
    const double* tab;                // term of dist = low + t at tab_off + t
};

// mark_primary of one end's regions [r0, r0 + n): writes the sorted order
// (CSR rows) and, by sorted position, secondary, sub and sub_n.
void mark_end(const Sel& o, const int64_t* qb, const int64_t* qe,
              const int64_t* score, const int64_t* sub_n_in, int64_t r0,
              int64_t n, uint64_t read_id, std::vector<uint64_t>& hash,
              std::vector<int64_t>& perm, std::vector<int64_t>& z,
              int64_t* order, int32_t* sec, int64_t* sub, int64_t* sub_n) {
    hash.resize(n);
    perm.resize(n);
    for (int64_t i = 0; i < n; i++) {
        hash[i] = hash_64(read_id + (uint64_t)i);
        perm[i] = i;
    }
    std::stable_sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
        int64_t sa = score[r0 + a], sb = score[r0 + b];
        if (sa != sb) return sa > sb;
        return hash[a] < hash[b];
    });
    for (int64_t p = 0; p < n; p++) {
        int64_t r = r0 + perm[p];
        order[r0 + p] = r;
        sec[r0 + p] = -1;
        sub[r0 + p] = 0;
        sub_n[r0 + p] = sub_n_in[r];
    }
    z.assign(1, 0);
    for (int64_t i = 1; i < n; i++) {
        int64_t ri = order[r0 + i];
        int64_t found = -1;
        for (int64_t k : z) {
            int64_t rk = order[r0 + k];
            int64_t b_max = std::max(qb[rk], qb[ri]);
            int64_t e_min = std::min(qe[rk], qe[ri]);
            if (e_min > b_max) {
                int64_t min_l = std::min(qe[ri] - qb[ri], qe[rk] - qb[rk]);
                if ((double)(e_min - b_max) >= (double)min_l * o.mask_level) {
                    if (sub[r0 + k] == 0) sub[r0 + k] = score[ri];
                    if (score[rk] - score[ri] <= o.tmp) sub_n[r0 + k] += 1;
                    found = k;
                    break;
                }
            }
        }
        if (found < 0) z.push_back(i);
        else sec[r0 + i] = (int32_t)found;
    }
}

struct PairOut {
    int64_t o, subo, n_sub, z[2];
};

// mem_pair over two marked ends (sorted CSR rows at order + e0 / + e1).
// Returns 0, or -1 where a term is not finite (Python raises there), -2
// where a contig index is out of range (Python's IndexError).
int mem_pair(const Sel& o, const int64_t* rb, const int64_t* rid,
             const int64_t* score, const int64_t* order, const int64_t* beg,
             const int64_t* cnt, uint64_t pair_id,
             std::vector<std::pair<int64_t, int64_t>>& v,
             std::vector<std::pair<int64_t, int64_t>>& u, PairOut& out) {
    const int64_t l_pac = o.l_pac;
    v.clear();
    for (int r = 0; r < 2; r++) {
        for (int64_t i = 0; i < cnt[r]; i++) {
            int64_t j = order[beg[r] + i];
            int64_t fwd = rb[j] < l_pac ? rb[j] : (l_pac << 1) - 1 - rb[j];
            int64_t c = rid[j] < 0 ? rid[j] + o.n_contigs : rid[j];
            if (c < 0 || c >= o.n_contigs) return -2;
            int64_t x = hi_lo(rid[j], fwd - o.contig_off[c]);
            int64_t y = hi_lo(score[j], (i << 2) | ((int64_t)(rb[j] >= l_pac) << 1)
                                            | r);
            v.emplace_back(x, y);
        }
    }
    std::sort(v.begin(), v.end());
    int64_t y_last[4] = {-1, -1, -1, -1};
    u.clear();
    const int64_t nv = (int64_t)v.size();
    for (int64_t i = 0; i < nv; i++) {
        const int64_t yi = v[i].second;
        for (int r = 0; r < 2; r++) {
            int d = (r << 1) | (int)((yi >> 1) & 1);
            if (o.pe_failed[d]) continue;
            int which = (r << 1) | (int)((yi & 1) ^ 1);
            if (y_last[which] < 0) continue;
            for (int64_t k = y_last[which]; k >= 0; k--) {
                if ((v[k].second & 3) != which) continue;
                int64_t dist = v[i].first - v[k].first;
                if (dist > o.pe_high[d]) break;
                if (dist < o.pe_low[d]) continue;
                double term = o.tab[o.tab_off[d] + (dist - o.pe_low[d])];
                double qf = (double)((yi >> 32) + (v[k].second >> 32)) + term
                            + 0.499;
                if (!std::isfinite(qf)) return -1;
                int64_t q = std::max((int64_t)qf, (int64_t)0);
                int64_t pair_y = hi_lo(k, i);
                uint64_t h = hash_64((uint64_t)pair_y ^ (pair_id << 8))
                             & 0xFFFFFFFFull;
                u.emplace_back(hi_lo(q, (int64_t)h), pair_y);
            }
        }
        y_last[yi & 3] = i;
    }
    out.z[0] = out.z[1] = 0;
    if (u.empty()) {
        out.o = out.subo = out.n_sub = 0;
        return 0;
    }
    // u sorted ascending: u[-1] is the largest tuple, u[-2] the next
    size_t best = 0;
    for (size_t t = 1; t < u.size(); t++)
        if (u[t] > u[best]) best = t;
    const int64_t best_o = u[best].first >> 32;
    int64_t sub = 0, n_sub = 0;
    bool any = false;
    for (size_t t = 0; t < u.size(); t++) {
        if (t == best) continue;
        int64_t qt = u[t].first >> 32;
        if (!any || qt > sub) sub = qt;
        any = true;
        if (qt >= best_o - o.tmp) n_sub++;
    }
    const int64_t by = u[best].second;
    const int64_t ends[2] = {by >> 32, by & 0xFFFFFFFF};
    for (int64_t t : ends) {
        int64_t yt = v[t].second;
        out.z[yt & 1] = (yt >> 2) & 0x3FFFFFFF;
    }
    out.o = best_o;
    out.subo = sub;
    out.n_sub = n_sub;
    return 0;
}

inline bool flat_geom(const Sel& o, int64_t rb, int64_t re, int64_t qb,
                      int64_t qe) {
    int64_t lq = qe - qb, rl = re - rb;
    return 0 < lq && lq <= o.sam_q && 0 < rl && rl <= o.sam_t
           && !(rb < o.l_pac && o.l_pac < re);
}

// XA group k of one marked read or end (sorted positions [beg, beg + n),
// CSR rows order[beg + p]), gen_xa_g's ratio filter, then its count cap:
// the regions shadowed by k that score at least XA_drop_ratio of k's,
// appended in sorted order at alt_rows + n_alt, or none when more than
// max_XA_hits pass.  Returns the new count; `fits` is false when an
// appended lane is outside the flat windows.
int64_t xa_group(const Sel& o, const int64_t* rb, const int64_t* re,
                 const int64_t* qb, const int64_t* qe, const int64_t* score,
                 const int64_t* order, const int32_t* sec, int64_t beg,
                 int64_t n, int64_t k, int64_t* alt_rows, int64_t n_alt,
                 bool& fits) {
    const double thr = (double)score[order[beg + k]] * o.xa_drop_ratio;
    const int64_t a_lo = n_alt;
    for (int64_t j = 0; j < n; j++) {
        const int64_t pj = beg + j;
        if (sec[pj] == k && (double)score[order[pj]] >= thr)
            alt_rows[n_alt++] = order[pj];
    }
    if (n_alt - a_lo > o.max_xa_hits) n_alt = a_lo;
    fits = true;
    for (int64_t t = a_lo; t < n_alt && fits; t++) {
        const int64_t r = alt_rows[t];
        fits = flat_geom(o, rb[r], re[r], qb[r], qe[r]);
    }
    return n_alt;
}

// sort_dedup's redundancy / patch loop would run on a read's regions
// [r0, r0 + n): two neighbours in re order (stable) on one contig, the
// later starting before the earlier's re + max_chain_gap.
bool patch_would_run(const int64_t* rb, const int64_t* re,
                     const int64_t* rid, int64_t r0, int64_t n,
                     int64_t max_chain_gap, std::vector<int64_t>& perm) {
    perm.resize(n);
    for (int64_t i = 0; i < n; i++) perm[i] = r0 + i;
    std::stable_sort(perm.begin(), perm.end(),
                     [&](int64_t a, int64_t b) { return re[a] < re[b]; });
    for (int64_t i = 1; i < n; i++) {
        const int64_t a = perm[i - 1], b = perm[i];
        if (rid[a] == rid[b] && rb[b] < re[a] + max_chain_gap) return true;
    }
    return false;
}

enum : uint8_t { SE_UNMAPPED = 0, SE_FLAT = 1, SE_GENERATOR = 2 };

}  // namespace

extern "C" {

// Select the flat tier's pairs of a PE batch.
//
//   bounds      [2B + 1] int64: end e's regions are rows
//               [bounds[e], bounds[e + 1]), ends 2i / 2i + 1 of pair i
//   rb, re, qb, qe, rid, score, sub_n   [n_regs] int64 region columns,
//               sub_n as the region carries it (mark_primary adds to it)
//   contig_off  [n_contigs] int64
//   pe_*        the four directions' insert-size models; tab the
//               tabulated term (see the header)
//   pair_id0    pair i's id is pair_id0 + i; end e's read id 2 id + e
// Outputs, by sorted position (rows of each end's segment):
//   order  [n_regs] the CSR row at that position; sec, sub, sub_n the
//          region's mark_primary fields there (secondary_all == sec)
// Outputs by pair (B) and by end (2B):
//   flat [B] 1 where the pair stays flat; o, subo, n_sub [B] mem_pair's
//   (0 where it did not run); proper [B]; z [2B] mem_pair's chosen
//   sorted positions; pick [2B] the emitted region's CSR row (-1 unless
//   flat); sub_eff, subn_eff [2B] its XS sub and sub_n; alt_cnt [2B]
//   its XA alternates, whose CSR rows fill alt_rows in pair, end and
//   sorted order (n_regs rows are always enough).
// Returns the number of alternate rows, or a negative error (-1 a pair
// term not finite, -2 a contig index out of range).
int64_t pe_select_flat(
    int64_t B, const int64_t* bounds,
    const int64_t* rb, const int64_t* re, const int64_t* qb,
    const int64_t* qe, const int64_t* rid, const int64_t* score,
    const int64_t* sub_n_in,
    const int64_t* contig_off, int64_t n_contigs, int64_t l_pac,
    double mask_level, int64_t tmp, int64_t T, int64_t pen_unpaired,
    double xa_drop_ratio, int64_t max_xa_hits, int64_t sam_q,
    int64_t sam_t,
    const uint8_t* pe_failed, const int64_t* pe_low, const int64_t* pe_high,
    const int64_t* tab_off, const double* tab, int64_t pair_id0,
    int64_t* order, int32_t* sec, int64_t* sub, int64_t* sub_n,
    uint8_t* flat, int64_t* o_out, int64_t* subo_out, int64_t* nsub_out,
    uint8_t* proper_out, int64_t* z_out, int64_t* pick, int64_t* sub_eff,
    int64_t* subn_eff, int64_t* alt_cnt, int64_t* alt_rows) {
    Sel o{n_contigs, l_pac, contig_off, mask_level, tmp, T, pen_unpaired,
          xa_drop_ratio, max_xa_hits, sam_q, sam_t, pe_failed, pe_low,
          pe_high, tab_off, tab};
    std::vector<uint64_t> hash;
    std::vector<int64_t> perm, zl;
    std::vector<std::pair<int64_t, int64_t>> v, u;
    int64_t n_alt = 0;
    for (int64_t i = 0; i < B; i++) {
        const uint64_t pid = (uint64_t)pair_id0 + (uint64_t)i;
        int64_t beg[2], cnt[2];
        for (int e = 0; e < 2; e++) {
            beg[e] = bounds[2 * i + e];
            cnt[e] = bounds[2 * i + e + 1] - beg[e];
            if (cnt[e] > 0)
                mark_end(o, qb, qe, score, sub_n_in, beg[e], cnt[e],
                         (pid << 1) | (uint64_t)e, hash, perm, zl, order,
                         sec, sub, sub_n);
            z_out[2 * i + e] = 0;
            pick[2 * i + e] = -1;
            sub_eff[2 * i + e] = subn_eff[2 * i + e] = 0;
            alt_cnt[2 * i + e] = 0;
        }
        flat[i] = 0;
        proper_out[i] = 0;
        o_out[i] = subo_out[i] = nsub_out[i] = 0;
        if (cnt[0] == 0 || cnt[1] == 0) continue;
        bool multi = false;                 // a second primary
        for (int e = 0; e < 2 && !multi; e++)
            for (int64_t p = beg[e] + 1; p < beg[e] + cnt[e]; p++)
                if (sec[p] < 0) { multi = true; break; }
        if (multi) continue;
        const int64_t p0 = order[beg[0]], p1 = order[beg[1]];
        if (score[p0] < T || score[p1] < T) continue;
        PairOut po;
        int rc = mem_pair(o, rb, rid, score, order, beg, cnt, pid, v, u, po);
        if (rc < 0) return rc;
        o_out[i] = po.o;
        subo_out[i] = po.subo;
        nsub_out[i] = po.n_sub;
        z_out[2 * i] = po.z[0];
        z_out[2 * i + 1] = po.z[1];
        const int64_t score_un = score[p0] + score[p1] - pen_unpaired;
        const bool proper = po.o > 0 && po.o > score_un;
        proper_out[i] = proper;
        bool bad = false;
        const int64_t alt0 = n_alt;
        for (int e = 0; e < 2 && !bad; e++) {
            const int64_t k = proper ? po.z[e] : 0;
            const int64_t c = order[beg[e] + k];
            if (!flat_geom(o, rb[c], re[c], qb[c], qe[c])) { bad = true; break; }
            const int64_t a_lo = n_alt;
            bool fits;
            n_alt = xa_group(o, rb, re, qb, qe, score, order, sec, beg[e],
                             cnt[e], k, alt_rows, n_alt, fits);
            bad = !fits;
            const int64_t sc = sec[beg[e] + k];
            pick[2 * i + e] = c;
            sub_eff[2 * i + e] =
                sc >= 0 ? score[order[beg[e] + sc]] : sub[beg[e] + k];
            subn_eff[2 * i + e] = sub_n[beg[e] + k];
            alt_cnt[2 * i + e] = n_alt - a_lo;
        }
        if (bad) {
            n_alt = alt0;
            for (int e = 0; e < 2; e++) {
                pick[2 * i + e] = -1;
                sub_eff[2 * i + e] = subn_eff[2 * i + e] = 0;
                alt_cnt[2 * i + e] = 0;
            }
            continue;
        }
        flat[i] = 1;
    }
    return n_alt;
}

// Select the flat tier's reads of an SE batch.
//
//   bounds      [B + 1] int64: read b's regions are rows
//               [bounds[b], bounds[b + 1])
//   rb, re, qb, qe, rid, score   [n_regs] int64 region columns
//   read_id0    read b's id is read_id0 + b
// Outputs by read (B):
//   tier     SE_UNMAPPED, SE_FLAT or SE_GENERATOR:
//            0 regions: unmapped;
//            1 region: unmapped under T, else flat where it fits the
//            flat windows, else generator;
//            2 or more: generator where sort_dedup's patch loop would
//            run; else sorted by (-score, rb, qb), exact duplicates
//            dropped, marked (mark_primary, sub_n from 0): generator on
//            a second primary or a primary or XA lane outside the
//            windows, else unmapped under T, else flat
//   prim     the primary's CSR row where flat (-1 elsewhere)
//   sub, sub_n   its mark_primary sub and sub_n where flat (0 elsewhere)
//   alt_cnt  its XA alternates where flat, whose CSR rows fill alt_rows
//            in read and sorted order (n_regs rows are always enough)
// Returns the number of alternate rows.
int64_t se_select_flat(
    int64_t B, const int64_t* bounds,
    const int64_t* rb, const int64_t* re, const int64_t* qb,
    const int64_t* qe, const int64_t* rid, const int64_t* score,
    int64_t l_pac, double mask_level, int64_t tmp, int64_t T,
    double xa_drop_ratio, int64_t max_xa_hits, int64_t max_chain_gap,
    int64_t sam_q, int64_t sam_t, int64_t read_id0,
    uint8_t* tier, int64_t* prim, int64_t* sub_out, int64_t* subn_out,
    int64_t* alt_cnt, int64_t* alt_rows) {
    Sel o{0, l_pac, nullptr, mask_level, tmp, T, 0, xa_drop_ratio,
          max_xa_hits, sam_q, sam_t, nullptr, nullptr, nullptr, nullptr,
          nullptr};
    std::vector<uint64_t> hash;
    std::vector<int64_t> perm, zl, keep, cqb, cqe, csc, zero, corder, sub,
        subn, rows;
    std::vector<int32_t> sec;
    int64_t n_alt = 0;
    for (int64_t b = 0; b < B; b++) {
        const int64_t r0 = bounds[b], n = bounds[b + 1] - r0;
        tier[b] = SE_GENERATOR;
        prim[b] = -1;
        sub_out[b] = subn_out[b] = alt_cnt[b] = 0;
        if (n == 0) {
            tier[b] = SE_UNMAPPED;
            continue;
        }
        if (n == 1) {
            if (score[r0] < T) {
                tier[b] = SE_UNMAPPED;
            } else if (flat_geom(o, rb[r0], re[r0], qb[r0], qe[r0])) {
                tier[b] = SE_FLAT;
                prim[b] = r0;
            }
            continue;
        }
        if (patch_would_run(rb, re, rid, r0, n, max_chain_gap, perm))
            continue;
        // sort_dedup's final order and its exact-duplicate drop
        for (int64_t i = 0; i < n; i++) perm[i] = r0 + i;
        std::stable_sort(perm.begin(), perm.end(), [&](int64_t a, int64_t c) {
            if (score[a] != score[c]) return score[a] > score[c];
            if (rb[a] != rb[c]) return rb[a] < rb[c];
            return qb[a] < qb[c];
        });
        keep.clear();
        for (int64_t p = 0; p < n; p++) {
            const int64_t r = perm[p], q = p ? perm[p - 1] : -1;
            if (p == 0 || score[r] != score[q] || rb[r] != rb[q]
                || qb[r] != qb[q])
                keep.push_back(r);
        }
        const int64_t m = (int64_t)keep.size();
        cqb.resize(m);
        cqe.resize(m);
        csc.resize(m);
        for (int64_t i = 0; i < m; i++) {
            cqb[i] = qb[keep[i]];
            cqe[i] = qe[keep[i]];
            csc[i] = score[keep[i]];
        }
        zero.assign(m, 0);
        corder.resize(m);
        sec.resize(m);
        sub.resize(m);
        subn.resize(m);
        mark_end(o, cqb.data(), cqe.data(), csc.data(), zero.data(), 0, m,
                 (uint64_t)read_id0 + (uint64_t)b, hash, perm, zl,
                 corder.data(), sec.data(), sub.data(), subn.data());
        bool multi = false;                 // a second primary
        for (int64_t p = 1; p < m && !multi; p++) multi = sec[p] < 0;
        if (multi) continue;
        rows.resize(m);
        for (int64_t p = 0; p < m; p++) rows[p] = keep[corder[p]];
        const int64_t c = rows[0];
        if (!flat_geom(o, rb[c], re[c], qb[c], qe[c])) continue;
        const int64_t a_lo = n_alt;
        bool fits;
        n_alt = xa_group(o, rb, re, qb, qe, score, rows.data(), sec.data(),
                         0, m, 0, alt_rows, n_alt, fits);
        if (!fits || score[c] < T) {
            // gen_xa's lanes of an unmapped read are not emitted
            n_alt = a_lo;
            if (fits) tier[b] = SE_UNMAPPED;
            continue;
        }
        tier[b] = SE_FLAT;
        prim[b] = c;
        sub_out[b] = sub[0];
        subn_out[b] = subn[0];
        alt_cnt[b] = n_alt - a_lo;
    }
    return n_alt;
}

}  // extern "C"
