// Mate rescue's rounds for a whole PE batch: the first round's jobs and
// upload rows in one call (pe_rescue_round1), the second round's rows
// from the first round's results in another (pe_rescue_round2).
//
// Exact re-implementation of align/pair.py::matesw_gen (bwa-mem's
// mem_matesw) up to its yields, of the anchors align_pe_batch gives it,
// and of the rows run_matesw_rounds uploads for them.  The Python
// functions remain the reference; tests/test_torch_rescue.py pins this
// code to them with exact-equality tests.
//
// Regions arrive as CSR columns over 2B ends, pair i's ends at 2i and
// 2i + 1, each end's regions in the order of its list, as the lists
// stand before any rescue of the batch: every generator takes its first
// step, and so its skip test, before any result comes back.  A row of
// an upload buffer is query [q_pad] | target [t_b] | qlen tlen minsc
// endsc, int32, codes padded with 4.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Job {
    int64_t anchor, rb, re, lms, mate, end;   // mate: codes row; end 0/1
    bool rev;
};

// pair.infer_dir: (dist, dir) with dir 0=FF 1=FR 2=RF 3=RR
inline int64_t infer_dir(int64_t l_pac, int64_t b1, int64_t b2,
                         int64_t* dist) {
    const bool r1 = b1 >= l_pac, r2 = b2 >= l_pac;
    const int64_t p2 = r1 == r2 ? b2 : (l_pac << 1) - 1 - b2;
    *dist = p2 > b1 ? p2 - b1 : b1 - p2;
    return (r1 == r2 ? 0 : 1) ^ (p2 > b1 ? 0 : 3);
}

// FMIndex.fetch_ref's code at p of [0, 2 l_pac)
inline int32_t ref_code(const uint32_t* pac, int64_t l_pac, int64_t p) {
    const bool rev = p >= l_pac;
    const int64_t f = rev ? (l_pac << 1) - 1 - p : p;
    const int32_t c = (int32_t)((pac[f >> 4] >> ((f & 15) * 2)) & 3);
    return rev ? 3 - c : c;
}

}  // namespace

extern "C" {

// The first rescue round of a PE batch.
//
//   bounds      [2B + 1] int64: end e's regions are rows
//               [bounds[e], bounds[e + 1])
//   rb, rid, score   [n_regs] int64 region columns
//   pe_*        the four directions' insert-size models
//   contig_off, contig_len   [n_contigs] int64
//   pac         the forward reference, 16 2-bit codes a uint32 word
//   codes0/1    [rows, width] uint8, the two ends' reads; lens0/1 [rows]
//   minsc       min_seed_len * a
//   cap         rows the outputs hold (anchors are enough)
// Anchors: per pair, end 0's regions, then end 1's, those scoring at
// least the list's first score - pen_unpaired, at most max_matesw of
// them, in list order.  An anchor whose window reaches an SW is a job.
// Outputs:
//   buf         jobs' rows at stride q_pad + t_b + 4, the rows
//               run_matesw_rounds builds (cap rows at stride
//               q_pad + max(t_pad, 256) + 4 fit)
//   job_anchor  [cap] the anchor's CSR row; job_rb [cap] the window's
//               start; job_rev [cap] the mate reverse-complemented;
//               job_lms [cap] the mate's length
//   out         [3]: t_b, the number of anchors, the jobs whose query
//               or target was cut to its pad
// Returns the number of jobs, or -1 when cap rows are too few.
int64_t pe_rescue_round1(
    int64_t B, const int64_t* bounds, const int64_t* rb, const int64_t* rid,
    const int64_t* score,
    const uint8_t* pe_failed, const int64_t* pe_low, const int64_t* pe_high,
    const int64_t* contig_off, const int64_t* contig_len, int64_t n_contigs,
    int64_t l_pac, const uint32_t* pac,
    const uint8_t* codes0, const int64_t* lens0, const uint8_t* codes1,
    const int64_t* lens1, int64_t width,
    int64_t pen_unpaired, int64_t max_matesw, int64_t min_seed_len,
    int64_t minsc, int64_t q_pad, int64_t t_pad, int64_t cap,
    int32_t* buf, int64_t* job_anchor, int64_t* job_rb, uint8_t* job_rev,
    int64_t* job_lms, int64_t* out) {
    const int64_t l2 = l_pac << 1;
    std::vector<Job> jobs;
    int64_t n_anchors = 0;
    for (int64_t i = 0; i < B; i++) {
        for (int64_t e = 0; e < 2; e++) {
            const int64_t a0 = bounds[2 * i + e], a1 = bounds[2 * i + e + 1];
            const int64_t m0 = bounds[2 * i + 1 - e];
            const int64_t m1 = bounds[2 * i + 2 - e];
            if (a0 == a1) continue;
            const int64_t thr = score[a0] - pen_unpaired;
            const int64_t lms = e == 0 ? lens1[i] : lens0[i];
            int64_t taken = 0;
            for (int64_t a = a0; a < a1 && taken < max_matesw; a++) {
                if (score[a] < thr) continue;
                taken++;
                n_anchors++;
                bool skip[4];
                for (int r = 0; r < 4; r++) skip[r] = pe_failed[r] != 0;
                for (int64_t m = m0; m < m1; m++) {
                    int64_t dist;
                    const int64_t r = infer_dir(l_pac, rb[a], rb[m], &dist);
                    if (pe_low[r] <= dist && dist <= pe_high[r])
                        skip[r] = true;
                }
                for (int r = 0; r < 4; r++) {
                    if (skip[r]) continue;
                    const bool is_rev = (r >> 1) != (r & 1);
                    const bool is_larger = !(r >> 1);
                    int64_t wb, we;
                    if (!is_rev) {
                        wb = is_larger ? rb[a] + pe_low[r]
                                       : rb[a] - pe_high[r];
                        we = (is_larger ? rb[a] + pe_high[r]
                                        : rb[a] - pe_low[r]) + lms;
                    } else {
                        wb = (is_larger ? rb[a] + pe_low[r]
                                        : rb[a] - pe_high[r]) - lms;
                        we = is_larger ? rb[a] + pe_high[r]
                                       : rb[a] - pe_low[r];
                    }
                    wb = std::max<int64_t>(wb, 0);
                    we = std::min(we, l2);
                    if (wb >= we) continue;
                    // trim [wb, we) to the contig (and strand half)
                    // holding its midpoint
                    const int64_t mid = (wb + we) >> 1;
                    const bool m_rev = mid >= l_pac;
                    const int64_t fwd_mid = m_rev ? l2 - 1 - mid : mid;
                    const int64_t c =
                        std::upper_bound(contig_off, contig_off + n_contigs,
                                         fwd_mid) - contig_off - 1;
                    int64_t far_beg = contig_off[c];
                    int64_t far_end = far_beg + contig_len[c];
                    if (m_rev) {
                        const int64_t fb = far_beg;
                        far_beg = l2 - far_end;
                        far_end = l2 - fb;
                    }
                    wb = std::max(wb, far_beg);
                    we = std::min(we, far_end);
                    // the first direction that runs an SW ends the anchor;
                    // the others fall through
                    if (rid[a] == c && we - wb >= min_seed_len) {
                        jobs.push_back({a, wb, we, lms, i, 1 - e, is_rev});
                        break;
                    }
                }
            }
        }
    }
    const int64_t J = (int64_t)jobs.size();
    out[1] = n_anchors;
    if (J > cap) return -1;
    int64_t t_max = 0;
    for (const Job& j : jobs)
        t_max = std::max(t_max, std::min(j.re - j.rb, t_pad));
    const int64_t t_b = t_max <= 256 ? 256 : t_pad;
    const int64_t stride = q_pad + t_b + 4;
    int64_t n_cut = 0;
    for (int64_t k = 0; k < J; k++) {
        const Job& j = jobs[k];
        int32_t* row = buf + k * stride;
        const uint8_t* ms = (j.end == 0 ? codes0 : codes1) + j.mate * width;
        const int64_t nq = std::min(j.lms, q_pad);
        const int64_t nt = std::min(j.re - j.rb, t_b);
        n_cut += nq < j.lms || nt < j.re - j.rb;
        for (int64_t x = 0; x < nq; x++) {
            if (j.rev) {
                const int32_t cc = ms[j.lms - 1 - x];
                row[x] = cc < 4 ? 3 - cc : 4;
            } else {
                row[x] = ms[x];
            }
        }
        std::fill(row + nq, row + q_pad, 4);
        int32_t* tg = row + q_pad;
        for (int64_t x = 0; x < nt; x++)
            tg[x] = ref_code(pac, l_pac, j.rb + x);
        std::fill(tg + nt, tg + t_b, 4);
        row[q_pad + t_b] = (int32_t)nq;
        row[q_pad + t_b + 1] = (int32_t)nt;
        row[q_pad + t_b + 2] = (int32_t)minsc;
        row[q_pad + t_b + 3] = 1 << 30;
        job_anchor[k] = j.anchor;
        job_rb[k] = j.rb;
        job_rev[k] = j.rev;
        job_lms[k] = j.lms;
    }
    out[0] = t_b;
    out[2] = n_cut;
    return J;
}

// The second rescue round: for each first-round job with score >=
// min_seed_len and qe >= 0, in job order, the reversed prefixes
// query[:qe + 1] and target[:te + 1] of its first-round row, minsc as
// there and endsc = score (matesw_gen's second yield).  Such a prefix
// never passes its pad: qe < qlen <= q_pad and te < tlen <= t_b1.
//
//   buf1   the first round's J rows at stride q_pad + t_b1 + 4
//   res    [4, J] int64: score, te, qe, score2
// Outputs: buf2, the rows at stride q_pad + t_b2 + 4 (J rows at stride
// q_pad + max(t_pad, 256) + 4 fit); hits [J] the jobs taken, in order;
// out [1]: t_b2.  Returns the number of rows.
int64_t pe_rescue_round2(
    int64_t J, const int32_t* buf1, int64_t q_pad, int64_t t_b1,
    const int64_t* res, int64_t min_seed_len, int64_t t_pad,
    int32_t* buf2, int64_t* hits, int64_t* out) {
    const int64_t* sc = res;
    const int64_t* te = res + J;
    const int64_t* qe = res + 2 * J;
    int64_t n = 0, t_max = 0;
    for (int64_t k = 0; k < J; k++) {
        if (sc[k] >= min_seed_len && qe[k] >= 0) {
            hits[n++] = k;
            t_max = std::max(t_max, std::min(te[k] + 1, t_pad));
        }
    }
    const int64_t t_b2 = t_max <= 256 ? 256 : t_pad;
    const int64_t s1 = q_pad + t_b1 + 4, s2 = q_pad + t_b2 + 4;
    for (int64_t h = 0; h < n; h++) {
        const int64_t k = hits[h];
        const int32_t* r1 = buf1 + k * s1;
        int32_t* r2 = buf2 + h * s2;
        const int64_t nq = qe[k] + 1, nt = te[k] + 1;
        for (int64_t x = 0; x < nq; x++) r2[x] = r1[nq - 1 - x];
        std::fill(r2 + nq, r2 + q_pad, 4);
        const int32_t* t1 = r1 + q_pad;
        int32_t* t2 = r2 + q_pad;
        for (int64_t x = 0; x < nt; x++) t2[x] = t1[nt - 1 - x];
        std::fill(t2 + nt, t2 + t_b2, 4);
        r2[q_pad + t_b2] = (int32_t)nq;
        r2[q_pad + t_b2 + 1] = (int32_t)nt;
        r2[q_pad + t_b2 + 2] = r1[q_pad + t_b1 + 2];
        r2[q_pad + t_b2 + 3] = (int32_t)sc[k];
    }
    out[0] = t_b2;
    return n;
}

}  // extern "C"
