// Flat seed-extension orchestrator — native host engine.
//
// Replaces the per-read Python generators of tpubwa/align/region.py
// (extend_read / run_extension_rounds — semantics of bwa-mem's
// mem_chain2aln, reference call stack SURVEY.md §3.1 worker_aln ->
// mem_chain2aln_across_reads_V2) with a two-call flat-array protocol:
//
//   1. ext_prepare: chain + filter every read (core.h), compute each
//      chain's reference window (rmax), and emit ONE extension-job
//      descriptor per chain seed — speculative: the extension DP result of
//      a seed depends only on (seed, query, window), never on other seeds'
//      results, so every seed can be extended in one fused device batch
//      even though bwa decides *per seed, sequentially* whether to keep
//      its region.
//   2. ext_finalize: replay bwa's sequential per-seed walk (score-ordered
//      visit, containment test against regions built so far, overlapping-
//      major-seed confirmation) using the device results, building the
//      final region list.  Dropped seeds simply discard their speculative
//      result, so the output is exactly what the sequential reference
//      (align/region.py extend_read) produces — pinned by
//      tests/test_extend_flat.py differential tests.
//
// Why: the Python round driver spent ~1 ms/read in generator resumes and
// per-lane packing (VERDICT r2 weak #2); this engine reduces the host cost
// to two ctypes calls per batch and lets the device run one wave instead
// of max-seeds-per-read lockstep rounds.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#include "core.h"

namespace {

using namespace tpubwa;

struct ExtOpts {
    int32_t a;           // match score
    int32_t o_del, e_del, o_ins, e_ins;
    int32_t pen_clip5, pen_clip3;
    int32_t w;           // band width
};

// Python: cal_max_gap (align/region.py) — int() truncation == C cast
inline int64_t cal_max_gap(const ExtOpts& o, int64_t qlen) {
    int64_t l_del = (int64_t)((double)(qlen * o.a - o.o_del) / o.e_del + 1.0);
    int64_t l_ins = (int64_t)((double)(qlen * o.a - o.o_ins) / o.e_ins + 1.0);
    int64_t l = std::max(std::max(l_del, l_ins), (int64_t)1);
    return std::min(l, (int64_t)2 * o.w);
}

struct ExtChain {
    int32_t read;
    int32_t rid;
    double frac_rep;
    int64_t rmax0, rmax1;
    std::vector<int64_t> seeds;  // seed_rows indices, chain order
    std::vector<int32_t> srt;    // visit order (iterated back to front)
};

struct ExtState {
    std::vector<ExtChain> chains;     // grouped by read ascending
    std::vector<int64_t> rows;        // copy of seed_rows (n_seeds * 4)
    std::vector<int32_t> lens;        // per-read query length
    int64_t l_pac = 0;
    int64_t n_reads = 0;
    int64_t n_jobs = 0;
    ExtOpts opt{};
};

struct Reg {
    int64_t rb, re;
    int32_t qb, qe, score, truesc, w, seedcov, rid, seedlen0;
    double frac_rep;
};

}  // namespace

extern "C" {

// Stage 1: chain every read, compute chain windows, emit job descriptors.
//
// Inputs: the batch's seeds as (read_id, rbeg, qbeg, len) rows grouped by
// read in SMEM order, read_bounds [n_reads + 1] delimiting each read's
// rows, skip_read (nonzero: no chains for this read), the contigs, the
// chain options, per-read query lengths, per-read repetitive coverage
// (l_rep -> frac_rep), and the extension scoring options.  Outputs (caller-allocated, n_seeds entries suffice):
// one row per chain seed in device-batch order:
//   job_read   [cap] int32   read index
//   job_qbeg   [cap] int32   seed query begin
//   job_slen   [cap] int32   seed length
//   job_rbeg   [cap] int64   seed reference begin (2*l_pac coords)
//   job_rmax0  [cap] int64   chain window begin
//   job_rmax1  [cap] int64   chain window end
//   job_h0     [cap] int32   initial score (seed_len * a)
// out_counts[0] = n_jobs.  Returns an opaque handle for ext_finalize
// (never NULL unless cap exceeded, in which case NULL is returned).
void* ext_prepare(
    const int64_t* seed_rows, int64_t n_seeds,
    const int64_t* read_bounds, int64_t n_reads,
    const uint8_t* skip_read,
    const int64_t* contig_offsets, int64_t n_contigs, int64_t l_pac,
    const int32_t* lens, const int32_t* l_rep,
    // chain options
    int32_t w, int32_t max_chain_gap, int32_t min_chain_weight,
    int64_t max_chain_extend, double mask_level, double drop_ratio,
    int32_t min_seed_len,
    // extension options
    int32_t a, int32_t o_del, int32_t e_del, int32_t o_ins, int32_t e_ins,
    int32_t pen_clip5, int32_t pen_clip3,
    // outputs
    int32_t* job_read, int32_t* job_qbeg, int32_t* job_slen,
    int64_t* job_rbeg, int64_t* job_rmax0, int64_t* job_rmax1,
    int32_t* job_h0, int64_t cap, int64_t* out_counts) {
    ChainOpts co{w, max_chain_gap, min_chain_weight, max_chain_extend,
                 mask_level, drop_ratio, min_seed_len};
    ExtState* st = new ExtState();
    st->opt = ExtOpts{a, o_del, e_del, o_ins, e_ins, pen_clip5, pen_clip3,
                      w};
    st->l_pac = l_pac;
    st->n_reads = n_reads;
    st->rows.assign(seed_rows, seed_rows + n_seeds * 4);
    st->lens.assign(lens, lens + n_reads);

    int64_t n_jobs = 0;
    std::vector<Ch> scratch, kept;
    for (int64_t r = 0; r < n_reads; r++) {
        if (skip_read[r]) continue;
        kept.clear();
        chain_one_read(co, seed_rows, read_bounds[r], read_bounds[r + 1],
                       contig_offsets, n_contigs, l_pac, scratch, kept);
        int64_t l_query = lens[r];
        double frac_rep = l_query ? (double)l_rep[r] / (double)l_query : 0.0;
        for (Ch& c : kept) {
            if (c.seeds.empty()) continue;
            ExtChain ec;
            ec.read = (int32_t)r;
            ec.rid = c.rid;
            ec.frac_rep = frac_rep;
            ec.seeds = std::move(c.seeds);
            // chain reference window (region.py extend_read rmax)
            int64_t rmax0 = l_pac * 2, rmax1 = 0;
            for (int64_t si : ec.seeds) {
                SeedRef t = seed_at(seed_rows, si);
                int64_t b = t.rbeg
                    - (t.qbeg + cal_max_gap(st->opt, t.qbeg));
                int64_t e = t.rbeg + t.len + (l_query - t.qbeg - t.len)
                    + cal_max_gap(st->opt, l_query - t.qbeg - t.len);
                rmax0 = std::min(rmax0, b);
                rmax1 = std::max(rmax1, e);
            }
            rmax0 = std::max(rmax0, (int64_t)0);
            rmax1 = std::min(rmax1, l_pac * 2);
            if (rmax0 < l_pac && l_pac < rmax1) {
                // crossing the strand boundary: pick a side
                if (seed_at(seed_rows, ec.seeds[0]).rbeg < l_pac)
                    rmax1 = l_pac;
                else
                    rmax0 = l_pac;
            }
            ec.rmax0 = rmax0;
            ec.rmax1 = rmax1;
            // visit order: sorted by (seed score = len, index) ascending,
            // walked back-to-front (region.py srt)
            int n = (int)ec.seeds.size();
            ec.srt.resize(n);
            for (int i = 0; i < n; i++) ec.srt[i] = i;
            std::stable_sort(
                ec.srt.begin(), ec.srt.end(), [&](int32_t x, int32_t y) {
                    int64_t lx = seed_at(seed_rows, ec.seeds[x]).len;
                    int64_t ly = seed_at(seed_rows, ec.seeds[y]).len;
                    if (lx != ly) return lx < ly;
                    return x < y;
                });
            // one speculative job per seed, in visit order
            for (int k = n - 1; k >= 0; k--) {
                if (n_jobs >= cap) {
                    delete st;
                    return nullptr;
                }
                SeedRef s = seed_at(seed_rows, ec.seeds[ec.srt[k]]);
                job_read[n_jobs] = (int32_t)r;
                job_qbeg[n_jobs] = (int32_t)s.qbeg;
                job_slen[n_jobs] = (int32_t)s.len;
                job_rbeg[n_jobs] = s.rbeg;
                job_rmax0[n_jobs] = rmax0;
                job_rmax1[n_jobs] = rmax1;
                job_h0[n_jobs] = (int32_t)std::max(s.len * a, (int64_t)1);
                n_jobs++;
            }
            st->chains.push_back(std::move(ec));
        }
    }
    st->n_jobs = n_jobs;
    out_counts[0] = n_jobs;
    return st;
}

// Stage 2: replay the sequential per-seed walk with the device results.
//
//   results  [n_jobs, 14] int32, job order of ext_prepare:
//            left(score,qle,tle,gtle,gscore,max_off),
//            right(score,qle,tle,gtle,gscore,max_off), aw0, aw1
//
// The walk is shared between ext_finalize (build regions; all needed
// result slots present) and ext_missing (detection: with a partial
// result set, find which jobs another device round must run).  Unused
// slots (seeds the walk drops) are never read, which is what makes the
// PHASED protocol exact: ext_phase1 returns the first-visited seed per
// chain (always a superset of bwa's first extensions), ext_missing
// replays with what's available and greedily requests the rest of a
// read's not-yet-run jobs from the first missing needed seed onward
// (over-inclusive — extra DP results are simply ignored — so the loop
// terminates in <= 3 rounds), and ext_finalize runs the exact sequential
// replay.  On repeat genomes this cuts device DP jobs ~2-3x: bwa's
// sequential walk skips most chain seeds as contained in the first
// seed's alignment, and the phased protocol recovers exactly that skip
// without giving up batched device waves.

namespace {

// Replay one read.  have == nullptr: build mode (regs filled, all needed
// results assumed present).  have != nullptr: detection mode — returns
// false at the first needed-but-missing seed after appending every
// !have job id in [that job, job_end) to `missing`.
bool replay_read(const ExtState* st, size_t ci_begin, size_t ci_end,
                 int64_t job_base, int64_t job_end, int64_t l_query,
                 const int32_t* results, const uint8_t* have,
                 std::vector<Reg>& regs, std::vector<int64_t>* missing) {
    const ExtOpts& o = st->opt;
    const int64_t* rows = st->rows.data();
    std::vector<uint8_t> dropped;
    int64_t job_idx = job_base;
    regs.clear();
    for (size_t ci = ci_begin; ci < ci_end; ci++) {
        const ExtChain& c = st->chains[ci];
        int n = (int)c.seeds.size();
        dropped.assign(n, 0);
        for (int k = n - 1; k >= 0; k--, job_idx++) {
            SeedRef s = seed_at(rows, c.seeds[c.srt[k]]);
            // --- containment skip test (vs regions so far) ---
            bool contained = false;
            for (const Reg& p : regs) {
                if (s.rbeg < p.rb || s.rbeg + s.len > p.re
                    || s.qbeg < p.qb || s.qbeg + s.len > p.qe)
                    continue;
                if ((double)(s.len - p.seedlen0) > 0.1 * (double)l_query)
                    continue;
                int64_t qd = s.qbeg - p.qb;
                int64_t rd = s.rbeg - p.rb;
                int64_t ww = std::min(
                    cal_max_gap(o, std::min(qd, rd)), (int64_t)p.w);
                if (qd - rd < ww && rd - qd < ww) {
                    contained = true;
                    break;
                }
                qd = p.qe - (s.qbeg + s.len);
                rd = p.re - (s.rbeg + s.len);
                ww = std::min(
                    cal_max_gap(o, std::min(qd, rd)), (int64_t)p.w);
                if (qd - rd < ww && rd - qd < ww) {
                    contained = true;
                    break;
                }
            }
            if (contained) {
                // confirm no overlapping major seed suggests a
                // different alignment
                bool diff = false;
                for (int i2 = k + 1; i2 < n; i2++) {
                    if (dropped[c.srt[i2]]) continue;
                    SeedRef t = seed_at(rows, c.seeds[c.srt[i2]]);
                    if ((double)t.len < (double)s.len * 0.95) continue;
                    if (s.qbeg <= t.qbeg
                        && s.qbeg + s.len - t.qbeg >= (s.len >> 2)
                        && t.qbeg - s.qbeg != t.rbeg - s.rbeg) {
                        diff = true;
                        break;
                    }
                    if (t.qbeg <= s.qbeg
                        && t.qbeg + t.len - s.qbeg >= (s.len >> 2)
                        && s.qbeg - t.qbeg != s.rbeg - t.rbeg) {
                        diff = true;
                        break;
                    }
                }
                if (!diff) {
                    dropped[c.srt[k]] = 1;
                    continue;  // speculative result discarded
                }
            }

            if (have != nullptr && !have[job_idx]) {
                // detection mode: this seed needs DP; request it and
                // (greedily) every other not-yet-run job of this read
                for (int64_t j = job_idx; j < job_end; j++)
                    if (!have[j]) missing->push_back(j);
                return false;
            }

            // --- build the region from the device result ---
            const int32_t* res = results + job_idx * 14;
            Reg a{};
            a.w = o.w;
            a.score = -1;
            a.truesc = -1;
            a.rid = c.rid;
            a.frac_rep = c.frac_rep;
            a.seedlen0 = (int32_t)s.len;
            bool has_left = s.qbeg > 0;
            bool has_right = s.qbeg + s.len != l_query;
            int64_t qe = s.qbeg + s.len;
            int64_t re0 = s.rbeg + s.len - c.rmax0;
            int32_t l_score = res[0], l_qle = res[1], l_tle = res[2];
            int32_t l_gtle = res[3], l_gscore = res[4];
            int32_t r_score = res[6], r_qle = res[7], r_tle = res[8];
            int32_t r_gtle = res[9], r_gscore = res[10];
            int32_t aw0 = res[12], aw1 = res[13];

            if (has_left) {
                a.score = l_score;
                if (l_gscore <= 0
                    || l_gscore <= a.score - o.pen_clip5) {
                    a.qb = (int32_t)(s.qbeg - l_qle);
                    a.rb = s.rbeg - l_tle;
                    a.truesc = a.score;
                } else {
                    a.qb = 0;
                    a.rb = s.rbeg - l_gtle;
                    a.truesc = l_gscore;
                }
            } else {
                a.score = a.truesc = (int32_t)(s.len * o.a);
                a.qb = 0;
                a.rb = s.rbeg;
                aw0 = o.w;
            }
            if (has_right) {
                int32_t sc0 = a.score;
                a.score = r_score;
                if (r_gscore <= 0
                    || r_gscore <= a.score - o.pen_clip3) {
                    a.qe = (int32_t)(qe + r_qle);
                    a.re = c.rmax0 + re0 + r_tle;
                    a.truesc += a.score - sc0;
                } else {
                    a.qe = (int32_t)l_query;
                    a.re = c.rmax0 + re0 + r_gtle;
                    a.truesc += r_gscore - sc0;
                }
            } else {
                a.qe = (int32_t)l_query;
                a.re = s.rbeg + s.len;
                aw1 = o.w;
            }
            a.seedcov = 0;
            for (int64_t si : c.seeds) {
                SeedRef t = seed_at(rows, si);
                if (t.qbeg >= a.qb && t.qbeg + t.len <= a.qe
                    && t.rbeg >= a.rb && t.rbeg + t.len <= a.re)
                    a.seedcov += (int32_t)t.len;
            }
            a.w = std::max(aw0, aw1);
            regs.push_back(a);
        }
    }
    return true;
}

}  // namespace

// Phase-1 job ids: the first-visited seed of every chain (job ids index
// ext_prepare's job order).  out_ids must hold >= n_chains entries.
int64_t ext_phase1(void* handle, int64_t* out_ids) {
    ExtState* st = (ExtState*)handle;
    int64_t n = 0;
    int64_t job_base = 0;
    for (const ExtChain& c : st->chains) {
        out_ids[n++] = job_base;
        job_base += (int64_t)c.seeds.size();
    }
    return n;
}

// Detection round: with partial results (have[j] = 1 if job j's result
// row is valid), return the job ids the next device round must run.
// 0 means the result set is complete for an exact ext_finalize.
int64_t ext_missing(void* handle, const int32_t* results,
                    const uint8_t* have, int64_t* out_ids, int64_t cap) {
    ExtState* st = (ExtState*)handle;
    std::vector<Reg> regs;
    std::vector<int64_t> missing;
    size_t ci = 0;
    int64_t job_base = 0;
    for (int64_t r = 0; r < st->n_reads; r++) {
        size_t ci0 = ci;
        int64_t jobs_here = 0;
        while (ci < st->chains.size() && st->chains[ci].read == r) {
            jobs_here += (int64_t)st->chains[ci].seeds.size();
            ci++;
        }
        replay_read(st, ci0, ci, job_base, job_base + jobs_here,
                    st->lens[r], results, have, regs, &missing);
        job_base += jobs_here;
    }
    if ((int64_t)missing.size() > cap) return -1;
    for (size_t i = 0; i < missing.size(); i++) out_ids[i] = missing[i];
    return (int64_t)missing.size();
}

// Outputs (caller-allocated; n_jobs entries suffice):
//   per-region arrays + reg_bounds [n_reads+1] (read r's regions are
//   [reg_bounds[r], reg_bounds[r+1]), in creation order).
// Frees the handle.  Returns 0, or -1 if cap exceeded.
int ext_finalize(
    void* handle, const int32_t* results,
    int64_t* reg_rb, int64_t* reg_re,
    int32_t* reg_qb, int32_t* reg_qe, int32_t* reg_score,
    int32_t* reg_truesc, int32_t* reg_w, int32_t* reg_seedcov,
    int32_t* reg_rid, int32_t* reg_seedlen0, double* reg_frac_rep,
    int64_t* reg_bounds, int64_t cap, int64_t* out_counts) {
    ExtState* st = (ExtState*)handle;
    int64_t n_regs = 0;
    std::vector<Reg> regs;
    size_t ci = 0;
    int64_t job_base = 0;
    int rc = 0;

    for (int64_t r = 0; r < st->n_reads; r++) {
        reg_bounds[r] = n_regs;
        size_t ci0 = ci;
        int64_t jobs_here = 0;
        while (ci < st->chains.size() && st->chains[ci].read == r) {
            jobs_here += (int64_t)st->chains[ci].seeds.size();
            ci++;
        }
        replay_read(st, ci0, ci, job_base, job_base + jobs_here,
                    st->lens[r], results, nullptr, regs, nullptr);
        job_base += jobs_here;
        // flush this read's regions
        for (const Reg& p : regs) {
            if (n_regs >= cap) {
                rc = -1;
                break;
            }
            reg_rb[n_regs] = p.rb;
            reg_re[n_regs] = p.re;
            reg_qb[n_regs] = p.qb;
            reg_qe[n_regs] = p.qe;
            reg_score[n_regs] = p.score;
            reg_truesc[n_regs] = p.truesc;
            reg_w[n_regs] = p.w;
            reg_seedcov[n_regs] = p.seedcov;
            reg_rid[n_regs] = p.rid;
            reg_seedlen0[n_regs] = p.seedlen0;
            reg_frac_rep[n_regs] = p.frac_rep;
            n_regs++;
        }
        if (rc) break;
    }
    reg_bounds[st->n_reads] = n_regs;
    out_counts[0] = n_regs;
    delete st;
    return rc;
}

// Free a handle without running ext_finalize (error paths).
void ext_free(void* handle) { delete (ExtState*)handle; }

}  // extern "C"
