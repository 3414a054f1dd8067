// Flat-path SAM record assembly: NM/MD + cigar strings + XA alternates +
// line formatting for a whole read batch in one native call.
//
// Clean-room counterpart of the per-record host loops in
// tpubwa/align/flatsam.py (python reference semantics:
// ops/global_align.py cigar_nm_md, align/finalize.py aln2sam field rules,
// gen_xa_g's XA string format, and REVCOMP_TRANS).  Reference analog:
// bwa-mem2's batched worker_sam move — SAM text assembly dominated the
// scalar path's wall and was batched natively.
//
// Two index spaces:
//   * LANES (NL): one per alignment needing a cigar — emitted records AND
//     their XA alternates share the flat_core columnar outputs.
//   * RECORDS (NR): one per emitted SAM line; rec_lane picks the record's
//     lane, [alt_lo, alt_hi) its XA alternate lanes, rec_b its output row.
// Rows without records copy the caller's pre-rendered `other` text.
//
// Returns the total byte count (may exceed out_cap — caller re-invokes
// with a larger buffer; emission costs ~nothing to repeat), or -1 - r
// when record r's MD string overflows its buffer.
#include <cstdint>
#include <cstring>

namespace {

const char MD_CHARS[] = "ACGTN";
const char CIGAR_OPS[] = "MIDSH";

struct Buf {
    uint8_t* p;
    int64_t cap;
    int64_t n;
    inline void putc(char c) {
        if (n < cap) p[n] = (uint8_t)c;
        n++;
    }
    inline void put(const uint8_t* s, int64_t len) {
        if (len <= 0) return;
        if (n + len <= cap) memcpy(p + n, s, (size_t)len);
        n += len;
    }
    inline void put_int(int64_t v) {
        char t[24];
        int k = 0;
        if (v < 0) { putc('-'); v = -v; }
        if (v == 0) { putc('0'); return; }
        while (v) { t[k++] = (char)('0' + v % 10); v /= 10; }
        while (k) putc(t[--k]);
    }
};

// complement table matching finalize.REVCOMP_TRANS
// "ACGTURYSWKMBDHVNacgturyswkmbdhvn" -> "TGCAAYRSWMKVHDBNtgcaayrswmkvhdbn"
struct CompTab {
    uint8_t t[256];
    CompTab() {
        const char* a = "ACGTURYSWKMBDHVNacgturyswkmbdhvn";
        const char* b = "TGCAAYRSWMKVHDBNtgcaayrswmkvhdbn";
        for (int i = 0; i < 256; i++) t[i] = (uint8_t)i;
        for (int i = 0; a[i]; i++) t[(uint8_t)a[i]] = (uint8_t)b[i];
    }
};
const CompTab COMP;

// per-lane columnar views shared by records and XA alternates
struct Lanes {
    const uint8_t* rev;
    const int32_t* rid;
    const int64_t* pos1;
    const int32_t* clip5;
    const int32_t* clip3;
    const int32_t* cig_ns;
    const int32_t* cig_pack;
    int64_t ga_k;
    const int32_t* lead_d;
    const int32_t* trail_d;
    const int32_t* nm_in;
    const uint8_t* mm_pos;
    const uint8_t* mm_let;
    int64_t mm_k;
    const int32_t* lq;
    const int32_t* rlen;
    const int32_t* win_row;
    const int8_t* qwin;
    const int8_t* twin;
    int64_t qpad, twinw;
};

// cigar string (clips + post-squeeze segments) for lane i
static void put_cigar(Buf& ob, const Lanes& L, int64_t i) {
    const int32_t ns = L.cig_ns[i];
    const int32_t* seg = L.cig_pack + i * L.ga_k;
    if (L.clip5[i]) { ob.put_int(L.clip5[i]); ob.putc('S'); }
    for (int32_t s = 0; s < ns; s++) {
        ob.put_int(seg[s] >> 2);
        ob.putc(CIGAR_OPS[seg[s] & 3]);
    }
    if (L.clip3[i]) { ob.put_int(L.clip3[i]); ob.putc('S'); }
}

// NM (returned) and, when md != nullptr, the MD string, for lane i.
// Walks the PRE-squeEZE cigar (lead/trail deletions re-attached) —
// generator-path parity: NM/MD are computed before the squeeze.
static int64_t lane_nm_md(const Lanes& L, int64_t i, Buf* md) {
    int64_t nm = 0;
    if (L.nm_in[i] >= 0) {
        nm = L.nm_in[i];
        if (md) {
            const uint8_t* mp = L.mm_pos + i * L.mm_k;
            const uint8_t* ml = L.mm_let + i * L.mm_k;
            int32_t prev = 0;
            for (int64_t k = 0; k < nm; k++) {
                md->put_int((int64_t)mp[k] - prev);
                md->putc(MD_CHARS[ml[k] > 4 ? 4 : ml[k]]);
                prev = (int32_t)mp[k] + 1;
            }
            md->put_int((int64_t)L.lq[i] - prev);
        }
        return nm;
    }
    const int8_t* q = L.qwin + (int64_t)L.win_row[i] * L.qpad;
    const int8_t* t = L.twin + (int64_t)L.win_row[i] * L.twinw;
    const int32_t ns = L.cig_ns[i];
    const int32_t* seg = L.cig_pack + i * L.ga_k;
    int64_t qi = 0, ti = 0, run = 0;
    for (int32_t s = -1; s <= ns; s++) {
        int32_t op, ln;
        if (s < 0) {
            if (!L.lead_d[i]) continue;
            op = 2; ln = L.lead_d[i];
        } else if (s == ns) {
            if (!L.trail_d[i]) continue;
            op = 2; ln = L.trail_d[i];
        } else {
            op = seg[s] & 3; ln = seg[s] >> 2;
        }
        if (op == 0) {          // M
            int64_t prev = 0;
            for (int32_t j = 0; j < ln; j++) {
                const int8_t qc = q[qi + j], tc = t[ti + j];
                if (qc != tc || qc >= 4) {
                    if (md) {
                        md->put_int(run + j - prev);
                        md->putc(MD_CHARS[tc > 4 ? 4 : tc]);
                    }
                    run = 0;
                    prev = j + 1;
                    nm++;
                }
            }
            run += ln - prev;
            qi += ln; ti += ln;
        } else if (op == 1) {   // I
            qi += ln; nm += ln;
        } else {                // D
            if (md) {
                md->put_int(run);
                md->putc('^');
                for (int32_t j = 0; j < ln; j++)
                    md->putc(MD_CHARS[t[ti + j] > 4 ? 4 : t[ti + j]]);
            }
            run = 0;
            nm += ln;
            ti += ln;
        }
    }
    if (md) md->put_int(run);
    return nm;
}

}  // namespace

extern "C" int64_t sam_emit_se(
    int64_t B,
    // per-row text for rows without flat records, [B+1] offsets
    const uint8_t* other, const int64_t* other_off,
    // per-row string buffers, [B+1] offsets each
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* seq_buf, const int64_t* seq_off,
    const uint8_t* qual_buf, const int64_t* qual_off,
    // contig names
    const uint8_t* cname_buf, const int64_t* cname_off,
    // per-lane columns (NL lanes: records + XA alternates)
    int64_t NL,
    const uint8_t* rev, const int32_t* rid, const int64_t* pos1,
    const int32_t* clip5, const int32_t* clip3,
    const int32_t* cig_ns, const int32_t* cig_pack, int64_t ga_k,
    const int32_t* lead_d, const int32_t* trail_d,
    const int32_t* nm_in,
    const uint8_t* mm_pos, const uint8_t* mm_let, int64_t mm_k,
    const int32_t* lq, const int32_t* rlen,
    const int32_t* win_row,
    const int8_t* qwin, const int8_t* twin, int64_t qpad, int64_t twinw,
    // per-record columns (NR records, ascending rec_b)
    int64_t NR,
    const int32_t* rec_b, const int32_t* rec_lane,
    const int32_t* rec_flag, const int32_t* rec_mapq,
    const int32_t* rec_score, const int32_t* rec_xs,
    const int32_t* rnext_rid, const int64_t* pnext, const int64_t* tlen,
    const int32_t* alt_lo, const int32_t* alt_hi,
    uint8_t* out, int64_t out_cap) {
    Lanes L{rev, rid, pos1, clip5, clip3, cig_ns, cig_pack, ga_k,
            lead_d, trail_d, nm_in, mm_pos, mm_let, mm_k, lq, rlen,
            win_row, qwin, twin, qpad, twinw};
    Buf ob{out, out_cap, 0};
    int64_t ri = 0;
    for (int64_t b = 0; b < B; b++) {
        if (ri >= NR || rec_b[ri] != b) {
            ob.put(other + other_off[b], other_off[b + 1] - other_off[b]);
            continue;
        }
        const int64_t r = ri++;
        const int64_t i = rec_lane[r];
        // --- QNAME, FLAG, RNAME, POS, MAPQ ---
        ob.put(name_buf + name_off[b], name_off[b + 1] - name_off[b]);
        ob.putc('\t');
        ob.put_int(rec_flag[r]);
        ob.putc('\t');
        const int32_t cid = rid[i];
        ob.put(cname_buf + cname_off[cid],
               cname_off[cid + 1] - cname_off[cid]);
        ob.putc('\t');
        ob.put_int(pos1[i]);
        ob.putc('\t');
        ob.put_int(rec_mapq[r]);
        ob.putc('\t');
        put_cigar(ob, L, i);
        ob.putc('\t');
        // --- RNEXT / PNEXT / TLEN ---
        const int32_t nr = rnext_rid[r];
        if (nr == -1) ob.putc('*');
        else if (nr == -2) ob.putc('=');
        else ob.put(cname_buf + cname_off[nr],
                    cname_off[nr + 1] - cname_off[nr]);
        ob.putc('\t');
        ob.put_int(pnext[r]);
        ob.putc('\t');
        ob.put_int(tlen[r]);
        ob.putc('\t');
        // --- SEQ / QUAL (revcomp / reverse for reverse-strand hits) ---
        const uint8_t* sq = seq_buf + seq_off[b];
        const int64_t sl = seq_off[b + 1] - seq_off[b];
        if (rev[i]) {
            if (ob.n + sl <= ob.cap)
                for (int64_t k = 0; k < sl; k++)
                    ob.p[ob.n + k] = COMP.t[sq[sl - 1 - k]];
            ob.n += sl;
        } else {
            ob.put(sq, sl);
        }
        ob.putc('\t');
        const uint8_t* qu = qual_buf + qual_off[b];
        const int64_t ql = qual_off[b + 1] - qual_off[b];
        if (ql == 0) {
            ob.putc('*');
        } else if (rev[i]) {
            if (ob.n + ql <= ob.cap)
                for (int64_t k = 0; k < ql; k++)
                    ob.p[ob.n + k] = qu[ql - 1 - k];
            ob.n += ql;
        } else {
            ob.put(qu, ql);
        }
        // --- NM / MD / AS / XS ---
        // MD writes at most 2 characters a reference base (a letter and
        // the run before it, "0A" at worst; a run of k matched bases
        // writes at most k digits) and 2 more a deletion ("0^"): under
        // 900 for a lane of WIDE's 384-base window with GA_K 24
        // segments + 2 squeezed deletions.
        uint8_t mdbuf[4096];
        Buf md{mdbuf, (int64_t)sizeof(mdbuf), 0};
        const int64_t nm = lane_nm_md(L, i, &md);
        if (md.n > md.cap) return -1 - r;  // truncating would corrupt the
        //   line: the caller raises, naming record r
        ob.putc('\t');
        ob.put((const uint8_t*)"NM:i:", 5);
        ob.put_int(nm);
        ob.put((const uint8_t*)"\tMD:Z:", 6);
        ob.put(md.p, md.n);
        ob.put((const uint8_t*)"\tAS:i:", 6);
        ob.put_int(rec_score[r]);
        ob.put((const uint8_t*)"\tXS:i:", 6);
        ob.put_int(rec_xs[r]);
        // --- XA (alternate-hit lanes) ---
        if (alt_hi[r] > alt_lo[r]) {
            ob.put((const uint8_t*)"\tXA:Z:", 6);
            for (int32_t a = alt_lo[r]; a < alt_hi[r]; a++) {
                const int32_t ac = rid[a];
                ob.put(cname_buf + cname_off[ac],
                       cname_off[ac + 1] - cname_off[ac]);
                ob.putc(',');
                ob.putc(rev[a] ? '-' : '+');
                ob.put_int(pos1[a]);
                ob.putc(',');
                put_cigar(ob, L, a);
                ob.putc(',');
                ob.put_int(lane_nm_md(L, a, nullptr));
                ob.putc(';');
            }
        }
        ob.putc('\n');
    }
    return ob.n;
}
