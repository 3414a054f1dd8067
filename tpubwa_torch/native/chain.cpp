// Seed chaining + chain filtering — native host engine (batch entry point).
//
// Exact re-implementation of tpubwa_torch/align/chain.py's chain_read +
// filter_chains (themselves the semantics of bwa-mem's mem_chain /
// mem_chain_flt — reference call stack SURVEY.md §3.1 worker_aln ->
// mem_chain_seeds, [src] bwamem.cpp:808).  The Python module remains the
// correctness reference; tests/test_torch_chain.py pins this code to it
// with exact-equality differential tests.  The chaining internals live in
// core.h, shared with the extension orchestrator (extension.cpp).
//
// Batch interface: one call chains every read of a device batch.  Seeds
// arrive as the (read_id, rbeg, qbeg, len) rows downloaded from the device
// seeding engine, already grouped by read and in SMEM order.

#include <cstdint>
#include <vector>

#include "core.h"

using namespace tpubwa;

extern "C" {

// Chain + filter every read of a batch.
//
//   seed_rows    [n_seeds, 4] int64: (read_id, rbeg, qbeg, len), grouped by
//                read_id ascending, SMEM order within each read
//   read_bounds  [n_reads + 1] int64: read r's seeds are rows
//                [read_bounds[r], read_bounds[r+1])
//   skip_read    [n_reads] uint8: nonzero -> emit no chains for this read
//                (reads shorter than min_seed_len)
// Outputs (caller-allocated; n_seeds rows are always enough):
//   out_chain_read [cap] int32, out_chain_rid [cap] int32,
//   out_chain_w [cap] int32, out_chain_off [cap+1] int64,
//   out_seed_idx [n_seeds] int64 (indices into seed_rows),
//   out_counts [2] int64: {n_chains, n_chain_seeds}
// Returns 0, or -1 if cap was exceeded.
int chain_filter_batch(
    const int64_t* seed_rows, int64_t n_seeds,
    const int64_t* read_bounds, int64_t n_reads,
    const uint8_t* skip_read,
    const int64_t* contig_offsets, int64_t n_contigs, int64_t l_pac,
    int32_t w, int32_t max_chain_gap, int32_t min_chain_weight,
    int64_t max_chain_extend, double mask_level, double drop_ratio,
    int32_t min_seed_len,
    int32_t* out_chain_read, int32_t* out_chain_rid, int32_t* out_chain_w,
    int64_t* out_chain_off, int64_t* out_seed_idx, int64_t cap,
    int64_t* out_counts) {
    ChainOpts o{w, max_chain_gap, min_chain_weight, max_chain_extend,
                mask_level, drop_ratio, min_seed_len};
    int64_t n_chains = 0, n_out_seeds = 0;
    out_chain_off[0] = 0;
    std::vector<Ch> scratch, kept;
    for (int64_t r = 0; r < n_reads; r++) {
        if (skip_read[r]) continue;
        kept.clear();
        chain_one_read(o, seed_rows, read_bounds[r], read_bounds[r + 1],
                       contig_offsets, n_contigs, l_pac, scratch, kept);
        for (Ch& c : kept) {
            if (n_chains >= cap) return -1;
            out_chain_read[n_chains] = (int32_t)r;
            out_chain_rid[n_chains] = c.rid;
            out_chain_w[n_chains] = c.w;
            for (int64_t si : c.seeds) out_seed_idx[n_out_seeds++] = si;
            out_chain_off[n_chains + 1] = n_out_seeds;
            n_chains++;
        }
    }
    out_counts[0] = n_chains;
    out_counts[1] = n_out_seeds;
    return 0;
}

}  // extern "C"
