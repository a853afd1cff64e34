// andix native host runtime: Phi-LCP construction and anchor-chain replay.
//
// These are the two host-side components of the device pipeline:
//
// * lcp_from_sa: adjacent-LCP array from a suffix array via the permuted-LCP
//   (Phi) algorithm family (Kärkkäinen/Manzini/Puglisi 2009; the reference
//   uses the same family at src/esa.c:373-426).  Written from the algorithm
//   description, parallelized over chunks: PLCP is recomputed from scratch at
//   each chunk head (the while loop computes a true LCP regardless of the
//   carried l), so chunks are independent.
//
// * dist_anchor_replay: the path-dependent anchor-chaining scan of the
//   reference (dist_anchor, src/process.c:141-214) re-expressed over
//   precomputed match statistics.  Exact same acceptance rules: lucky
//   anchors (diagonal extension, gap <= threshold), uniqueness + threshold,
//   diagonal pairing on one strand half, 2x-threshold lone anchors,
//   identical-sequence special case, and the skip advance pos_Q += len + 1.
//
// Build: g++ -O3 -fopenmp -shared -fPIC (see build.py).  Interface: plain C
// ABI consumed via ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// LCP construction
// ---------------------------------------------------------------------------

// sym: int32 text symbols (bytes + unique separators >= 256)
// sa:  int32 suffix array of sym
// lcp: out, int32[n]; lcp[t] = lcp(suffix(sa[t-1]), suffix(sa[t])), lcp[0]=0
// phi_scratch: int32[n] workspace
void lcp_from_sa(const int32_t* sym, const int32_t* sa, int64_t n,
                 int32_t* lcp, int32_t* phi_scratch, int32_t* plcp_scratch,
                 int threads) {
    if (n <= 0) return;
#ifdef _OPENMP
    if (threads > 0) omp_set_num_threads(threads);
#endif
    int32_t* phi = phi_scratch;
    int32_t* plcp = plcp_scratch;

#pragma omp parallel for schedule(static)
    for (int64_t t = 1; t < n; t++) {
        phi[sa[t]] = sa[t - 1];
    }
    phi[sa[0]] = -1;

    // chunked PLCP: each chunk starts with l = 0 and is therefore independent
    const int64_t chunk = 1 << 18;
    const int64_t nchunks = (n + chunk - 1) / chunk;
#pragma omp parallel for schedule(dynamic)
    for (int64_t c = 0; c < nchunks; c++) {
        const int64_t lo = c * chunk;
        const int64_t hi = std::min(n, lo + chunk);
        int64_t l = 0;
        for (int64_t i = lo; i < hi; i++) {
            const int64_t k = phi[i];
            if (k >= 0) {
                while (k + l < n && i + l < n && sym[k + l] == sym[i + l]) {
                    l++;
                }
                plcp[i] = (int32_t)l;
                if (l > 0) l--;
            } else {
                plcp[i] = 0;
                l = 0;
            }
        }
    }

    lcp[0] = 0;
#pragma omp parallel for schedule(static)
    for (int64_t t = 1; t < n; t++) {
        lcp[t] = plcp[sa[t]];
    }
}

// ---------------------------------------------------------------------------
// Anchor-chain replay
// ---------------------------------------------------------------------------

static inline int64_t lcp_bytes(const uint8_t* a, const uint8_t* b,
                                int64_t limit) {
    int64_t k = 0;
    while (k < limit && a[k] == b[k]) k++;
    return k;
}

// Classify one anchor segment (model_count_equal, src/model.c:246-279).
// exact_counts != 0 selects the LogDet/ANI per-character path.
static inline void count_equal(int64_t counts[16], const uint8_t* seg,
                               int64_t len, int exact_counts) {
    if (!exact_counts) {
        const int64_t fourth = len / 4;
        counts[0] += fourth;            // AtoA
        counts[5] += fourth;            // CtoC
        counts[10] += fourth;           // GtoG
        counts[15] += fourth + (len & 3); // TtoT + remainder
        return;
    }
    int64_t local[4] = {0, 0, 0, 0};
    for (int64_t i = 0; i < len; i++) {
        const uint8_t s = seg[i];
        if (s < 'A') continue; // ';', '!', '#'
        local[(s >> 1) & 3]++; // A->0 C->1 T->2 G->3
    }
    counts[0] += local[0];
    counts[5] += local[1];
    counts[10] += local[3];
    counts[15] += local[2];
}

static inline uint8_t nucl2bit(uint8_t c) {
    c &= 6;
    c ^= c >> 1;
    return c >> 1;
}

// Count substitutions in a gap (model_count, src/model.c:309-337).
static inline void count_subst(int64_t counts[16], const uint8_t* s,
                               const uint8_t* q, int64_t len) {
    for (int64_t i = 0; i < len; i++) {
        const uint8_t a = s[i];
        const uint8_t b = q[i];
        if (a < 'A' || b < 'A') continue;
        counts[(nucl2bit(a) << 2) | nucl2bit(b)]++;
    }
}

// Replay of dist_anchor (src/process.c:141-214) over precomputed stats.
void dist_anchor_replay(const int32_t* matchlen, const uint8_t* unique,
                        const int32_t* pos_s, const uint8_t* rs,
                        int64_t rs_len, const uint8_t* query, int64_t m,
                        int64_t threshold, int exact_counts,
                        int64_t counts[16]) {
    std::memset(counts, 0, 16 * sizeof(int64_t));

    int64_t this_pos_q = 0, this_pos_s = 0, this_len = 0;
    int64_t last_pos_q = 0, last_pos_s = 0, last_len = 0;
    bool last_was_right_anchor = false;
    const int64_t border = rs_len / 2;

    while (this_pos_q < m) {
        bool found = false;

        // lucky_anchor (src/process.c:82-100)
        const int64_t advance = this_pos_q - last_pos_q;
        const int64_t gap = this_pos_q - last_pos_q - last_len;
        const int64_t try_pos_s = last_pos_s + advance;
        if (try_pos_s < rs_len && gap >= 0 && gap <= threshold) {
            this_pos_s = try_pos_s;
            const int64_t limit =
                std::min(m - this_pos_q, rs_len - try_pos_s);
            this_len = lcp_bytes(query + this_pos_q, rs + try_pos_s, limit);
            found = this_len >= threshold;
        }

        // anchor (src/process.c:113-123)
        if (!found) {
            this_len = matchlen[this_pos_q];
            this_pos_s = pos_s[this_pos_q];
            found = unique[this_pos_q] && this_len >= threshold;
        }

        if (found) {
            const int64_t end_s = last_pos_s + last_len;
            const int64_t end_q = last_pos_q + last_len;
            if (this_pos_s > end_s &&
                this_pos_q - end_q == this_pos_s - end_s &&
                (this_pos_s < border) == (last_pos_s < border)) {
                count_equal(counts, query + last_pos_q, last_len,
                            exact_counts);
                count_subst(counts, rs + end_s, query + end_q,
                            this_pos_q - end_q);
                last_was_right_anchor = true;
            } else {
                if (last_was_right_anchor ||
                    last_len >= threshold * 2) {
                    count_equal(counts, query + last_pos_q, last_len,
                                exact_counts);
                }
                last_was_right_anchor = false;
            }
            last_pos_q = this_pos_q;
            last_pos_s = this_pos_s;
            last_len = this_len;
        }

        this_pos_q += this_len + 1;
    }

    // identical sequences (src/process.c:199-203)
    if (last_len >= m) {
        count_equal(counts, query, m, exact_counts);
        return;
    }

    // trailing anchor (src/process.c:207-211)
    if (last_was_right_anchor || last_len >= threshold * 2) {
        count_equal(counts, query + last_pos_q, last_len, exact_counts);
    }
}

// Batched replay: pairs share one subject; queries are packed back to back.
// q_off[k]..q_off[k+1] delimits query k in query_blob; matchstats arrays are
// packed the same way.  counts_out is int64[npairs][16].  OpenMP across
// pairs (the device pipeline's analogue of the reference's query-parallel
// inner loop, src/dist_hack.h:16,59).
void dist_anchor_replay_batch(const int32_t* matchlen, const uint8_t* unique,
                              const int32_t* pos_s, const uint8_t* rs,
                              int64_t rs_len, const uint8_t* query_blob,
                              const int64_t* q_off, int64_t npairs,
                              int64_t threshold, int exact_counts,
                              int threads, int64_t* counts_out) {
#ifdef _OPENMP
    if (threads > 0) omp_set_num_threads(threads);
#endif
#pragma omp parallel for schedule(dynamic)
    for (int64_t k = 0; k < npairs; k++) {
        const int64_t off = q_off[k];
        const int64_t len = q_off[k + 1] - off;
        dist_anchor_replay(matchlen + off, unique + off, pos_s + off, rs,
                           rs_len, query_blob + off, len, threshold,
                           exact_counts, counts_out + 16 * k);
    }
}

// ---------------------------------------------------------------------------
// Counting from device-recorded anchor events
// ---------------------------------------------------------------------------

// The device chain walk records accepted anchors (q, s, len) in chain order
// per lane; the counting block of dist_anchor (src/process.c:160-211) is a
// pure function of that sequence plus the host-resident text.  One lane:
static void count_from_anchors(const int32_t* ev_q, const int32_t* ev_s,
                               const int32_t* ev_len, int64_t n_ev,
                               const uint8_t* rs, int64_t rs_len,
                               const uint8_t* query, int64_t m,
                               int64_t threshold, int exact_counts,
                               int64_t counts[16]) {
    std::memset(counts, 0, 16 * sizeof(int64_t));
    int64_t last_q = 0, last_s = 0, last_len = 0;
    bool last_right = false;
    const int64_t border = rs_len / 2;

    for (int64_t k = 0; k < n_ev; k++) {
        const int64_t q = ev_q[k], s = ev_s[k], ln = ev_len[k];
        const int64_t end_s = last_s + last_len;
        const int64_t end_q = last_q + last_len;
        if (s > end_s && q - end_q == s - end_s &&
            (s < border) == (last_s < border)) {
            count_equal(counts, query + last_q, last_len, exact_counts);
            count_subst(counts, rs + end_s, query + end_q, q - end_q);
            last_right = true;
        } else {
            if (last_right || last_len >= threshold * 2) {
                count_equal(counts, query + last_q, last_len, exact_counts);
            }
            last_right = false;
        }
        last_q = q;
        last_s = s;
        last_len = ln;
    }

    if (last_len >= m) {  // identical sequences (src/process.c:199-203)
        count_equal(counts, query, m, exact_counts);
        return;
    }
    if (last_right || last_len >= threshold * 2) {  // trailing anchor
        count_equal(counts, query + last_q, last_len, exact_counts);
    }
}

// Batched over the sg x g lanes of a subject group.  Events are sorted by
// lane (stable, chain order within lane); bounds[lane]..bounds[lane+1]
// delimits each lane's events.  rs_off[k+1] == rs_off[k] marks a padding
// subject row.  counts_out is int64[sg*g*16].
void count_from_anchors_batch(const int32_t* ev_q, const int32_t* ev_s,
                              const int32_t* ev_len, const int64_t* bounds,
                              int64_t sg, int64_t g, const uint8_t* rs_blob,
                              const int64_t* rs_off,
                              const int64_t* thresholds,
                              const uint8_t* query_blob, const int64_t* q_off,
                              int exact_counts, int threads,
                              int64_t* counts_out) {
#ifdef _OPENMP
    if (threads > 0) omp_set_num_threads(threads);
#endif
#pragma omp parallel for schedule(dynamic) collapse(2)
    for (int64_t k = 0; k < sg; k++) {
        for (int64_t qg = 0; qg < g; qg++) {
            const int64_t lane = k * g + qg;
            int64_t* out = counts_out + 16 * lane;
            const int64_t rlo = rs_off[k], rhi = rs_off[k + 1];
            const int64_t qlo = q_off[qg], qhi = q_off[qg + 1];
            if (rhi <= rlo || qhi <= qlo) {
                std::memset(out, 0, 16 * sizeof(int64_t));
                continue;
            }
            const int64_t lo = bounds[lane], hi = bounds[lane + 1];
            count_from_anchors(ev_q + lo, ev_s + lo, ev_len + lo, hi - lo,
                               rs_blob + rlo, rhi - rlo, query_blob + qlo,
                               qhi - qlo, thresholds[k], exact_counts, out);
        }
    }
}

}  // extern "C"
