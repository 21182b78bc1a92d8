/* Smith-Waterman forward pass + k-mer postings builder — native hot paths.
 *
 * sw_forward replicates spacepharer_tpu.ops.align._forward_pass cell for
 * cell (Farrar semantics of the reference's sw_sse2_byte/word,
 * lib/mmseqs/src/alignment/StripedSmithWaterman.cpp:301-520: the E update
 * reads H before the lazy-F correction; end cell = first target column
 * attaining a strictly greater running max, min query row within it).
 *
 * build_postings replicates the posting-list construction of
 * ops.prefilter.build_target_index (the CSR k-mer index of
 * lib/mmseqs/src/prefiltering/IndexTable.h:25-38 re-expressed as
 * radix-sorted (code, seq, first-pos) triples).
 */
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>
#if defined(__x86_64__)
#include <immintrin.h>
#endif

#define NEG_F (-(int64_t)1 << 40)

/* ---- exact AVX2 i16 forward pass ----
 *
 * Vertical vectorization of sw_forward over the query rows with the
 * affine-F recurrence re-expressed as a prefix max (the same algebra
 * as the Pallas kernel, ops/sw_packed.py): hp never depends on F, so
 *   F_j = max_{k<j}(hp_k + k*ge) - go - (j-1)*ge
 * and every quantity stays exact in int16 while the query's score
 * bound is small (the caller routes big-bound/long queries to the
 * scalar kernel). Endpoint semantics are the scalar's exactly: the
 * end cell is the first target column attaining a strictly greater
 * running max, minimum query row within it — bit-identical outputs
 * (same oracle tests as the scalar, tests/test_batch_drivers.py).
 * SW-score upper bound of a profile: at most one diagonal step per
 * query row ever adds score. */
int32_t sw_profile_bound(const int32_t *prof, int64_t stride, int32_t lq,
                         int32_t A) {
    int64_t bound = 0;
    for (int32_t j = 0; j < lq; j++) {
        int32_t m = 0;
        for (int32_t a = 0; a < A; a++) {
            int32_t v = prof[(int64_t)a * stride + j];
            if (v > m) m = v;
        }
        bound += m;
    }
    return bound > (1 << 30) ? (1 << 30) : (int32_t)bound;
}

#if defined(__x86_64__)

int sw_simd_supported(void) {
    return __builtin_cpu_supports("avx2");
}

#define SW_I16_MAXVEC 16      /* lq <= 256 */
#define SW_I16_NEG (-30000)

/* prof here is the TRANSPOSED per-letter layout prof[a*stride + j]
 * (the same layout sw_forward consumes). reverse=1 mirrors the scalar
 * kernel's reversed frame: row j reads prof column lq-1-j, column i
 * reads tseq[lt-1-i], outputs stay in the reversed frame. */
__attribute__((target("avx2")))
void sw_forward_i16(const int32_t *prof, int64_t stride, int32_t lq,
                    int32_t A,
                    const uint8_t *tseq, int64_t lt,
                    int32_t gap_open, int32_t gap_extend, int32_t reverse,
                    int64_t *out /* best, t_end, q_end */) {
    int nvec = (lq + 15) / 16;
    /* striped-free layout: vector v holds rows v*16 .. v*16+15 */
    __m256i H[SW_I16_MAXVEC], E[SW_I16_MAXVEC], G[SW_I16_MAXVEC];
    int16_t profbuf[32 * SW_I16_MAXVEC * 16]
        __attribute__((aligned(32)));
    int16_t tmp16[16] __attribute__((aligned(32)));
    /* per-letter i16 row copies, padded rows = SW_I16_NEG so pad hp
     * clamps to 0 and (after the valid mask) can never win */
    int32_t A_used = A < 32 ? A : 32;
    for (int32_t a = 0; a < A_used; a++) {
        const int32_t *src = prof + (int64_t)a * stride;
        int16_t *dst = profbuf + (int64_t)a * nvec * 16;
        for (int32_t j = 0; j < nvec * 16; j++) {
            if (j < lq) {
                int32_t v = src[reverse ? (lq - 1 - j) : j];
                dst[j] = (int16_t)v;
            } else {
                dst[j] = SW_I16_NEG;
            }
        }
    }
    /* j*ge ramp and validity mask per vector */
    __m256i ramp[SW_I16_MAXVEC], valid[SW_I16_MAXVEC];
    for (int v = 0; v < nvec; v++) {
        for (int l = 0; l < 16; l++)
            tmp16[l] = (int16_t)((v * 16 + l) * gap_extend);
        ramp[v] = _mm256_load_si256((const __m256i *)tmp16);
        for (int l = 0; l < 16; l++)
            tmp16[l] = (v * 16 + l) < lq ? 0 : 1;
        __m256i isp = _mm256_load_si256((const __m256i *)tmp16);
        valid[v] = _mm256_cmpeq_epi16(isp, _mm256_setzero_si256());
    }
    const __m256i vzero = _mm256_setzero_si256();
    const __m256i vneg = _mm256_set1_epi16(SW_I16_NEG);
    const __m256i vgo = _mm256_set1_epi16((int16_t)gap_open);
    const __m256i vge = _mm256_set1_epi16((int16_t)gap_extend);
    for (int v = 0; v < nvec; v++) {
        H[v] = vzero;
        E[v] = vzero;
    }
    int32_t best = 0;
    int64_t t_end = -1;
    int32_t q_end = lq - 1;

    for (int64_t i = 0; i < lt; i++) {
        uint8_t c = tseq[reverse ? (lt - 1 - i) : i];
        const int16_t *prow = profbuf + (int64_t)c * nvec * 16;
        /* diag shift: rows shift down by one across the vector chain */
        __m256i carry = vzero;   /* H[-1] = 0 boundary */
        __m256i rowmax = vneg;
        __m256i gcarry = vneg;   /* running cross-vector prefix max */
        for (int v = 0; v < nvec; v++) {
            __m256i h = H[v];
            /* shift lanes down by one i16 with carry-in: AVX2 alignr
             * works within 128-bit halves; build the shifted vector
             * via permute+alignr */
            __m256i swap = _mm256_permute2x128_si256(carry, h, 0x21);
            __m256i hdiag = _mm256_alignr_epi8(h, swap, 14);
            carry = h;
            __m256i p = _mm256_load_si256(
                (const __m256i *)(prow + v * 16));
            __m256i hp = _mm256_adds_epi16(hdiag, p);
            hp = _mm256_max_epi16(hp, vzero);
            __m256i e = E[v];
            hp = _mm256_max_epi16(hp, e);
            __m256i en = _mm256_max_epi16(
                _mm256_subs_epi16(hp, vgo), _mm256_subs_epi16(e, vge));
            E[v] = _mm256_max_epi16(en, vzero);
            /* g = hp + j*ge for the F prefix max */
            __m256i g = _mm256_adds_epi16(hp, ramp[v]);
            /* in-vector prefix max (shift down 1,2,4,8 lanes) */
            __m256i s1 = _mm256_permute2x128_si256(vneg, g, 0x21);
            g = _mm256_max_epi16(g, _mm256_alignr_epi8(g, s1, 14));
            s1 = _mm256_permute2x128_si256(vneg, g, 0x21);
            g = _mm256_max_epi16(g, _mm256_alignr_epi8(g, s1, 12));
            s1 = _mm256_permute2x128_si256(vneg, g, 0x21);
            g = _mm256_max_epi16(g, _mm256_alignr_epi8(g, s1, 8));
            /* shift by 8 lanes = take the low 128 half into the high */
            s1 = _mm256_permute2x128_si256(vneg, g, 0x21);
            g = _mm256_max_epi16(g, s1);
            g = _mm256_max_epi16(g, gcarry);
            G[v] = g;
            /* cross-vector carry: broadcast the last lane */
            __m256i hi = _mm256_permute2x128_si256(g, g, 0x11);
            gcarry = _mm256_broadcastw_epi16(
                _mm256_castsi256_si128(
                    _mm256_srli_si256(hi, 14)));
            /* F_j reads the prefix over k <= j-1: shift G down one;
             * v==0's lane-0 carry-in is gprev=vneg (no predecessor) */
            __m256i gprev = (v == 0) ? vneg : G[v - 1];
            __m256i gswap = _mm256_permute2x128_si256(gprev, G[v], 0x21);
            __m256i gsh = _mm256_alignr_epi8(G[v], gswap, 14);
            __m256i F = _mm256_subs_epi16(
                _mm256_subs_epi16(gsh, vgo),
                _mm256_subs_epi16(ramp[v], vge));
            __m256i hnew = _mm256_max_epi16(hp, F);
            H[v] = hnew;
            /* pad rows never contribute to the row max */
            __m256i hmask = _mm256_blendv_epi8(vneg, hnew, valid[v]);
            rowmax = _mm256_max_epi16(rowmax, hmask);
        }
        /* horizontal max of rowmax */
        __m128i m128 = _mm_max_epi16(
            _mm256_castsi256_si128(rowmax),
            _mm256_extracti128_si256(rowmax, 1));
        m128 = _mm_max_epi16(m128, _mm_srli_si128(m128, 8));
        m128 = _mm_max_epi16(m128, _mm_srli_si128(m128, 4));
        m128 = _mm_max_epi16(m128, _mm_srli_si128(m128, 2));
        int32_t colmax = (int16_t)_mm_extract_epi16(m128, 0);
        if (colmax > best) {
            best = colmax;
            t_end = i;
            /* min query row attaining colmax this column */
            __m256i want = _mm256_set1_epi16((int16_t)colmax);
            for (int v = 0; v < nvec; v++) {
                __m256i eq = _mm256_and_si256(
                    _mm256_cmpeq_epi16(H[v], want), valid[v]);
                uint32_t mm = (uint32_t)_mm256_movemask_epi8(eq);
                if (mm) {
                    q_end = v * 16 + (__builtin_ctz(mm) >> 1);
                    break;
                }
            }
        }
    }
    out[0] = best;
    out[1] = t_end;
    out[2] = q_end;
}

#else
int sw_simd_supported(void) { return 0; }
void sw_forward_i16(const int32_t *prof, int64_t stride, int32_t lq,
                    int32_t A,
                    const uint8_t *tseq, int64_t lt,
                    int32_t gap_open, int32_t gap_extend, int32_t reverse,
                    int64_t *out) {
    (void)prof; (void)stride; (void)lq; (void)A; (void)tseq; (void)lt;
    (void)gap_open; (void)gap_extend; (void)reverse; (void)out;
}
#endif

/* prof: per-letter query profile rows, prof + a*stride, int32, length lq
 * (already includes the int8 composition bias).
 * reverse=1 flips both axes (prefix-rectangle reverse pass): row i reads
 * tseq[lt-1-i], column j reads prof column lq-1-j; outputs stay in the
 * reversed frame, matching _forward_pass(sub_rev). */
void sw_forward(const int32_t *prof, int64_t stride, int32_t lq,
                const uint8_t *tseq, int64_t lt,
                int32_t gap_open, int32_t gap_extend, int32_t reverse,
                int64_t *out /* best, t_end, q_end */) {
    int32_t stackH[512], stackE[512];
    int32_t *H = stackH, *E = stackE;
    if (lq > 512) {
        H = (int32_t *)malloc(sizeof(int32_t) * lq);
        E = (int32_t *)malloc(sizeof(int32_t) * lq);
    }
    memset(H, 0, sizeof(int32_t) * lq);
    memset(E, 0, sizeof(int32_t) * lq);
    int32_t best = 0;
    int64_t t_end = -1;
    int32_t q_end = lq - 1;
    for (int64_t i = 0; i < lt; i++) {
        uint8_t c = tseq[reverse ? (lt - 1 - i) : i];
        const int32_t *prow = prof + (int64_t)c * stride;
        int32_t hdiag = 0;
        int64_t F = NEG_F;
        int32_t rowmax = -1;
        int32_t rowarg = -1;
        if (reverse) {
            for (int32_t j = 0; j < lq; j++) {
                int32_t hp = hdiag + prow[lq - 1 - j];
                if (hp < 0) hp = 0;
                if (E[j] > hp) hp = E[j];
                int32_t e1 = hp - gap_open, e2 = E[j] - gap_extend;
                int32_t en = e1 > e2 ? e1 : e2;
                if (en < 0) en = 0;
                hdiag = H[j];
                E[j] = en;
                int32_t h = hp;
                if (F > h) h = (int32_t)F;
                int64_t f2 = (int64_t)hp - gap_open;
                F -= gap_extend;
                if (f2 > F) F = f2;
                H[j] = h;
                if (h > rowmax) { rowmax = h; rowarg = j; }
            }
        } else {
            for (int32_t j = 0; j < lq; j++) {
                int32_t hp = hdiag + prow[j];
                if (hp < 0) hp = 0;
                if (E[j] > hp) hp = E[j];
                int32_t e1 = hp - gap_open, e2 = E[j] - gap_extend;
                int32_t en = e1 > e2 ? e1 : e2;
                if (en < 0) en = 0;
                hdiag = H[j];
                E[j] = en;
                int32_t h = hp;
                if (F > h) h = (int32_t)F;
                int64_t f2 = (int64_t)hp - gap_open;
                F -= gap_extend;
                if (f2 > F) F = f2;
                H[j] = h;
                if (h > rowmax) { rowmax = h; rowarg = j; }
            }
        }
        if (rowmax > best) { best = rowmax; t_end = i; q_end = rowarg; }
    }
    out[0] = best;
    out[1] = t_end;
    out[2] = q_end;
    if (H != stackH) { free(H); free(E); }
}

/* Scores-only batch: one query profile vs n concatenated targets
 * (tcat, offsets t_off[n+1]); fills out_score[n]. */
void sw_forward_batch(const int32_t *prof, int64_t stride, int32_t lq,
                      const uint8_t *tcat, const int64_t *t_off, int64_t n,
                      int32_t gap_open, int32_t gap_extend,
                      int32_t *out_score) {
    int64_t out[3];
    for (int64_t b = 0; b < n; b++) {
        sw_forward(prof, stride, lq, tcat + t_off[b],
                   t_off[b + 1] - t_off[b], gap_open, gap_extend, 0, out);
        out_score[b] = (int32_t)out[0];
    }
}

/* Gather byte ranges: out = concat(big[starts[i] : starts[i]+lens[i]]).
 * (The host VM pays heavily for large NumPy index temporaries; a memcpy
 * loop touches only the 1-byte payload.) */
void gather_ranges(const uint8_t *big, const int64_t *starts,
                   const int64_t *lens, int64_t n, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        memcpy(out, big + starts[i], (size_t)lens[i]);
        out += lens[i];
    }
}

/* Codon-order reversal per piece (ReverseSeqByCodon semantics; every
 * piece length is a multiple of 3). */
void reverse_codons_ranges(const uint8_t *flat, const int64_t *offsets,
                           int64_t n, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *src = flat + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        uint8_t *dst = out + offsets[i];
        for (int64_t c = 0; c < len; c += 3) {
            int64_t s = len - 3 - c;
            dst[c] = src[s];
            dst[c + 1] = src[s + 1];
            dst[c + 2] = src[s + 2];
        }
    }
}

/* Batched codon translation: flat in-frame ASCII nucleotides -> ASCII
 * amino acids via the 4096-entry IUPAC-code LUT, with TranslateNucl's
 * lowercase propagation (any lowercase base -> lowercase residue).
 * Mirrors ops.translate.translate_batch. */
void translate_flat(const uint8_t *nucl, int64_t n_nucl,
                    const uint8_t *iupac_lut /*256*/,
                    const uint8_t *aa_lut /*4096*/,
                    uint8_t *out_aa) {
    int64_t n_cod = n_nucl / 3;
    for (int64_t c = 0; c < n_cod; c++) {
        const uint8_t *p = nucl + 3 * c;
        uint8_t aa = aa_lut[(iupac_lut[p[0]] << 8)
                            | (iupac_lut[p[1]] << 4) | iupac_lut[p[2]]];
        int lower = (p[0] >= 'a' && p[0] <= 'z')
                 || (p[1] >= 'a' && p[1] <= 'z')
                 || (p[2] >= 'a' && p[2] <= 'z');
        if (lower && aa >= 'A' && aa <= 'Z')
            aa += 32;
        out_aa[c] = aa;
    }
}

/* Six-frame ORF scan over one strand (3 forward frames), replicating
 * ops.orf._find_frames_one_strand segment semantics exactly:
 * segments between stop codons (stop excluded), start-codon selection
 * per start_mode (0 START_TO_STOP first-start, 1 ANY_TO_STOP,
 * 2 LAST_START_TO_STOP), first fragment per frame starts inside,
 * trailing fragment flagged incomplete-end, length/gap filters.
 * Output is merged across frames by emit position (stable in frame
 * order), the order the reference's single position loop produces.
 * Returns the ORF count; caller provides arrays of capacity L. */
typedef struct {
    int64_t emit, from, to, len;
    uint8_t inc_s, inc_e;
} orf_rec_t;

int64_t find_orfs_strand(const uint8_t *seq, int64_t L,
                         const uint8_t *cls_tab /*256: TCAG class, 4=other*/,
                         const uint8_t *stop_lut /*125*/,
                         const uint8_t *start_lut /*125*/,
                         const uint8_t *gappy_tab /*256*/,
                         int64_t min_len, int64_t max_len, int64_t max_gaps,
                         int32_t start_mode,
                         int64_t *out_emit, int64_t *out_from,
                         int64_t *out_to, uint8_t *out_incs,
                         uint8_t *out_ince, int64_t *out_len) {
    if (min_len < 1) min_len = 1;
    orf_rec_t *fr[3];
    int64_t fn[3] = {0, 0, 0};
    int64_t cap = L / 3 + 4;
    for (int f = 0; f < 3; f++)
        fr[f] = (orf_rec_t *)malloc(sizeof(orf_rec_t) * cap);
    int64_t *gap_cum = (int64_t *)malloc(sizeof(int64_t) * (L / 3 + 2));

    for (int f = 0; f < 3; f++) {
        int64_t n = (L - f) / 3;
        if (n <= 0) continue;
        orf_rec_t *recs = fr[f];
        int64_t cnt = 0;
        /* per-codon classes + gap prefix */
        gap_cum[0] = 0;
        int64_t seg_start = 0;      /* codon idx of current segment start */
        int first_seg = 1;
        int64_t first_start = -1, last_start = -1;
        for (int64_t c = 0; c <= n; c++) {
            int is_stop = 0;
            if (c < n) {
                const uint8_t *p = seq + f + 3 * c;
                uint8_t b0 = p[0] & 0xDF, b1 = p[1] & 0xDF, b2 = p[2] & 0xDF;
                int cls125 = cls_tab[b0] * 25 + cls_tab[b1] * 5 + cls_tab[b2];
                gap_cum[c + 1] = gap_cum[c]
                    + (gappy_tab[b0] | gappy_tab[b1] | gappy_tab[b2] ? 1 : 0);
                is_stop = stop_lut[cls125];
                if (!is_stop && start_lut[cls125]) {
                    if (first_start < 0) first_start = c;
                    last_start = c;
                }
                if (!is_stop) continue;
            } else {
                /* trailing segment; empty when last codon was a stop */
                if (seg_start >= n) break;
            }
            int64_t seg_stop = (c < n) ? c : n;   /* exclusive of stop */
            int ends_with_stop = (c < n);
            /* select fragment start per mode */
            int64_t frag = -1;
            uint8_t inc_s = 0;
            if (start_mode == 1) {              /* ANY_TO_STOP */
                frag = seg_start;
                inc_s = first_seg ? 1 : 0;
            } else if (start_mode == 0) {       /* START_TO_STOP */
                if (first_seg) { frag = 0; inc_s = 1; }
                else if (first_start >= 0) frag = first_start;
            } else {                            /* LAST_START_TO_STOP */
                if (last_start >= 0) frag = last_start;
                else if (first_seg) { frag = 0; inc_s = 1; }
            }
            if (frag >= 0) {
                int64_t len = seg_stop - frag;
                int64_t gaps = gap_cum[seg_stop] - gap_cum[frag];
                if (len >= min_len && len <= max_len && gaps <= max_gaps) {
                    orf_rec_t *r = &recs[cnt++];
                    r->len = len;
                    r->from = f + 3 * frag;
                    r->inc_s = inc_s;
                    if (ends_with_stop) {
                        r->emit = f + 3 * seg_stop;
                        r->to = r->emit - 1;
                        r->inc_e = 0;
                    } else {
                        r->emit = f + 3 * (seg_stop - 1);
                        r->to = r->emit + 2;
                        r->inc_e = 1;
                    }
                }
            }
            seg_start = seg_stop + 1;
            first_seg = 0;
            first_start = -1;
            last_start = -1;
        }
        fn[f] = cnt;
    }

    /* stable 3-way merge by emit (frame order breaks ties) */
    int64_t idx[3] = {0, 0, 0};
    int64_t out_n = 0;
    for (;;) {
        int best = -1;
        int64_t best_emit = 0;
        for (int f = 0; f < 3; f++) {
            if (idx[f] < fn[f]) {
                int64_t e = fr[f][idx[f]].emit;
                if (best < 0 || e < best_emit) { best = f; best_emit = e; }
            }
        }
        if (best < 0) break;
        orf_rec_t *r = &fr[best][idx[best]++];
        out_emit[out_n] = r->emit;
        out_from[out_n] = r->from;
        out_to[out_n] = r->to;
        out_incs[out_n] = r->inc_s;
        out_ince[out_n] = r->inc_e;
        out_len[out_n] = r->len;
        out_n++;
    }
    for (int f = 0; f < 3; f++) free(fr[f]);
    free(gap_cum);
    return out_n;
}

typedef struct {
    int32_t code;
    int32_t seq;
    int32_t pos;
} posting_t;

/* Spaced k-mer postings: scan the concatenated masked sequences
 * (flat, boundaries seq_starts[n+1], no separators — windows never
 * cross a boundary), emit one (code, seq, first-pos) record per
 * (seq, code), sorted by (code, seq). Returns the record count; caller
 * provides out arrays of capacity n_flat. Order parity: records are
 * generated seq-major with ascending positions, then stably
 * radix-sorted by code, so equal-code runs stay seq-ordered and the
 * first record per (code, seq) carries the minimal position —
 * identical to the NumPy construction. */
typedef struct {
    const uint8_t *flat;
    const int32_t *offsets;
    int32_t k, span, kmer_thr, x_idx;
    const int64_t *seq_starts;
    const int32_t *self_scores;
    int64_t seq_lo, seq_hi;   /* sequence range for this worker */
    posting_t *out;           /* segment base */
    int64_t cnt;              /* records produced */
} scan_job_t;

static void *postings_scan_worker(void *arg) {
    scan_job_t *j = (scan_job_t *)arg;
    const int32_t k = j->k, span = j->span;
    posting_t *rec = j->out;
    int64_t cnt = 0;
    for (int64_t s = j->seq_lo; s < j->seq_hi; s++) {
        const uint8_t *seq = j->flat + j->seq_starts[s];
        int64_t n_win = (j->seq_starts[s + 1] - j->seq_starts[s]) - span + 1;
        for (int64_t p = 0; p < n_win; p++) {
            int64_t code = 0;
            int32_t self = 0;
            int valid = 1;
            for (int32_t o = 0; o < k; o++) {
                uint8_t c = seq[p + j->offsets[o]];
                if (c == j->x_idx) { valid = 0; break; }
                code = code * 20 + c;
                self += j->self_scores[c];
            }
            if (valid && self >= j->kmer_thr) {
                rec[cnt].code = (int32_t)code;
                rec[cnt].seq = (int32_t)s;
                rec[cnt].pos = (int32_t)p;
                cnt++;
            }
        }
    }
    j->cnt = cnt;
    return NULL;
}

int64_t build_postings(const uint8_t *flat, int64_t n_flat,
                       const int32_t *offsets, int32_t k, int32_t span,
                       const int64_t *seq_starts, int64_t n_seqs,
                       const int32_t *self_scores, int32_t kmer_thr,
                       int32_t x_idx,
                       int32_t *out_code, int32_t *out_seq,
                       int32_t *out_pos) {
    if (n_flat < span || n_seqs <= 0) return 0;

    /* scan in parallel: worker w writes into its own segment of the
     * worst-case buffer (segment base = first window of its range), so
     * records stay in seq-major order segment by segment */
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    int nw = ncpu > 1 ? (ncpu > 4 ? 4 : (int)ncpu) : 1;
    if (n_seqs < nw) nw = 1;
    posting_t *rec = (posting_t *)malloc(sizeof(posting_t) * n_flat);
    scan_job_t jobs[4];
    int64_t seg_base[4];
    {
        /* split sequences by residue mass */
        int64_t total = seq_starts[n_seqs];
        int64_t lo = 0;
        for (int w = 0; w < nw; w++) {
            int64_t target = total * (w + 1) / nw;
            int64_t hi = lo;
            while (hi < n_seqs && seq_starts[hi] < target) hi++;
            if (w == nw - 1) hi = n_seqs;
            jobs[w] = (scan_job_t){flat, offsets, k, span, kmer_thr, x_idx,
                                   seq_starts, self_scores, lo, hi, NULL, 0};
            /* worst case for range = residues in range */
            seg_base[w] = seq_starts[lo];
            jobs[w].out = rec + seg_base[w];
            lo = hi;
        }
    }
    pthread_t tids[4];
    int spawned = 0;
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[w - 1], NULL, postings_scan_worker,
                           &jobs[w]) == 0)
            spawned++;
    postings_scan_worker(&jobs[0]);
    for (int t = 0; t < spawned; t++)
        pthread_join(tids[t], NULL);

    int64_t cnt = 0;
    for (int w = 0; w < nw; w++) cnt += jobs[w].cnt;
    if (cnt == 0) { free(rec); return 0; }

    /* stable LSD radix sort by code: 2 passes x 16 bits; the first
     * pass reads the per-worker segments in order (seq-major) */
    posting_t *aux = (posting_t *)malloc(sizeof(posting_t) * cnt);
    static const int32_t RAD = 1 << 16, MASK = (1 << 16) - 1;
    int64_t *count = (int64_t *)malloc(sizeof(int64_t) * RAD);

    memset(count, 0, sizeof(int64_t) * RAD);
    for (int w = 0; w < nw; w++) {
        posting_t *seg = rec + seg_base[w];
        for (int64_t i = 0; i < jobs[w].cnt; i++)
            count[seg[i].code & MASK]++;
    }
    int64_t sum = 0;
    for (int32_t v = 0; v < RAD; v++) {
        int64_t c = count[v];
        count[v] = sum;
        sum += c;
    }
    for (int w = 0; w < nw; w++) {
        posting_t *seg = rec + seg_base[w];
        for (int64_t i = 0; i < jobs[w].cnt; i++)
            aux[count[seg[i].code & MASK]++] = seg[i];
    }

    memset(count, 0, sizeof(int64_t) * RAD);
    for (int64_t i = 0; i < cnt; i++)
        count[(aux[i].code >> 16) & MASK]++;
    sum = 0;
    for (int32_t v = 0; v < RAD; v++) {
        int64_t c = count[v];
        count[v] = sum;
        sum += c;
    }
    for (int64_t i = 0; i < cnt; i++)
        rec[count[(aux[i].code >> 16) & MASK]++] = aux[i];
    free(count);

    /* dedup consecutive (code, seq), keep first (minimal pos) */
    int64_t out_n = 0;
    for (int64_t i = 0; i < cnt; i++) {
        if (i > 0 && rec[i].code == rec[i - 1].code
                  && rec[i].seq == rec[i - 1].seq)
            continue;
        out_code[out_n] = rec[i].code;
        out_seq[out_n] = rec[i].seq;
        out_pos[out_n] = rec[i].pos;
        out_n++;
    }
    free(rec);
    free(aux);
    return out_n;
}

/* ---- prefilter finalize: duplicate filter + diagonal rescore ----
 *
 * Replicates ops.prefilter.prefilter_query's tail exactly (the
 * double-diagonal filter of CacheFriendlyOperations::findDuplicates,
 * lib/mmseqs/src/prefiltering/CacheFriendlyOperations.cpp:146-225,
 * including the cross-bin slot-state leak, plus the per-(target,
 * diagonal) ungapped rescore of UngappedAlignment and the
 * histogram/max_seqs threshold of QueryMatcher.h:199-209).
 *
 * Inputs: the per-query match stream (m_t, m_d16) in reference stream
 * order (k-mer position asc, similar-kmer enumeration order, postings
 * order). Outputs hit rows (target, score, signed diagonal) sorted by
 * (score desc, target asc), truncated to max_seqs. Returns the count.
 */

static int32_t diag_segment_max(const int32_t *prof, int32_t lq, int32_t A,
                                const uint8_t *t, int64_t lt, int32_t d) {
    int64_t qs, ts, ln;
    if (d >= 0) {
        if (d >= lq) return 0;
        qs = d; ts = 0;
        ln = lt < (int64_t)(lq - d) ? lt : (int64_t)(lq - d);
    } else {
        int64_t md = -(int64_t)d;
        if (md >= lt) return 0;
        qs = 0; ts = md;
        ln = (lt - md) < (int64_t)lq ? (lt - md) : (int64_t)lq;
    }
    int64_t run = 0, best = 0;
    const uint8_t *tp = t + ts;
    const int32_t *pp = prof + qs * A;
    for (int64_t i = 0; i < ln; i++) {
        run += pp[i * A + tp[i]];
        if (run < 0) run = 0;
        else if (run > best) best = run;
    }
    return (int32_t)best;
}

typedef struct { int32_t t, capped, exact, d_signed; int64_t win; } pref_hit_t;

static int pref_hit_cmp(const void *a, const void *b) {
    const pref_hit_t *x = (const pref_hit_t *)a, *y = (const pref_hit_t *)b;
    if (x->exact != y->exact) return (x->exact < y->exact) ? 1 : -1;
    return (x->t > y->t) - (x->t < y->t);
}

/* The max_seqs truncation order: the reference's stable radix sorts
 * by CAPPED u8 score with the match-stream order preserved within a
 * score bucket (radixSortByScoreSize appends in input order;
 * QueryMatcher.cpp:459-481), and getResult cuts at maxHitsPerQuery
 * over that order — so ties at the threshold survive by the WINNING
 * entry's position in the bin-major emit stream, not by target id. */
static int pref_trunc_cmp(const void *a, const void *b) {
    const pref_hit_t *x = (const pref_hit_t *)a, *y = (const pref_hit_t *)b;
    if (x->capped != y->capped) return (x->capped < y->capped) ? 1 : -1;
    return (x->win > y->win) - (x->win < y->win);
}

static int cmp_int64(const void *a, const void *b) {
    int64_t x = *(const int64_t *)a, y = *(const int64_t *)b;
    return (x > y) - (x < y);
}

/* Per-thread reusable scratch: the finalize runs once per query ORF
 * (370k+ calls at catalog scale); fresh malloc/calloc per call made
 * first-touch page faults the dominant cost on hypervisor-backed RAM
 * (CLAUDE.md). The slot array is zeroed lazily: only slots touched by
 * THIS query's stream are reset at the end of the call (every return
 * after the slots are first written comes after that reset, so they are
 * all zero between calls). A thread that is done with the finalize frees
 * its scratch with prefilter_finalize_release(); the batch workers do so
 * before they exit. */
typedef struct {
    int64_t *bin_off;   /* [n_bins+1] */
    int64_t *cur;       /* [n_bins] */
    int32_t *s_t;
    uint16_t *s_d;
    int64_t *kept;
    int32_t *emit_t;
    uint16_t *emit_d;
    int64_t *emit_idx;
    int64_t cap_matches;
    uint8_t *slots;
    int64_t cap_slots;
    int64_t *keys;
    pref_hit_t *hits;
    int64_t cap_emit;
} pf_fin_ws_t;

static __thread pf_fin_ws_t g_fin_ws;
/* threads whose scratch is allocated and not yet released */
static int64_t g_fin_ws_live = 0;

void prefilter_finalize_release(void) {
    pf_fin_ws_t *ws = &g_fin_ws;
    if (!ws->bin_off && !ws->cur)
        return;
    free(ws->bin_off); free(ws->cur);
    free(ws->s_t); free(ws->s_d); free(ws->kept);
    free(ws->emit_t); free(ws->emit_d); free(ws->emit_idx);
    free(ws->slots); free(ws->keys); free(ws->hits);
    memset(ws, 0, sizeof(*ws));
    __atomic_fetch_sub(&g_fin_ws_live, 1, __ATOMIC_RELAXED);
}

int64_t prefilter_finalize_live(void) {
    return __atomic_load_n(&g_fin_ws_live, __ATOMIC_RELAXED);
}

static void *fin_grow(void **p, int64_t *cap, int64_t n, size_t elem) {
    if (n > *cap) {
        int64_t nc = *cap ? *cap : 4096;
        while (nc < n) nc *= 2;
        void *np = realloc(*p, (size_t)nc * elem);
        if (!np)
            return NULL;
        *p = np;
        *cap = nc;
    }
    return *p;
}

int64_t prefilter_finalize(
    const int32_t *m_t, const uint16_t *m_d, int64_t n_matches,
    int32_t bin_bits,
    const uint8_t *flat_masked, const int64_t *t_starts, int64_t n_targets,
    const int32_t *profile, int32_t lq, int32_t A,
    const uint8_t *q_num,
    int32_t cap, int32_t min_diag_score, int32_t max_seqs,
    int32_t *out_t, int32_t *out_score, int32_t *out_diag) {
    if (n_matches == 0) return 0;
    int64_t n_bins = (int64_t)1 << bin_bits;
    int32_t bin_mask = (int32_t)(n_bins - 1);
    int64_t n_slots = (n_targets >> bin_bits) + 2;

    pf_fin_ws_t *ws = &g_fin_ws;
    if (n_bins + 1 > 4096) return -1;   /* bin_bits <= 11 always */
    if (!ws->bin_off) {
        if (!ws->cur)
            __atomic_fetch_add(&g_fin_ws_live, 1, __ATOMIC_RELAXED);
        ws->bin_off = (int64_t *)malloc(4096 * sizeof(int64_t));
        if (!ws->cur)
            ws->cur = (int64_t *)malloc(4096 * sizeof(int64_t));
        if (!ws->bin_off || !ws->cur)
            return -1;
    }
    int64_t cm = ws->cap_matches;
    int32_t *s_t = (int32_t *)fin_grow((void **)&ws->s_t, &cm,
                                       n_matches, sizeof(int32_t));
    cm = ws->cap_matches;
    uint16_t *s_d = (uint16_t *)fin_grow((void **)&ws->s_d, &cm,
                                         n_matches, sizeof(uint16_t));
    cm = ws->cap_matches;
    int64_t *kept = (int64_t *)fin_grow((void **)&ws->kept, &cm,
                                        n_matches, sizeof(int64_t));
    cm = ws->cap_matches;
    int32_t *emit_t = (int32_t *)fin_grow((void **)&ws->emit_t, &cm,
                                          n_matches, sizeof(int32_t));
    cm = ws->cap_matches;
    uint16_t *emit_d = (uint16_t *)fin_grow((void **)&ws->emit_d, &cm,
                                            n_matches, sizeof(uint16_t));
    cm = ws->cap_matches;
    int64_t *emit_idx = (int64_t *)fin_grow((void **)&ws->emit_idx, &cm,
                                            n_matches, sizeof(int64_t));
    ws->cap_matches = cm;
    uint8_t *slots;
    if (n_slots > ws->cap_slots) {
        free(ws->slots);
        ws->slots = (uint8_t *)calloc((size_t)n_slots * 2, 1);
        ws->cap_slots = ws->slots ? n_slots * 2 : 0;
    }
    slots = ws->slots;
    int64_t *bin_off = ws->bin_off;
    memset(bin_off, 0, (size_t)(n_bins + 1) * sizeof(int64_t));
    if (!s_t || !s_d || !kept || !emit_t || !emit_d
        || !emit_idx || !slots) {
        return -1;
    }
    for (int64_t i = 0; i < n_matches; i++)
        bin_off[(m_t[i] & bin_mask) + 1]++;
    for (int64_t b = 0; b < n_bins; b++)
        bin_off[b + 1] += bin_off[b];
    {
        int64_t *cur = ws->cur;
        memcpy(cur, bin_off, (size_t)n_bins * sizeof(int64_t));
        for (int64_t i = 0; i < n_matches; i++) {
            int64_t p = cur[m_t[i] & bin_mask]++;
            s_t[p] = m_t[i];
            s_d[p] = m_d[i];
        }
    }

    int64_t n_emit = 0;
    for (int64_t b = 0; b < n_bins; b++) {
        int64_t lo = bin_off[b], hi = bin_off[b + 1];
        if (lo == hi) continue;
        /* stage A: keep iff slot state equals d8; always update state */
        int64_t nk = 0;
        for (int64_t i = lo; i < hi; i++) {
            int64_t slot = (int64_t)s_t[i] >> bin_bits;
            uint8_t d8 = (uint8_t)s_d[i];
            if (slots[slot] == d8) kept[nk++] = i;
            slots[slot] = d8;
        }
        /* stage B: reverse pass seeds slot = first-kept d8 + 1 */
        for (int64_t k = nk - 1; k >= 0; k--) {
            int64_t i = kept[k];
            slots[(int64_t)s_t[i] >> bin_bits] = (uint8_t)(s_d[i] + 1);
        }
        /* stage C: drop consecutive same-diagonal duplicates per slot */
        for (int64_t k = 0; k < nk; k++) {
            int64_t i = kept[k];
            int64_t slot = (int64_t)s_t[i] >> bin_bits;
            uint8_t d8 = (uint8_t)s_d[i];
            if (slots[slot] != d8) {
                emit_t[n_emit] = s_t[i];
                emit_d[n_emit] = s_d[i];
                emit_idx[n_emit] = n_emit;
                n_emit++;
            }
            slots[slot] = d8;
        }
    }
    /* reset ONLY the slots this stream touched (the lazy-zero
     * contract of the reusable scratch) */
    for (int64_t i = 0; i < n_matches; i++)
        slots[(int64_t)s_t[i] >> bin_bits] = 0;

    /* group emits by target, preserving emit order within a target:
     * stable sort on composite key (target << 32) | emit_position.
     * A target lives in exactly one bin, so its emits are already
     * contiguous in ONE bin's stage-C order; the composite sort just
     * gathers its run while keeping that order. */
    int64_t n_hits = 0;
    if (n_emit) {
        int64_t ce = ws->cap_emit;
        int64_t *keys = (int64_t *)fin_grow((void **)&ws->keys, &ce,
                                            n_emit, sizeof(int64_t));
        ce = ws->cap_emit;
        pref_hit_t *hits = (pref_hit_t *)fin_grow(
            (void **)&ws->hits, &ce, n_emit, sizeof(pref_hit_t));
        ws->cap_emit = ce;
        int64_t hist[256];
        memset(hist, 0, sizeof(hist));
        if (!keys || !hits) {
            return -1;
        }
        for (int64_t i = 0; i < n_emit; i++)
            keys[i] = ((int64_t)emit_t[i] << 32) | (int64_t)i;
        qsort(keys, (size_t)n_emit, sizeof(int64_t), cmp_int64);

        int64_t i = 0, nh = 0;
        while (i < n_emit) {
            int32_t t = (int32_t)(keys[i] >> 32);
            const uint8_t *tseq = flat_masked + t_starts[t];
            int64_t lt = t_starts[t + 1] - t_starts[t];
            int32_t best = -1, best_exact = 0;
            uint16_t best_d = 0;
            int64_t best_win = 0;
            for (; i < n_emit && (int32_t)(keys[i] >> 32) == t; i++) {
                int64_t pos = (int64_t)(keys[i] & 0xFFFFFFFF);
                uint16_t d16 = emit_d[pos];
                int32_t d = (d16 >= 32768) ? (int32_t)d16 - 65536
                                           : (int32_t)d16;
                int32_t sc = diag_segment_max(profile, lq, A, tseq, lt, d);
                int32_t sc_cap = sc < cap ? sc : cap;
                if (sc_cap > best) {
                    best = sc_cap;
                    best_d = d16;
                    best_exact = sc;
                    best_win = pos;
                }
            }
            hits[nh].win = best_win;
            hits[nh].t = t;
            hits[nh].capped = best;
            /* saturated entries report the exact rescoring
             * (QueryMatcher.cpp:371-373 getResult escape) */
            hits[nh].exact = (best >= cap) ? best_exact : best;
            hits[nh].d_signed = (best_d >= 32768) ? (int32_t)best_d - 65536
                                                  : (int32_t)best_d;
            hist[best < 255 ? best : 255]++;
            nh++;
        }

        /* threshold: scan 255->1 accumulating counts (QueryMatcher.h:199) */
        int64_t found = 0;
        int32_t thr = 0;
        for (int32_t s = 255; s > 0; s--) {
            found += hist[s];
            if (found >= max_seqs) { thr = s; break; }
        }
        if (thr < min_diag_score) thr = min_diag_score;

        int64_t no = 0;
        for (int64_t h = 0; h < nh; h++) {
            if (hits[h].capped < thr) continue;
            hits[no++] = hits[h];
        }
        if (thr >= cap && q_num != NULL) {
            /* scoreIsTruncated branch (QueryMatcher.cpp:146-155):
             * every survivor is exactly rescored, rescaled against
             * the query's ungapped self score into a u8
             * (rescoreHits), selected in (rescaled desc, stream
             * order) and emitted as the quantized reconstruction
             * cap + count*maxSelf/255 (getResult escape). */
            int32_t self_sc = diag_segment_max(profile, lq, A,
                                               q_num, lq, 0);
            int32_t max_self = self_sc - cap;
            if (max_self < 1) max_self = 1;
            if (max_self > 65535) max_self = 65535;
            for (int64_t h = 0; h < no; h++) {
                uint32_t ns = (uint32_t)(hits[h].exact - cap);
                float score_f = (float)(ns < 65535u ? ns : 65535u);
                double val = (double)(score_f / (float)max_self
                                      * 255.0f) + 0.5;
                hits[h].capped = (int32_t)((uint8_t)(uint32_t)val);
                hits[h].exact = cap
                    + (int32_t)((uint32_t)hits[h].capped
                                * (uint32_t)max_self / 255u);
            }
            qsort(hits, (size_t)no, sizeof(pref_hit_t), pref_trunc_cmp);
            if (no > max_seqs) no = max_seqs;
            qsort(hits, (size_t)no, sizeof(pref_hit_t), pref_hit_cmp);
            for (int64_t h = 0; h < no; h++) {
                out_t[h] = hits[h].t;
                out_score[h] = hits[h].exact;
                out_diag[h] = hits[h].d_signed;
            }
            return no;
        }
        /* truncate in the reference's radix order (capped score desc,
         * winning-entry stream position), THEN sort the survivors by
         * (exact score desc, target) — compareHitsByScoreAndId */
        if (no > max_seqs) {
            qsort(hits, (size_t)no, sizeof(pref_hit_t), pref_trunc_cmp);
            no = max_seqs;
        }
        qsort(hits, (size_t)no, sizeof(pref_hit_t), pref_hit_cmp);
        for (int64_t h = 0; h < no; h++) {
            out_t[h] = hits[h].t;
            out_score[h] = hits[h].exact;
            out_diag[h] = hits[h].d_signed;
        }
        n_hits = no;
    }
    return n_hits;
}

/* ---- build_postings_v2: packed-u64 parallel counting sort ----
 *
 * Same output contract as build_postings (the CSR k-mer index of
 * IndexTable.h:25-38 as (code, seq, first-pos) triples in (code, seq)
 * order) but engineered for hosts with expensive first-touch: records
 * pack into one u64 (code 26b | seq 21b | pos 16b), buffers come from
 * mmap with MADV_HUGEPAGE, the k-mer scan runs twice (count + emit,
 * the scan is cheap) so every buffer is exact-size, and both radix
 * scatter passes are multi-threaded counting sorts with per-worker
 * bucket offsets. Caller must guarantee n_seqs < 2^21 and every
 * sequence length <= 65535 (ORFs are capped at 32734 upstream,
 * Search.cpp:27). */

#include <sys/mman.h>

#ifndef MADV_HUGEPAGE
#define MADV_HUGEPAGE 14
#endif

static void *big_alloc(size_t n) {
    size_t sz = (n + 4095) & ~(size_t)4095;
    void *p = mmap(NULL, sz, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return NULL;
    if (sz >= (1u << 21)) madvise(p, sz, MADV_HUGEPAGE);
    return p;
}

static void big_free(void *p, size_t n) {
    if (p) munmap(p, (n + 4095) & ~(size_t)4095);
}

#define PK_RADIX_BITS 13
#define PK_NBUCKET (1 << PK_RADIX_BITS)
#define PK_MAXW 4

typedef struct {
    const uint8_t *flat;
    const int32_t *offsets;
    int32_t k, span, kmer_thr, x_idx;
    const int64_t *seq_starts;
    const int32_t *self_scores;
    int64_t seq_lo, seq_hi;
    /* phase 0: count only; phase 1: emit with per-bucket cursors */
    int phase;
    int64_t cnt;
    int64_t hist[PK_NBUCKET];     /* digit1 = bits 37..49 histogram */
    int64_t *cursor;              /* [PK_NBUCKET] scatter cursors (phase 1) */
    uint64_t *out;
} pk_scan_job_t;

static void *pk_scan_worker(void *arg) {
    pk_scan_job_t *j = (pk_scan_job_t *)arg;
    const int32_t k = j->k, span = j->span;
    int64_t cnt = 0;
    for (int64_t s = j->seq_lo; s < j->seq_hi; s++) {
        const uint8_t *seq = j->flat + j->seq_starts[s];
        int64_t n_win = (j->seq_starts[s + 1] - j->seq_starts[s]) - span + 1;
        for (int64_t p = 0; p < n_win; p++) {
            int64_t code = 0;
            int32_t self = 0;
            int valid = 1;
            for (int32_t o = 0; o < k; o++) {
                uint8_t c = seq[p + j->offsets[o]];
                if (c == j->x_idx) { valid = 0; break; }
                code = code * 20 + c;
                self += j->self_scores[c];
            }
            if (valid && self >= j->kmer_thr) {
                uint64_t key = ((uint64_t)code << 37)
                             | ((uint64_t)s << 16) | (uint64_t)p;
                int32_t d1 = (int32_t)((key >> 37) & (PK_NBUCKET - 1));
                if (j->phase == 0) {
                    j->hist[d1]++;
                } else {
                    j->out[j->cursor[d1]++] = key;
                }
                cnt++;
            }
        }
    }
    j->cnt = cnt;
    return NULL;
}

typedef struct {
    const uint64_t *in;
    int64_t lo, hi;
    int shift;                    /* digit = (key >> shift) & mask */
    int phase;
    int64_t hist[PK_NBUCKET];
    int64_t *cursor;
    uint64_t *out;
} pk_scatter_job_t;

static void *pk_scatter_worker(void *arg) {
    pk_scatter_job_t *j = (pk_scatter_job_t *)arg;
    const uint64_t *in = j->in;
    const int shift = j->shift;
    if (j->phase == 0) {
        for (int64_t i = j->lo; i < j->hi; i++)
            j->hist[(in[i] >> shift) & (PK_NBUCKET - 1)]++;
    } else {
        for (int64_t i = j->lo; i < j->hi; i++)
            j->out[j->cursor[(in[i] >> shift) & (PK_NBUCKET - 1)]++] = in[i];
    }
    return NULL;
}

/* exclusive scan over [bucket][worker] counts -> per-worker cursors */
static void pk_layout(int64_t (*hists)[PK_NBUCKET], int64_t (*cursors)[PK_NBUCKET],
                      int nw) {
    int64_t sum = 0;
    for (int32_t b = 0; b < PK_NBUCKET; b++) {
        for (int w = 0; w < nw; w++) {
            cursors[w][b] = sum;
            sum += hists[w][b];
        }
    }
}

/* Grow-only scratch arena: first-touch page faults on this class of
 * hypervisor-backed VM cost 8-20 s/GB nondeterministically, an order of
 * magnitude over the sort itself, so the two radix buffers persist
 * across calls (easy-predict builds two indexes back to back). */
static uint64_t *pk_arena[2] = {NULL, NULL};
static size_t pk_arena_cap = 0;

void postings_free_arena(void) {
    big_free(pk_arena[0], pk_arena_cap);
    big_free(pk_arena[1], pk_arena_cap);
    pk_arena[0] = pk_arena[1] = NULL;
    pk_arena_cap = 0;
}

static int pk_arena_reserve(size_t bytes) {
    if (bytes <= pk_arena_cap && pk_arena[0]) return 1;
    postings_free_arena();
    pk_arena[0] = (uint64_t *)big_alloc(bytes);
    pk_arena[1] = (uint64_t *)big_alloc(bytes);
    if (!pk_arena[0] || !pk_arena[1]) { postings_free_arena(); return 0; }
    pk_arena_cap = bytes;
    return 1;
}

int64_t build_postings_v3(const uint8_t *flat, int64_t n_flat,
                          const int32_t *offsets, int32_t k, int32_t span,
                          const int64_t *seq_starts, int64_t n_seqs,
                          const int32_t *self_scores, int32_t kmer_thr,
                          int32_t x_idx,
                          int32_t *out_code, int32_t *out_seq,
                          int32_t *out_pos,
                          int64_t *out_uniq_start, int64_t *n_uniq_out) {
    if (n_flat < span || n_seqs <= 0) { if (n_uniq_out) *n_uniq_out = 0; return 0; }
    if (n_seqs >= ((int64_t)1 << 21)) return -2;  /* caller falls back */

    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    int nw = ncpu > 1 ? (ncpu > PK_MAXW ? PK_MAXW : (int)ncpu) : 1;
    if (n_seqs < nw) nw = 1;

    static pk_scan_job_t sjobs[PK_MAXW];
    static int64_t hists[PK_MAXW][PK_NBUCKET];
    static int64_t cursors[PK_MAXW][PK_NBUCKET];
    pthread_t tids[PK_MAXW];

    /* split sequences by residue mass */
    int64_t split_lo[PK_MAXW + 1];
    split_lo[0] = 0;
    {
        int64_t total = seq_starts[n_seqs], lo = 0;
        for (int w = 0; w < nw; w++) {
            int64_t target = total * (w + 1) / nw;
            int64_t hi = lo;
            while (hi < n_seqs && seq_starts[hi] < target) hi++;
            if (w == nw - 1) hi = n_seqs;
            split_lo[w + 1] = hi;
            lo = hi;
        }
    }

    /* phase 0: count (exact sizes + digit-1 histogram) */
    for (int w = 0; w < nw; w++) {
        sjobs[w] = (pk_scan_job_t){flat, offsets, k, span, kmer_thr, x_idx,
                                   seq_starts, self_scores,
                                   split_lo[w], split_lo[w + 1],
                                   0, 0, {0}, NULL, NULL};
    }
    int spawned = 0;
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[w - 1], NULL, pk_scan_worker, &sjobs[w]) == 0)
            spawned++;
    pk_scan_worker(&sjobs[0]);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);

    int64_t cnt = 0;
    for (int w = 0; w < nw; w++) {
        cnt += sjobs[w].cnt;
        memcpy(hists[w], sjobs[w].hist, sizeof(hists[w]));
    }
    if (cnt == 0) { if (n_uniq_out) *n_uniq_out = 0; return 0; }

    if (!pk_arena_reserve((size_t)cnt * 8)) return -1;
    uint64_t *buf1 = pk_arena[0];
    uint64_t *buf2 = pk_arena[1];

    /* phase 1: emit-scatter by digit 1 (bits 37..49), stable:
     * bucket-major, worker order within bucket = global scan order */
    pk_layout(hists, cursors, nw);
    for (int w = 0; w < nw; w++) {
        sjobs[w].phase = 1;
        sjobs[w].cursor = cursors[w];
        sjobs[w].out = buf1;
    }
    spawned = 0;
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[w - 1], NULL, pk_scan_worker, &sjobs[w]) == 0)
            spawned++;
    pk_scan_worker(&sjobs[0]);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);

    /* pass 2: scatter by digit 2 (bits 50..62), same parallel layout */
    static pk_scatter_job_t cjobs[PK_MAXW];
    for (int w = 0; w < nw; w++) {
        cjobs[w] = (pk_scatter_job_t){buf1, cnt * w / nw, cnt * (w + 1) / nw,
                                      37 + PK_RADIX_BITS, 0, {0}, NULL, NULL};
    }
    spawned = 0;
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[w - 1], NULL, pk_scatter_worker, &cjobs[w]) == 0)
            spawned++;
    pk_scatter_worker(&cjobs[0]);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    for (int w = 0; w < nw; w++)
        memcpy(hists[w], cjobs[w].hist, sizeof(hists[w]));
    pk_layout(hists, cursors, nw);
    for (int w = 0; w < nw; w++) {
        cjobs[w].phase = 1;
        cjobs[w].cursor = cursors[w];
        cjobs[w].out = buf2;
    }
    spawned = 0;
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[w - 1], NULL, pk_scatter_worker, &cjobs[w]) == 0)
            spawned++;
    pk_scatter_worker(&cjobs[0]);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);

    /* dedup consecutive (code, seq) = equal key>>16, keep first
     * (stable sort preserved pos-ascending order within the pair);
     * record a uniq-code boundary whenever the code digit changes so
     * the caller skips its own 34M-element boundary pass */
    int64_t out_n = 0, n_uniq = 0;
    uint64_t prev = ~(uint64_t)0;
    uint64_t prev_code = ~(uint64_t)0;
    for (int64_t i = 0; i < cnt; i++) {
        uint64_t key = buf2[i];
        if ((key >> 16) == prev) continue;
        prev = key >> 16;
        if (out_uniq_start && (key >> 37) != prev_code) {
            prev_code = key >> 37;
            out_uniq_start[n_uniq++] = out_n;
        }
        out_code[out_n] = (int32_t)(key >> 37);
        out_seq[out_n] = (int32_t)((key >> 16) & 0x1FFFFF);
        out_pos[out_n] = (int32_t)(key & 0xFFFF);
        out_n++;
    }
    if (out_uniq_start) out_uniq_start[n_uniq] = out_n;
    if (n_uniq_out) *n_uniq_out = n_uniq;
    return out_n;
}

int64_t build_postings_v2(const uint8_t *flat, int64_t n_flat,
                          const int32_t *offsets, int32_t k, int32_t span,
                          const int64_t *seq_starts, int64_t n_seqs,
                          const int32_t *self_scores, int32_t kmer_thr,
                          int32_t x_idx,
                          int32_t *out_code, int32_t *out_seq,
                          int32_t *out_pos) {
    return build_postings_v3(flat, n_flat, offsets, k, span, seq_starts,
                             n_seqs, self_scores, kmer_thr, x_idx,
                             out_code, out_seq, out_pos, NULL, NULL);
}
