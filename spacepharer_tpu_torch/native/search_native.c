/* Batched native search drivers: one C call over ALL query ORFs.
 *
 * prefilter_batch replicates ops.prefilter.prefilter_query per query —
 * bias correction (SubstitutionMatrix::calcLocalAaBiasCorrection,
 * lib/mmseqs/src/commons/SubstitutionMatrix.cpp:85-114), spaced k-mer
 * scan, similar-k-mer enumeration in KmerGenerator order
 * (lib/mmseqs/src/commons/KmerGenerator.cpp:186-), postings expansion,
 * and the finalize stage (duplicate filter + ungapped diagonal rescore
 * + max-seqs histogram, QueryMatcher.cpp:84-323) — under a pthread
 * worker pool, the analog of the reference's OpenMP query loop
 * (lib/mmseqs/src/prefiltering/Prefiltering.cpp:776-800). Output is
 * bit-identical to the per-query Python driver (tests/
 * test_native_kernels.py batch-vs-oracle parity).
 *
 * prefilter_finalize_batch runs the finalize stage alone, under the same
 * pool, on match streams the caller built (the dense prefilter's, rebuilt
 * on the card).
 *
 * align_forward_batch / align_traceback_batch batch the alignment
 * driver the same way: per-query SW profiles (ssw_init bias,
 * StripedSmithWaterman.cpp:700-706), forward scores for every
 * prefilter candidate, and the reverse pass + banded backtrace
 * (banded_sw, StripedSmithWaterman.cpp:781-980) for E-value survivors.
 */
#include <math.h>
#include <stdio.h>
#include <time.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

/* from sw_native.c */
extern void prefilter_finalize_release(void);
extern int64_t prefilter_finalize(
    const int32_t *m_t, const uint16_t *m_d, int64_t n_matches,
    int32_t bin_bits,
    const uint8_t *flat_masked, const int64_t *t_starts, int64_t n_targets,
    const int32_t *profile, int32_t lq, int32_t A,
    const uint8_t *q_num,
    int32_t cap, int32_t min_diag_score, int32_t max_seqs,
    int32_t *out_t, int32_t *out_score, int32_t *out_diag);
extern void sw_forward(const int32_t *prof, int64_t stride, int32_t lq,
                       const uint8_t *tseq, int64_t lt,
                       int32_t gap_open, int32_t gap_extend, int32_t reverse,
                       int64_t *out);
extern void sw_forward_i16(const int32_t *prof, int64_t stride,
                           int32_t lq, int32_t A,
                           const uint8_t *tseq, int64_t lt,
                           int32_t gap_open, int32_t gap_extend,
                           int32_t reverse, int64_t *out);
extern int sw_simd_supported(void);
extern int32_t sw_profile_bound(const int32_t *prof, int64_t stride,
                                int32_t lq, int32_t A);

#define MAXW 4

static int n_workers(int64_t n_items) {
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    int nw = ncpu > 1 ? (ncpu > MAXW ? MAXW : (int)ncpu) : 1;
    if (n_items < nw) nw = 1;
    return nw;
}

/* C-style round-half-away-from-zero (matches ops.bias.round_half_away) */
static inline int64_t round_half_away(double x) {
    return (int64_t)(x < 0.0 ? ceil(x - 0.5) : floor(x + 0.5));
}

/* Local aa bias correction, bit-identical to ops.bias.local_aa_bias:
 * the window sum is a sum of integer scores (exact in float64, order-
 * free); the expected term gathers from the caller-provided per-letter
 * table (ops.bias.expected_score_tab). */
static void local_bias(const uint8_t *q, int64_t lq,
                       const int32_t *sub, int32_t A,
                       const double *expected_tab, double *out) {
    for (int64_t i = 0; i < lq; i++) {
        const int32_t *row = sub + (int64_t)q[i] * A;
        int64_t lo = i - 20 > 0 ? i - 20 : 0;
        int64_t hi = i + 20 < lq ? i + 20 : lq;
        int64_t win = 0;
        for (int64_t j = lo; j < hi; j++)
            win += row[q[j]];
        win -= row[q[i]];
        out[i] = -(double)win / (double)(hi - lo) + expected_tab[q[i]];
    }
}

/* ---- similar-k-mer half-list cache ----
 *
 * Per 3-mer (letters 0..19): all 20^3 half codes ordered by
 * (score desc, code asc) — calculateArrayProduct's enumeration order
 * (KmerGenerator.cpp:186-), the same lazy cache as Python's
 * SimilarKmerEnumerator.half_list. Keyed on the seed-matrix pointer
 * (load_matrix is lru_cached, so the scores array is stable per
 * process). */
#define N_HALF 8000

typedef struct {
    int16_t *codes;   /* [N_HALF] half codes in enumeration order */
    int16_t *scores;  /* [N_HALF] their scores, descending */
    int16_t *rank;    /* [N_HALF] rank[code] = its enumeration position */
} half_entry_t;

static half_entry_t g_half[N_HALF];
static const int32_t *g_half_seed = NULL;
static int32_t g_half_A = 0;
static pthread_mutex_t g_half_mu = PTHREAD_MUTEX_INITIALIZER;

static void half_cache_reset(void) {
    for (int i = 0; i < N_HALF; i++) {
        free(g_half[i].codes);
        free(g_half[i].rank);
        g_half[i].codes = NULL;
        g_half[i].scores = NULL;
        g_half[i].rank = NULL;
    }
}

static const half_entry_t *half_list(int32_t tri) {
    half_entry_t *e = &g_half[tri];
    int16_t *codes = __atomic_load_n(&e->codes, __ATOMIC_ACQUIRE);
    if (codes)
        return e;
    pthread_mutex_lock(&g_half_mu);
    if (e->codes) {
        pthread_mutex_unlock(&g_half_mu);
        return e;
    }
    const int32_t *S = g_half_seed;
    int32_t A = g_half_A;
    int32_t t0 = tri / 400, t1 = (tri / 20) % 20, t2 = tri % 20;
    const int32_t *r0 = S + (int64_t)t0 * A;
    const int32_t *r1 = S + (int64_t)t1 * A;
    const int32_t *r2 = S + (int64_t)t2 * A;
    static int32_t s[N_HALF];      /* guarded by g_half_mu */
    int32_t smin = INT32_MAX, smax = INT32_MIN;
    int32_t c = 0;
    for (int32_t a = 0; a < 20; a++) {
        int32_t sa = r0[a];
        for (int32_t b = 0; b < 20; b++) {
            int32_t sab = sa + r1[b];
            for (int32_t d = 0; d < 20; d++, c++) {
                int32_t v = sab + r2[d];
                s[c] = v;
                if (v < smin) smin = v;
                if (v > smax) smax = v;
            }
        }
    }
    /* counting sort: score desc, code asc within equal scores */
    int32_t range = smax - smin + 1;
    int32_t *cnt = (int32_t *)calloc((size_t)range, sizeof(int32_t));
    for (c = 0; c < N_HALF; c++)
        cnt[s[c] - smin]++;
    /* cursor[v] = start of score v's run in the desc order */
    int32_t run = 0;
    for (int32_t v = range - 1; v >= 0; v--) {
        int32_t n = cnt[v];
        cnt[v] = run;
        run += n;
    }
    int16_t *oc = (int16_t *)malloc(sizeof(int16_t) * N_HALF);
    int16_t *os = (int16_t *)malloc(sizeof(int16_t) * N_HALF);
    int16_t *rk = (int16_t *)malloc(sizeof(int16_t) * N_HALF);
    for (c = 0; c < N_HALF; c++) {
        int32_t pos = cnt[s[c] - smin]++;
        oc[pos] = (int16_t)c;
        os[pos] = (int16_t)s[c];
        rk[c] = (int16_t)pos;
    }
    free(cnt);
    e->scores = os;
    e->rank = rk;
    __atomic_store_n(&e->codes, oc, __ATOMIC_RELEASE);
    pthread_mutex_unlock(&g_half_mu);
    return e;
}

/* count of entries with score >= x in a descending score list */
static inline int32_t count_ge(const int16_t *scores, int32_t n, int32_t x) {
    int32_t lo = 0, hi = n;
    while (lo < hi) {
        int32_t mid = (lo + hi) >> 1;
        if (scores[mid] >= x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

/* ---- growable per-worker buffers ---- */
typedef struct {
    void *p;
    int64_t cap;     /* in elements */
} buf_t;

/* Returns NULL on allocation failure (old block kept; caller must
 * propagate the error rather than dereference). */
static void *buf_ensure(buf_t *b, int64_t n, size_t elem) {
    if (n > b->cap) {
        int64_t nc = b->cap ? b->cap : 4096;
        while (nc < n) nc *= 2;
        void *np = realloc(b->p, (size_t)nc * elem);
        if (!np)
            return NULL;
        b->p = np;
        b->cap = nc;
    }
    return b->p;
}

/* ---- prefilter batch ---- */

typedef struct {
    /* queries */
    const uint8_t *qflat;
    const int64_t *qstarts;
    int64_t nq;
    /* seed matrix / bias */
    const int32_t *seed;
    int32_t A;
    const double *expected_tab;
    int32_t comp_bias_corr;
    /* pattern */
    const int32_t *offsets;
    int32_t k, span, kmer_thr, x_idx;
    /* index */
    const int64_t *uniq_codes;
    const int64_t *uniq_start;
    int64_t n_uniq;
    const int32_t *post_seq;
    const uint16_t *post_pos;
    const int64_t *c1_start;    /* [N_HALF+1] */
    const uint16_t *uniq_lo;    /* [n_uniq] low half codes */
    /* targets (masked) */
    const uint8_t *flat_masked;
    const int64_t *t_starts;
    int64_t n_targets;
    /* ungapped rescore */
    const int32_t *ung;
    int32_t sub_min_abs;
    int32_t min_diag_score, max_seqs, bin_bits;
    /* per-query result bookkeeping */
    int32_t *q_cnt;
    int64_t *q_woff;
    int8_t *q_wid;
    volatile int64_t *next_q;
    volatile int *error;
    /* prefilter_finalize_batch only: the match streams of every query
     * (query qi's at key_off[qi] .. key_off[qi + 1] - 1) and the
     * queries' flat composition bias */
    const int32_t *m_t;
    const uint16_t *m_d;
    const int64_t *key_off;
    const double *bias;
} pf_shared_t;

typedef struct { int32_t rank; int64_t idx; } pf_loc_t;

typedef struct {
    pf_shared_t *sh;
    int wid;
    /* output hit buffer */
    buf_t h_t, h_s, h_d;
    int64_t h_n;
    /* scratch */
    buf_t bias, prof, aacorr, st_t, st_d, fin;
    pf_loc_t *loc;                /* [N_HALF] intersection scratch */
    /* phase profile (SPACEPHARER_PREF_STATS=1): seconds in
     * profile-build / match-stream walk / finalize + stream volume */
    double tm_prof, tm_walk, tm_fin;
    int64_t n_stream;
} pf_worker_t;

static double pf_now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

#define PF_CHUNK 64

/* The ungapped rescoring profile of one query in the worker's buffer
 * (ungapped_profile_cap): prof[j][a] = ung[q[j]][a] + round_half_away(
 * bias[j] / 4), and *cap the u8 saturation cap; NULL when the buffer
 * cannot grow. */
static int32_t *pf_profile(pf_worker_t *w, const uint8_t *q, int64_t lq,
                           const double *bias, int32_t *cap) {
    pf_shared_t *sh = w->sh;
    int32_t A = sh->A;
    int32_t *prof = (int32_t *)buf_ensure(&w->prof, lq * A, sizeof(int32_t));
    if (!prof)
        return NULL;
    int64_t corr_min = 0;
    for (int64_t j = 0; j < lq; j++) {
        int64_t corr = round_half_away(bias[j] / 4.0);
        if (corr < corr_min) corr_min = corr;
        const int32_t *row = sh->ung + (int64_t)q[j] * A;
        int32_t *prow = prof + j * A;
        for (int32_t a = 0; a < A; a++)
            prow[a] = row[a] + (int32_t)corr;
    }
    *cap = 255 - (sh->sub_min_abs + (int32_t)(-corr_min));
    return prof;
}

/* prefilter_finalize of query qi's match stream (dup filter, diagonal
 * rescore, max_seqs selection); its hits are appended to the worker's
 * buffers. Sets *sh->error on failure. */
static void pf_finish(pf_worker_t *w, int64_t qi, const int32_t *st_t,
                      const uint16_t *st_d, int64_t ns, const int32_t *prof,
                      int64_t lq, const uint8_t *q, int32_t cap) {
    pf_shared_t *sh = w->sh;
    double pf_t2 = pf_now();
    int64_t fin_cap = sh->max_seqs < sh->n_targets
        ? sh->max_seqs : sh->n_targets;
    int32_t *fin = (int32_t *)buf_ensure(&w->fin, fin_cap * 3,
                                         sizeof(int32_t));
    if (!fin) {
        *sh->error = 1;
        return;
    }
    int64_t nh = prefilter_finalize(
        st_t, st_d, ns, sh->bin_bits,
        sh->flat_masked, sh->t_starts, sh->n_targets,
        prof, (int32_t)lq, sh->A, q, cap, sh->min_diag_score, sh->max_seqs,
        fin, fin + fin_cap, fin + 2 * fin_cap);
    if (nh < 0) {
        *sh->error = 1;
        return;
    }
    int32_t *h_t = (int32_t *)buf_ensure(&w->h_t, w->h_n + nh,
                                         sizeof(int32_t));
    int32_t *h_s = (int32_t *)buf_ensure(&w->h_s, w->h_n + nh,
                                         sizeof(int32_t));
    int32_t *h_d = (int32_t *)buf_ensure(&w->h_d, w->h_n + nh,
                                         sizeof(int32_t));
    /* an empty hit buffer legitimately stays NULL until the worker's
     * first hit (buf_ensure(b, 0) never allocates) — only a FAILED
     * grow is an error */
    if (w->h_n + nh > 0 && (!h_t || !h_s || !h_d)) {
        *sh->error = 1;
        return;
    }
    if (nh == 0) {
        sh->q_cnt[qi] = 0;
        return;
    }
    memcpy(h_t + w->h_n, fin, sizeof(int32_t) * (size_t)nh);
    memcpy(h_s + w->h_n, fin + fin_cap, sizeof(int32_t) * (size_t)nh);
    memcpy(h_d + w->h_n, fin + 2 * fin_cap, sizeof(int32_t) * (size_t)nh);
    sh->q_cnt[qi] = (int32_t)nh;
    w->h_n += nh;
    w->tm_fin += pf_now() - pf_t2;
}


static void pf_one_query(pf_worker_t *w, int64_t qi) {
    pf_shared_t *sh = w->sh;
    const uint8_t *q = sh->qflat + sh->qstarts[qi];
    int64_t lq = sh->qstarts[qi + 1] - sh->qstarts[qi];
    sh->q_cnt[qi] = 0;
    sh->q_wid[qi] = (int8_t)w->wid;
    sh->q_woff[qi] = w->h_n;
    int64_t n_codes = lq - sh->span + 1;
    if (n_codes <= 0 || sh->n_uniq == 0)
        return;

    double pf_t0 = pf_now();
    double *bias = (double *)buf_ensure(&w->bias, lq, sizeof(double));
    if (!bias) {
        *sh->error = 1;
        return;
    }
    if (sh->comp_bias_corr)
        local_bias(q, lq, sh->seed, sh->A, sh->expected_tab, bias);
    else
        memset(bias, 0, sizeof(double) * (size_t)lq);

    int32_t cap;
    int32_t *prof = pf_profile(w, q, lq, bias, &cap);
    if (!prof) {
        *sh->error = 1;
        return;
    }
    double pf_t1 = pf_now();
    w->tm_prof += pf_t1 - pf_t0;

    /* match stream */
    int64_t ns = 0;
    int32_t *st_t = (int32_t *)w->st_t.p;
    uint16_t *st_d = (uint16_t *)w->st_d.p;
    const int32_t k = sh->k;
    const int32_t *offs = sh->offsets;
    /* the final k-mer position's matches are always dropped
     * (QueryMatcher.cpp:289-293 upper bound) */
    for (int64_t i = 0; i < n_codes - 1; i++) {
        int32_t l[8];
        int valid = 1;
        double bsum = 0.0;
        for (int32_t o = 0; o < k; o++) {
            uint8_t ch = q[i + offs[o]];
            if (ch == sh->x_idx) { valid = 0; break; }
            l[o] = ch;
            bsum += bias[i + offs[o]];
        }
        if (!valid)
            continue;
        int64_t thr64 = (int64_t)sh->kmer_thr - round_half_away(bsum);
        int32_t thr = thr64 > 0 ? (int32_t)thr64 : 0;
        const half_entry_t *h1 = half_list(l[0] * 400 + l[1] * 20 + l[2]);
        const half_entry_t *h2 = half_list(l[3] * 400 + l[4] * 20 + l[5]);
        if ((int32_t)h1->scores[0] + (int32_t)h2->scores[0] < thr)
            continue;
        int32_t n1 = count_ge(h1->scores, N_HALF, thr - h2->scores[0]);
        for (int32_t i1 = 0; i1 < n1; i1++) {
            int32_t c1 = h1->codes[i1];
            int64_t rlo = sh->c1_start[c1], rhi = sh->c1_start[c1 + 1];
            if (rlo == rhi)
                continue;      /* no index code has this high half */
            int32_t n2 = count_ge(h2->scores, N_HALF,
                                  thr - h1->scores[i1]);
            /* two ways to intersect {allowed c2} x {index codes under
             * c1}; both emit in half2 ENUMERATION order (the stream
             * order the dup filter depends on) */
            int64_t nsub = rhi - rlo;
            pf_loc_t *loc = w->loc;
            int64_t n_loc = 0;
            if (nsub < n2) {
                /* scan the (small) bucket, keep entries whose c2 rank
                 * clears the cut, restore enumeration order by rank */
                for (int64_t j = rlo; j < rhi; j++) {
                    int32_t rk = h2->rank[sh->uniq_lo[j]];
                    if (rk < n2) {
                        loc[n_loc].rank = rk;
                        loc[n_loc].idx = j;
                        n_loc++;
                    }
                }
                /* insertion sort by rank (n_loc is small) */
                for (int64_t a = 1; a < n_loc; a++) {
                    pf_loc_t key = loc[a];
                    int64_t b = a - 1;
                    while (b >= 0 && loc[b].rank > key.rank) {
                        loc[b + 1] = loc[b];
                        b--;
                    }
                    loc[b + 1] = key;
                }
            } else {
                for (int32_t i2 = 0; i2 < n2; i2++) {
                    uint16_t c2 = (uint16_t)h2->codes[i2];
                    /* binary search c2 in uniq_lo[rlo..rhi) */
                    int64_t lo = rlo, hi = rhi;
                    while (lo < hi) {
                        int64_t mid = (lo + hi) >> 1;
                        if (sh->uniq_lo[mid] < c2) lo = mid + 1;
                        else hi = mid;
                    }
                    if (lo >= rhi || sh->uniq_lo[lo] != c2)
                        continue;
                    loc[n_loc].rank = i2;
                    loc[n_loc].idx = lo;
                    n_loc++;
                }
            }
            for (int64_t li = 0; li < n_loc; li++) {
                int64_t plo = sh->uniq_start[loc[li].idx];
                int64_t phi = sh->uniq_start[loc[li].idx + 1];
                if (ns + (phi - plo) > w->st_t.cap) {
                    st_t = (int32_t *)buf_ensure(&w->st_t, ns + (phi - plo),
                                                 sizeof(int32_t));
                    st_d = (uint16_t *)buf_ensure(&w->st_d, ns + (phi - plo),
                                                  sizeof(uint16_t));
                    if (!st_t || !st_d) {
                        *sh->error = 1;
                        return;
                    }
                }
                for (int64_t p = plo; p < phi; p++) {
                    st_t[ns] = sh->post_seq[p];
                    st_d[ns] = (uint16_t)((i - (int64_t)sh->post_pos[p])
                                          & 0xFFFF);
                    ns++;
                }
            }
        }
    }
    if (ns == 0)
        return;

    w->tm_walk += pf_now() - pf_t1;
    w->n_stream += ns;
    pf_finish(w, qi, st_t, st_d, ns, prof, lq, q, cap);
}

static void pf_worker_loop(pf_worker_t *w) {
    pf_shared_t *sh = w->sh;
    if (!buf_ensure(&w->st_t, 1 << 16, sizeof(int32_t))
            || !buf_ensure(&w->st_d, 1 << 16, sizeof(uint16_t))) {
        *sh->error = 1;
        return;
    }
    w->loc = (pf_loc_t *)malloc(sizeof(pf_loc_t) * N_HALF);
    if (!w->loc) {
        *sh->error = 1;
        return;
    }
    for (;;) {
        int64_t q0 = __atomic_fetch_add(sh->next_q, PF_CHUNK,
                                        __ATOMIC_RELAXED);
        if (q0 >= sh->nq || *sh->error)
            break;
        int64_t q1 = q0 + PF_CHUNK < sh->nq ? q0 + PF_CHUNK : sh->nq;
        for (int64_t qi = q0; qi < q1; qi++)
            pf_one_query(w, qi);
    }
}

/* Every worker frees its finalize scratch before it exits: the threads
 * are fresh on every prefilter_batch call, and their thread-local scratch
 * would otherwise outlive them. */
static void *pf_worker_main(void *arg) {
    pf_worker_loop((pf_worker_t *)arg);
    prefilter_finalize_release();
    return NULL;
}

/* result staging between prefilter_batch (or prefilter_finalize_batch)
 * and prefilter_batch_fetch */
static struct {
    int32_t *t, *s, *d;
    int64_t *off;
    int64_t n, nq;
} g_pf_res = {0};

void prefilter_batch_free(void) {
    free(g_pf_res.t); free(g_pf_res.s); free(g_pf_res.d);
    free(g_pf_res.off);
    memset(&g_pf_res, 0, sizeof(g_pf_res));
}

/* Runs fn on nw workers over sh (nw - 1 threads and the caller; a thread
 * that cannot start leaves its share to the others, which take queries
 * from one counter). */
static void pf_run(pf_worker_t *workers, int nw, pf_shared_t *sh,
                   void *(*fn)(void *)) {
    memset(workers, 0, sizeof(pf_worker_t) * (size_t)nw);
    pthread_t tids[MAXW];
    int spawned = 0;
    for (int w = 0; w < nw; w++) {
        workers[w].sh = sh;
        workers[w].wid = w;
    }
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[spawned], NULL, fn, &workers[w]) == 0)
            spawned++;
    fn(&workers[0]);
    for (int t = 0; t < spawned; t++)
        pthread_join(tids[t], NULL);
}

/* Stages every query's hits, in query order, from the workers' buffers
 * for prefilter_batch_fetch; returns their number, or -1 when the
 * staging cannot be allocated. */
static int64_t pf_stage(pf_worker_t *workers, const pf_shared_t *sh) {
    int64_t nq = sh->nq, total = 0;
    g_pf_res.off = (int64_t *)malloc(sizeof(int64_t) * (size_t)(nq + 1));
    if (!g_pf_res.off)
        return -1;
    for (int64_t qi = 0; qi < nq; qi++) {
        g_pf_res.off[qi] = total;
        total += sh->q_cnt[qi];
    }
    g_pf_res.off[nq] = total;
    g_pf_res.t = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total + 1));
    g_pf_res.s = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total + 1));
    g_pf_res.d = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total + 1));
    if (!g_pf_res.t || !g_pf_res.s || !g_pf_res.d) {
        prefilter_batch_free();
        return -1;
    }
    for (int64_t qi = 0; qi < nq; qi++) {
        int32_t n = sh->q_cnt[qi];
        if (!n) continue;
        pf_worker_t *w = &workers[sh->q_wid[qi]];
        int64_t dst = g_pf_res.off[qi];
        memcpy(g_pf_res.t + dst, (int32_t *)w->h_t.p + sh->q_woff[qi],
               sizeof(int32_t) * (size_t)n);
        memcpy(g_pf_res.s + dst, (int32_t *)w->h_s.p + sh->q_woff[qi],
               sizeof(int32_t) * (size_t)n);
        memcpy(g_pf_res.d + dst, (int32_t *)w->h_d.p + sh->q_woff[qi],
               sizeof(int32_t) * (size_t)n);
    }
    g_pf_res.n = total;
    g_pf_res.nq = nq;
    return total;
}

static void pf_free_workers(pf_worker_t *workers, int nw) {
    for (int w = 0; w < nw; w++) {
        free(workers[w].h_t.p); free(workers[w].h_s.p);
        free(workers[w].h_d.p);
        free(workers[w].bias.p); free(workers[w].prof.p);
        free(workers[w].aacorr.p);
        free(workers[w].st_t.p); free(workers[w].st_d.p);
        free(workers[w].fin.p);
        free(workers[w].loc);
    }
}

static void pf_print_stats(const char *what, pf_worker_t *workers, int nw,
                           int64_t nq) {
    double tp = 0, tw = 0, tf = 0;
    int64_t nstream = 0;
    for (int w = 0; w < nw; w++) {
        tp += workers[w].tm_prof;
        tw += workers[w].tm_walk;
        tf += workers[w].tm_fin;
        nstream += workers[w].n_stream;
    }
    fprintf(stderr,
            "[pref-stats] %s nq=%lld stream=%lld "
            "prof=%.1fs walk=%.1fs finalize=%.1fs (cpu-s summed)\n",
            what, (long long)nq, (long long)nstream, tp, tw, tf);
}

/* Returns total hit count (>= 0) or -1 on failure. Results stay staged
 * until prefilter_batch_fetch copies them out. */
int64_t prefilter_batch(
    const uint8_t *qflat, const int64_t *qstarts, int64_t nq,
    const int32_t *seed, int32_t A, const double *expected_tab,
    int32_t comp_bias_corr,
    const int32_t *offsets, int32_t k, int32_t span,
    int32_t kmer_thr, int32_t x_idx,
    const int64_t *uniq_codes, const int64_t *uniq_start, int64_t n_uniq,
    const int32_t *post_seq, const uint16_t *post_pos,
    const uint8_t *flat_masked, const int64_t *t_starts, int64_t n_targets,
    const int32_t *ung, int32_t sub_min_abs,
    int32_t min_diag_score, int32_t max_seqs, int32_t bin_bits) {
    prefilter_batch_free();
    if (k != 6)
        return -1;   /* the half-split enumeration is 3+3 */

    /* seed-matrix change invalidates the half-list cache */
    if (g_half_seed != seed || g_half_A != A) {
        half_cache_reset();
        g_half_seed = seed;
        g_half_A = A;
    }

    /* high-half bucket boundaries + low-half code array (one pass) */
    int64_t *c1_start = (int64_t *)malloc(sizeof(int64_t) * (N_HALF + 1));
    uint16_t *uniq_lo = (uint16_t *)malloc(sizeof(uint16_t)
                                           * (size_t)(n_uniq ? n_uniq : 1));
    if (!c1_start || !uniq_lo) {
        free(c1_start); free(uniq_lo);
        return -1;
    }
    {
        int64_t j = 0;
        for (int32_t h = 0; h < N_HALF; h++) {
            while (j < n_uniq && uniq_codes[j] < (int64_t)h * N_HALF)
                j++;
            c1_start[h] = j;
        }
        c1_start[N_HALF] = n_uniq;
        for (int64_t i = 0; i < n_uniq; i++)
            uniq_lo[i] = (uint16_t)(uniq_codes[i] % N_HALF);
    }

    int32_t *q_cnt = (int32_t *)malloc(sizeof(int32_t) * (size_t)nq);
    int64_t *q_woff = (int64_t *)malloc(sizeof(int64_t) * (size_t)nq);
    int8_t *q_wid = (int8_t *)malloc((size_t)nq);
    volatile int64_t next_q = 0;
    volatile int error = 0;
    pf_shared_t sh = {
        qflat, qstarts, nq, seed, A, expected_tab, comp_bias_corr,
        offsets, k, span, kmer_thr, x_idx,
        uniq_codes, uniq_start, n_uniq, post_seq, post_pos,
        c1_start, uniq_lo,
        flat_masked, t_starts, n_targets,
        ung, sub_min_abs, min_diag_score, max_seqs, bin_bits,
        q_cnt, q_woff, q_wid, &next_q, &error,
        NULL, NULL, NULL, NULL,
    };
    int nw = n_workers(nq);
    pf_worker_t workers[MAXW];
    pf_run(workers, nw, &sh, pf_worker_main);
    free(c1_start);
    free(uniq_lo);
    if (getenv("SPACEPHARER_PREF_STATS"))
        pf_print_stats("walk", workers, nw, nq);

    int64_t total = error ? -1 : pf_stage(workers, &sh);
    pf_free_workers(workers, nw);
    free(q_cnt); free(q_woff); free(q_wid);
    return total;
}

/* copy staged results out and free them */
int64_t prefilter_batch_fetch(int32_t *out_t, int32_t *out_score,
                              int32_t *out_diag, int64_t *out_off) {
    if (!g_pf_res.off)
        return -1;
    memcpy(out_off, g_pf_res.off, sizeof(int64_t) * (size_t)(g_pf_res.nq + 1));
    memcpy(out_t, g_pf_res.t, sizeof(int32_t) * (size_t)g_pf_res.n);
    memcpy(out_score, g_pf_res.s, sizeof(int32_t) * (size_t)g_pf_res.n);
    memcpy(out_diag, g_pf_res.d, sizeof(int32_t) * (size_t)g_pf_res.n);
    int64_t n = g_pf_res.n;
    prefilter_batch_free();
    return n;
}

/* ---- batched composition bias ----
 *
 * local_bias of every query of a flat batch (query qi's letters at
 * qflat[qstarts[qi] .. qstarts[qi + 1] - 1], its bias at the same range
 * of out), bit-identical to ops.bias.local_aa_bias; zeros when
 * comp_bias_corr is off. The dense prefilter's thresholds and ungapped
 * profiles read it (the host walk computes the same bias per query
 * inside prefilter_batch). */
void local_bias_batch(const uint8_t *qflat, const int64_t *qstarts,
                      int64_t nq, const int32_t *seed, int32_t A,
                      const double *expected_tab, int32_t comp_bias_corr,
                      double *out) {
    for (int64_t qi = 0; qi < nq; qi++) {
        int64_t q0 = qstarts[qi], lq = qstarts[qi + 1] - q0;
        if (comp_bias_corr)
            local_bias(qflat + q0, lq, seed, A, expected_tab, out + q0);
        else
            memset(out + q0, 0, sizeof(double) * (size_t)lq);
    }
}

/* ---- batched finalize of given match streams ----
 *
 * The dense prefilter (ops/prefilter_dense.py) rebuilds every query's
 * match stream on the card, in the order the postings walk above would
 * emit it; this finalizes all of them in one call, under the same worker
 * pool: per query the ungapped rescoring profile and its cap (from the
 * caller's composition bias, the one the dense pass's thresholds used)
 * and prefilter_finalize. Query qi's stream is m_t / m_d[key_off[qi] ..
 * key_off[qi + 1] - 1]; its letters are qflat[qstarts[qi] ..
 * qstarts[qi + 1] - 1], their bias the same range of bias. Returns the
 * total hit count (>= 0), staged for prefilter_batch_fetch, or -1 on
 * failure. */
static void fb_one_query(pf_worker_t *w, int64_t qi) {
    pf_shared_t *sh = w->sh;
    int64_t q0 = sh->qstarts[qi];
    int64_t lq = sh->qstarts[qi + 1] - q0;
    int64_t s0 = sh->key_off[qi];
    int64_t ns = sh->key_off[qi + 1] - s0;
    sh->q_cnt[qi] = 0;
    sh->q_wid[qi] = (int8_t)w->wid;
    sh->q_woff[qi] = w->h_n;
    if (ns == 0)
        return;
    double t0 = pf_now();
    int32_t cap;
    int32_t *prof = pf_profile(w, sh->qflat + q0, lq, sh->bias + q0, &cap);
    if (!prof) {
        *sh->error = 1;
        return;
    }
    w->tm_prof += pf_now() - t0;
    w->n_stream += ns;
    pf_finish(w, qi, sh->m_t + s0, sh->m_d + s0, ns, prof, lq,
              sh->qflat + q0, cap);
}

static void *fb_worker_main(void *arg) {
    pf_worker_t *w = (pf_worker_t *)arg;
    pf_shared_t *sh = w->sh;
    for (;;) {
        int64_t q0 = __atomic_fetch_add(sh->next_q, PF_CHUNK,
                                        __ATOMIC_RELAXED);
        if (q0 >= sh->nq || *sh->error)
            break;
        int64_t q1 = q0 + PF_CHUNK < sh->nq ? q0 + PF_CHUNK : sh->nq;
        for (int64_t qi = q0; qi < q1; qi++)
            fb_one_query(w, qi);
    }
    prefilter_finalize_release();
    return NULL;
}

int64_t prefilter_finalize_batch(
    const int32_t *m_t, const uint16_t *m_d, const int64_t *key_off,
    int64_t nq,
    const uint8_t *qflat, const int64_t *qstarts, const double *bias,
    const int32_t *ung, int32_t A, int32_t sub_min_abs,
    const uint8_t *flat_masked, const int64_t *t_starts, int64_t n_targets,
    int32_t min_diag_score, int32_t max_seqs, int32_t bin_bits) {
    prefilter_batch_free();
    if (nq < 0)
        return -1;
    int32_t *q_cnt = (int32_t *)malloc(sizeof(int32_t) * (size_t)(nq + 1));
    int64_t *q_woff = (int64_t *)malloc(sizeof(int64_t) * (size_t)(nq + 1));
    int8_t *q_wid = (int8_t *)malloc((size_t)(nq + 1));
    if (!q_cnt || !q_woff || !q_wid) {
        free(q_cnt); free(q_woff); free(q_wid);
        return -1;
    }
    volatile int64_t next_q = 0;
    volatile int error = 0;
    pf_shared_t sh;
    memset(&sh, 0, sizeof(sh));
    sh.qflat = qflat;
    sh.qstarts = qstarts;
    sh.nq = nq;
    sh.A = A;
    sh.flat_masked = flat_masked;
    sh.t_starts = t_starts;
    sh.n_targets = n_targets;
    sh.ung = ung;
    sh.sub_min_abs = sub_min_abs;
    sh.min_diag_score = min_diag_score;
    sh.max_seqs = max_seqs;
    sh.bin_bits = bin_bits;
    sh.q_cnt = q_cnt;
    sh.q_woff = q_woff;
    sh.q_wid = q_wid;
    sh.next_q = &next_q;
    sh.error = &error;
    sh.m_t = m_t;
    sh.m_d = m_d;
    sh.key_off = key_off;
    sh.bias = bias;
    int nw = n_workers(nq);
    pf_worker_t workers[MAXW];
    pf_run(workers, nw, &sh, fb_worker_main);
    if (getenv("SPACEPHARER_PREF_STATS"))
        pf_print_stats("finalize-batch", workers, nw, nq);
    int64_t total = error ? -1 : pf_stage(workers, &sh);
    pf_free_workers(workers, nw);
    free(q_cnt); free(q_woff); free(q_wid);
    return total;
}

/* ---- batched contig ORF scan (createsetdb hot path) ----
 *
 * One call over ALL contigs: U->T substitution, both-strand six-frame
 * scan (find_orfs_strand, sw_native.c — the Orf::findForward replica),
 * and the reading-direction nucleotide gather, under the same pthread
 * chunk pool. Replaces ~6 Python/ctypes calls per contig (the wall for
 * spacer catalogs: 30k files x 3 spacers each). Emission order per
 * contig = forward-strand records then reverse-strand records, each in
 * emit order — identical to ops.orf.find_orfs. */

extern int64_t find_orfs_strand(const uint8_t *seq, int64_t L,
                                const uint8_t *cls_tab,
                                const uint8_t *stop_lut,
                                const uint8_t *start_lut,
                                const uint8_t *gappy_tab,
                                int64_t min_len, int64_t max_len,
                                int64_t max_gaps, int32_t start_mode,
                                int64_t *out_emit, int64_t *out_from,
                                int64_t *out_to, uint8_t *out_incs,
                                uint8_t *out_ince, int64_t *out_len);

typedef struct {
    const uint8_t *cflat;
    const int64_t *coff;
    int64_t nc;
    const uint8_t *cls_tab, *stop_lut, *start_lut, *gappy_tab, *rc_lut;
    int64_t min_len, max_len, max_gaps;
    int32_t start_mode;
    /* per-contig bookkeeping */
    int32_t *c_cnt;
    int64_t *c_woff, *c_nucloff;
    int8_t *c_wid;
    volatile int64_t *next_c;
} sc_shared_t;

typedef struct {
    sc_shared_t *sh;
    int wid;
    buf_t seq, rc, scratch;           /* per-contig scratch */
    buf_t o_from, o_to, o_comp;       /* growable per-orf outputs */
    buf_t nucl;
    int64_t n_orfs, n_nucl;
} sc_worker_t;

#define SC_CHUNK 64

static void sc_one_contig(sc_worker_t *w, int64_t ci) {
    sc_shared_t *sh = w->sh;
    int64_t L = sh->coff[ci + 1] - sh->coff[ci];
    sh->c_wid[ci] = (int8_t)w->wid;
    sh->c_woff[ci] = w->n_orfs;
    sh->c_nucloff[ci] = w->n_nucl;
    sh->c_cnt[ci] = 0;
    if (L < 3)
        return;
    uint8_t *seq = (uint8_t *)buf_ensure(&w->seq, L, 1);
    const uint8_t *src = sh->cflat + sh->coff[ci];
    for (int64_t i = 0; i < L; i++) {
        uint8_t b = src[i];
        if (b == 'U') b = 'T';
        else if (b == 'u') b = 't';
        seq[i] = b;
    }
    /* scratch: emit/from/to/len int64 x4 + incs/ince u8 x2, capacity L */
    int64_t *em = (int64_t *)buf_ensure(&w->scratch, 4 * L + L, 8);
    int64_t *fr = em + L;
    int64_t *to = fr + L;
    int64_t *ln = to + L;
    uint8_t *incs = (uint8_t *)(ln + L);
    uint8_t *ince = incs + L;

    for (int strand = 0; strand < 2; strand++) {
        const uint8_t *s = seq;
        if (strand) {
            uint8_t *rc = (uint8_t *)buf_ensure(&w->rc, L, 1);
            for (int64_t i = 0; i < L; i++)
                rc[i] = sh->rc_lut[seq[L - 1 - i]];
            s = rc;
        }
        int64_t n = find_orfs_strand(
            s, L, sh->cls_tab, sh->stop_lut, sh->start_lut, sh->gappy_tab,
            sh->min_len, sh->max_len, sh->max_gaps, sh->start_mode,
            em, fr, to, incs, ince, ln);
        if (!n)
            continue;
        int64_t *o_from = (int64_t *)buf_ensure(&w->o_from,
                                                w->n_orfs + n, 8);
        int64_t *o_to = (int64_t *)buf_ensure(&w->o_to, w->n_orfs + n, 8);
        uint8_t *o_comp = (uint8_t *)buf_ensure(&w->o_comp,
                                                w->n_orfs + n, 1);
        int64_t need = 0;
        for (int64_t r = 0; r < n; r++)
            need += to[r] - fr[r] + 1;
        uint8_t *nucl = (uint8_t *)buf_ensure(&w->nucl,
                                              w->n_nucl + need, 1);
        for (int64_t r = 0; r < n; r++) {
            int64_t gl = to[r] - fr[r] + 1;
            memcpy(nucl + w->n_nucl, s + fr[r], (size_t)gl);
            w->n_nucl += gl;
            if (strand) {
                o_from[w->n_orfs] = (L - 1) - fr[r];
                o_to[w->n_orfs] = (L - 1) - to[r];
            } else {
                o_from[w->n_orfs] = fr[r];
                o_to[w->n_orfs] = to[r];
            }
            o_comp[w->n_orfs] = (uint8_t)(incs[r] | (ince[r] << 1));
            w->n_orfs++;
            sh->c_cnt[ci]++;
        }
    }
}

static void *sc_worker_main(void *arg) {
    sc_worker_t *w = (sc_worker_t *)arg;
    sc_shared_t *sh = w->sh;
    for (;;) {
        int64_t c0 = __atomic_fetch_add(sh->next_c, SC_CHUNK,
                                        __ATOMIC_RELAXED);
        if (c0 >= sh->nc)
            break;
        int64_t c1 = c0 + SC_CHUNK < sh->nc ? c0 + SC_CHUNK : sh->nc;
        for (int64_t ci = c0; ci < c1; ci++)
            sc_one_contig(w, ci);
    }
    return NULL;
}

static struct {
    int32_t *contig;
    int64_t *c_from, *c_to, *nucl_off;
    uint8_t *complete, *nucl;
    int64_t n_orfs, n_nucl, nc;
} g_sc_res = {0};

void scan_contigs_free(void) {
    free(g_sc_res.contig); free(g_sc_res.c_from); free(g_sc_res.c_to);
    free(g_sc_res.nucl_off); free(g_sc_res.complete); free(g_sc_res.nucl);
    memset(&g_sc_res, 0, sizeof(g_sc_res));
}

/* Returns the ORF count (>= 0) or -1; *total_nucl_out gets the flat
 * nucleotide byte count. Results stay staged for scan_contigs_fetch. */
int64_t scan_contigs_batch(
    const uint8_t *cflat, const int64_t *coff, int64_t nc,
    const uint8_t *cls_tab, const uint8_t *stop_lut,
    const uint8_t *start_lut, const uint8_t *gappy_tab,
    const uint8_t *rc_lut,
    int64_t min_len, int64_t max_len, int64_t max_gaps, int32_t start_mode,
    int64_t *total_nucl_out) {
    scan_contigs_free();
    int32_t *c_cnt = (int32_t *)malloc(sizeof(int32_t) * (size_t)(nc + 1));
    int64_t *c_woff = (int64_t *)malloc(sizeof(int64_t) * (size_t)(nc + 1));
    int64_t *c_nucloff = (int64_t *)malloc(sizeof(int64_t)
                                           * (size_t)(nc + 1));
    int8_t *c_wid = (int8_t *)malloc((size_t)(nc + 1));
    if (!c_cnt || !c_woff || !c_nucloff || !c_wid) {
        free(c_cnt); free(c_woff); free(c_nucloff); free(c_wid);
        return -1;
    }
    volatile int64_t next_c = 0;
    sc_shared_t sh = {
        cflat, coff, nc, cls_tab, stop_lut, start_lut, gappy_tab, rc_lut,
        min_len, max_len, max_gaps, start_mode,
        c_cnt, c_woff, c_nucloff, c_wid, &next_c,
    };
    int nw = n_workers(nc);
    sc_worker_t workers[MAXW];
    memset(workers, 0, sizeof(workers));
    pthread_t tids[MAXW];
    int spawned = 0;
    for (int w = 0; w < nw; w++) {
        workers[w].sh = &sh;
        workers[w].wid = w;
    }
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[w - 1], NULL, sc_worker_main,
                           &workers[w]) == 0)
            spawned++;
    sc_worker_main(&workers[0]);
    for (int t = 0; t < spawned; t++)
        pthread_join(tids[t], NULL);

    int64_t n_orfs = 0, n_nucl = 0;
    for (int64_t ci = 0; ci < nc; ci++)
        n_orfs += c_cnt[ci];
    for (int w = 0; w < nw; w++)
        n_nucl += workers[w].n_nucl;
    g_sc_res.contig = (int32_t *)malloc(sizeof(int32_t)
                                        * (size_t)(n_orfs + 1));
    g_sc_res.c_from = (int64_t *)malloc(sizeof(int64_t)
                                        * (size_t)(n_orfs + 1));
    g_sc_res.c_to = (int64_t *)malloc(sizeof(int64_t)
                                      * (size_t)(n_orfs + 1));
    g_sc_res.complete = (uint8_t *)malloc((size_t)(n_orfs + 1));
    g_sc_res.nucl_off = (int64_t *)malloc(sizeof(int64_t)
                                          * (size_t)(n_orfs + 2));
    g_sc_res.nucl = (uint8_t *)malloc((size_t)(n_nucl + 1));
    int64_t oi = 0, nuc = 0;
    for (int64_t ci = 0; ci < nc; ci++) {
        int32_t n = c_cnt[ci];
        if (!n) continue;
        sc_worker_t *w = &workers[c_wid[ci]];
        int64_t wo = c_woff[ci];
        const int64_t *wf = (const int64_t *)w->o_from.p;
        const int64_t *wt = (const int64_t *)w->o_to.p;
        const uint8_t *wc = (const uint8_t *)w->o_comp.p;
        /* nucl bytes for this contig's orfs are contiguous in the
         * worker buffer starting at c_nucloff */
        int64_t gl_total = 0;
        for (int32_t r = 0; r < n; r++) {
            int64_t from = wf[wo + r], to_ = wt[wo + r];
            int64_t gl = from <= to_ ? to_ - from + 1 : from - to_ + 1;
            g_sc_res.contig[oi] = (int32_t)ci;
            g_sc_res.c_from[oi] = from;
            g_sc_res.c_to[oi] = to_;
            g_sc_res.complete[oi] = wc[wo + r];
            g_sc_res.nucl_off[oi] = nuc + gl_total;
            gl_total += gl;
            oi++;
        }
        memcpy(g_sc_res.nucl + nuc,
               (const uint8_t *)w->nucl.p + c_nucloff[ci],
               (size_t)gl_total);
        nuc += gl_total;
    }
    g_sc_res.nucl_off[oi] = nuc;
    g_sc_res.n_orfs = n_orfs;
    g_sc_res.n_nucl = nuc;
    for (int w = 0; w < nw; w++) {
        free(workers[w].seq.p); free(workers[w].rc.p);
        free(workers[w].scratch.p);
        free(workers[w].o_from.p); free(workers[w].o_to.p);
        free(workers[w].o_comp.p); free(workers[w].nucl.p);
    }
    free(c_cnt); free(c_woff); free(c_nucloff); free(c_wid);
    if (total_nucl_out) *total_nucl_out = n_nucl;
    return n_orfs;
}

int64_t scan_contigs_fetch(int32_t *orf_contig, int64_t *c_from,
                           int64_t *c_to, uint8_t *complete,
                           int64_t *nucl_off, uint8_t *nucl_data) {
    if (!g_sc_res.nucl_off)
        return -1;
    int64_t n = g_sc_res.n_orfs;
    memcpy(orf_contig, g_sc_res.contig, sizeof(int32_t) * (size_t)n);
    memcpy(c_from, g_sc_res.c_from, sizeof(int64_t) * (size_t)n);
    memcpy(c_to, g_sc_res.c_to, sizeof(int64_t) * (size_t)n);
    memcpy(complete, g_sc_res.complete, (size_t)n);
    memcpy(nucl_off, g_sc_res.nucl_off, sizeof(int64_t) * (size_t)(n + 1));
    memcpy(nucl_data, g_sc_res.nucl, (size_t)g_sc_res.n_nucl);
    scan_contigs_free();
    return n;
}

/* ---- align batch ---- */

/* ssw_init's int8 composition bias + transposed SW profile
 * profT[a*lq + j] = sub[q_j][a] + bias_i8[j] */
static void build_sw_profile(const uint8_t *q, int64_t lq,
                             const int32_t *sub, int32_t A,
                             const double *expected_tab,
                             int32_t comp_bias_corr,
                             double *bias_scratch, int32_t *profT) {
    int64_t j;
    if (comp_bias_corr) {
        local_bias(q, lq, sub, A, expected_tab, bias_scratch);
    } else {
        for (j = 0; j < lq; j++) bias_scratch[j] = 0.0;
    }
    for (j = 0; j < lq; j++) {
        int32_t b = (int32_t)round_half_away(bias_scratch[j]);
        const int32_t *row = sub + (int64_t)q[j] * A;
        for (int32_t a = 0; a < A; a++)
            profT[(int64_t)a * lq + j] = row[a] + b;
    }
}

typedef struct {
    const uint8_t *qflat;
    const int64_t *qstarts;
    int64_t nq;
    const int32_t *sub;
    int32_t A;
    const double *expected_tab;
    int32_t comp_bias_corr;
    const uint8_t *tflat;
    const int64_t *tstarts;
    const int32_t *cand_t;
    const int64_t *cand_off;
    int32_t gap_open, gap_extend;
    int32_t *out_score, *out_tend, *out_qend;
    volatile int64_t *next_q;
} af_shared_t;

typedef struct {
    af_shared_t *sh;
    buf_t bias, prof;
} af_worker_t;

#define AF_CHUNK 16

static void *af_worker_main(void *arg) {
    af_worker_t *w = (af_worker_t *)arg;
    af_shared_t *sh = w->sh;
    for (;;) {
        int64_t q0 = __atomic_fetch_add(sh->next_q, AF_CHUNK,
                                        __ATOMIC_RELAXED);
        if (q0 >= sh->nq)
            break;
        int64_t q1 = q0 + AF_CHUNK < sh->nq ? q0 + AF_CHUNK : sh->nq;
        for (int64_t qi = q0; qi < q1; qi++) {
            int64_t clo = sh->cand_off[qi], chi = sh->cand_off[qi + 1];
            if (clo == chi)
                continue;
            const uint8_t *q = sh->qflat + sh->qstarts[qi];
            int64_t lq = sh->qstarts[qi + 1] - sh->qstarts[qi];
            double *bias = (double *)buf_ensure(&w->bias, lq,
                                                sizeof(double));
            int32_t *profT = (int32_t *)buf_ensure(
                &w->prof, lq * sh->A, sizeof(int32_t));
            build_sw_profile(q, lq, sh->sub, sh->A, sh->expected_tab,
                             sh->comp_bias_corr, bias, profT);
            /* exact AVX2 i16 kernel when the query's score bound
             * fits int16 (bit-identical; sw_native.c) */
            int use_simd = sw_simd_supported() && lq <= 256
                && sh->A <= 32
                && sw_profile_bound(profT, lq, (int32_t)lq, sh->A)
                   + (int32_t)lq * sh->gap_extend < 30000;
            for (int64_t ci = clo; ci < chi; ci++) {
                int32_t t = sh->cand_t[ci];
                const uint8_t *tseq = sh->tflat + sh->tstarts[t];
                int64_t lt = sh->tstarts[t + 1] - sh->tstarts[t];
                int64_t out3[3];
                if (use_simd)
                    sw_forward_i16(profT, lq, (int32_t)lq, sh->A, tseq,
                                   lt, sh->gap_open, sh->gap_extend, 0,
                                   out3);
                else
                    sw_forward(profT, lq, (int32_t)lq, tseq, lt,
                               sh->gap_open, sh->gap_extend, 0, out3);
                sh->out_score[ci] = (int32_t)out3[0];
                sh->out_tend[ci] = (int32_t)out3[1];
                sh->out_qend[ci] = (int32_t)out3[2];
            }
        }
    }
    return NULL;
}

/* Forward SW scores + end cells for every (query, candidate) pair.
 * cand_off[nq+1] indexes cand_t; outputs are per-pair. */
void align_forward_batch(
    const uint8_t *qflat, const int64_t *qstarts, int64_t nq,
    const int32_t *sub, int32_t A, const double *expected_tab,
    int32_t comp_bias_corr,
    const uint8_t *tflat, const int64_t *tstarts,
    const int32_t *cand_t, const int64_t *cand_off,
    int32_t gap_open, int32_t gap_extend,
    int32_t *out_score, int32_t *out_tend, int32_t *out_qend) {
    volatile int64_t next_q = 0;
    af_shared_t sh = {
        qflat, qstarts, nq, sub, A, expected_tab, comp_bias_corr,
        tflat, tstarts, cand_t, cand_off, gap_open, gap_extend,
        out_score, out_tend, out_qend, &next_q,
    };
    int nw = n_workers(nq);
    af_worker_t workers[MAXW];
    memset(workers, 0, sizeof(workers));
    pthread_t tids[MAXW];
    int spawned = 0;
    for (int w = 0; w < nw; w++)
        workers[w].sh = &sh;
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[w - 1], NULL, af_worker_main,
                           &workers[w]) == 0)
            spawned++;
    af_worker_main(&workers[0]);
    for (int t = 0; t < spawned; t++)
        pthread_join(tids[t], NULL);
    for (int w = 0; w < nw; w++) {
        free(workers[w].bias.p);
        free(workers[w].prof.p);
    }
}

/* ---- banded backtrace (banded_sw, StripedSmithWaterman.cpp:781-980) ----
 *
 * Exact port of ops.align._banded_backtrace: growing-band DP with the
 * reference's direction codes, traceback, and the always-appended
 * final 'M'. Returns backtrace length, or -1 on traceback error
 * (direction 0 — the caller falls back to the Python per-pair path,
 * which raises like the reference would misbehave). */
static inline int64_t bsw_u(int64_t w, int64_t i, int64_t j) {
    int64_t x = i - w;
    if (x < 0) x = 0;
    return j - x + 1;
}

static inline int64_t bsw_d(int64_t w, int64_t i, int64_t j, int64_t p) {
    int64_t x = i - w;
    if (x < 0) x = 0;
    return (j - x) * 3 + p;
}

static int64_t banded_backtrace(
    const int32_t *profT, int64_t lq_full,
    const uint8_t *t_sub, const uint8_t *q_sub,
    int64_t q_off, int64_t db_len, int64_t query_length,
    int32_t score, int32_t gap_open, int32_t gap_extend,
    uint8_t *bt_out, int64_t bt_cap, int32_t *aa_ids_out,
    buf_t *hbuf, buf_t *dirbuf) {
    int64_t band_width = db_len - query_length;
    if (band_width < 0) band_width = -band_width;
    band_width += 1;
    uint8_t *direction = NULL;
    int64_t width_d = 0;
    for (;;) {
        int64_t width = band_width * 2 + 3;
        width_d = band_width * 2 + 1;
        int32_t *h_b = (int32_t *)buf_ensure(hbuf, 3 * (width + 2),
                                             sizeof(int32_t));
        int32_t *e_b = h_b + (width + 2);
        int32_t *h_c = e_b + (width + 2);
        memset(h_b, 0, sizeof(int32_t) * (size_t)(3 * (width + 2)));
        direction = (uint8_t *)buf_ensure(dirbuf,
                                          query_length * width_d * 3, 1);
        /* zeroed like Python's fresh direction lists: an off-band
         * traceback step must read 0 (error) — not a stale value */
        memset(direction, 0, (size_t)(query_length * width_d * 3));
        int32_t maxv = 0;
        for (int64_t j = 1; j < width - 1; j++)
            h_b[j] = 0;
        for (int64_t i = 0; i < query_length; i++) {
            int64_t beg = i - band_width > 0 ? i - band_width : 0;
            int64_t end = i + band_width < db_len - 1 ? i + band_width
                                                      : db_len - 1;
            int64_t edge = end + 1 < width - 1 ? end + 1 : width - 1;
            int32_t f = 0;
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0;
            uint8_t *dline = direction + i * width_d * 3;
            int64_t u = 0;
            for (int64_t j = beg; j <= end; j++) {
                u = bsw_u(band_width, i, j);
                int64_t e_idx = bsw_u(band_width, i - 1, j);
                int64_t b_idx = bsw_u(band_width, i, j - 1);
                int64_t d_idx = bsw_u(band_width, i - 1, j - 1);
                int64_t de = bsw_d(band_width, i, j, 0);
                int64_t df = bsw_d(band_width, i, j, 1);
                int64_t dh = bsw_d(band_width, i, j, 2);

                int32_t t1 = (i == 0) ? -gap_open : h_b[e_idx] - gap_open;
                int32_t t2 = (i == 0) ? -gap_extend : e_b[e_idx] - gap_extend;
                e_b[u] = t1 > t2 ? t1 : t2;
                dline[de] = t1 > t2 ? 3 : 2;

                t1 = h_c[b_idx] - gap_open;
                t2 = f - gap_extend;
                f = t1 > t2 ? t1 : t2;
                dline[df] = t1 > t2 ? 5 : 4;

                int32_t e1 = e_b[u] > 0 ? e_b[u] : 0;
                int32_t f1 = f > 0 ? f : 0;
                t1 = e1 > f1 ? e1 : f1;
                t2 = h_b[d_idx]
                    + profT[(int64_t)t_sub[j] * lq_full + q_off + i];
                h_c[u] = t1 > t2 ? t1 : t2;
                if (h_c[u] > maxv) maxv = h_c[u];
                if (t1 <= t2)
                    dline[dh] = 1;
                else
                    dline[dh] = e1 > f1 ? dline[de] : dline[df];
            }
            for (int64_t j = 1; j <= u; j++)
                h_b[j] = h_c[j];
        }
        if (maxv >= score)
            break;
        band_width *= 2;
    }

    /* traceback (end -> start), ops recorded forward into bt_out tail */
    int64_t i = query_length - 1;
    int64_t j = db_len - 1;
    int32_t state = 2;
    int64_t n_ops = 0;
    while (i > 0 || j > 0) {
        int64_t x = i - band_width;
        if (x < 0) x = 0;
        int64_t idx = (j - x) * 3 + state;
        uint8_t d = direction[i * width_d * 3 + idx];
        if (n_ops >= bt_cap - 1)
            return -1;
        switch (d) {
        case 1: i--; j--; state = 2; bt_out[n_ops++] = 'M'; break;
        case 2: i--; state = 0; bt_out[n_ops++] = 'I'; break;
        case 3: i--; state = 2; bt_out[n_ops++] = 'I'; break;
        case 4: j--; state = 1; bt_out[n_ops++] = 'D'; break;
        case 5: j--; state = 2; bt_out[n_ops++] = 'D'; break;
        default:
            return -1;
        }
    }
    bt_out[n_ops++] = 'M';   /* banded_sw: final op forced to M */
    /* reverse in place */
    for (int64_t a = 0, b = n_ops - 1; a < b; a++, b--) {
        uint8_t tmp = bt_out[a];
        bt_out[a] = bt_out[b];
        bt_out[b] = tmp;
    }
    /* identities along the backtrace */
    int64_t qp = 0, tp = 0;
    int32_t ids = 0;
    for (int64_t a = 0; a < n_ops; a++) {
        uint8_t op = bt_out[a];
        if (op == 'M') {
            if (qp < query_length && tp < db_len
                && q_sub[qp] == t_sub[tp])
                ids++;
            qp++; tp++;
        } else if (op == 'I') {
            qp++;
        } else {
            tp++;
        }
    }
    *aa_ids_out = ids;
    return n_ops;
}

/* ---- nucleotide re-scoring of protein alignments ----
 *
 * Batched core of proteinaln2nucl
 * (lib/mmseqs/src/util/proteinaln2nucl.cpp:60-203): walk each row's
 * compressed protein backtrace at 3x against the ORF nucleotide
 * sequences, scoring M runs with the nucleotide matrix and D/I runs
 * with the nucleotide gap costs, counting identities on the raw
 * bytes. Also emits the 3x run-length backtrace. E-value/bit-score
 * recomputation stays vectorized in Python (report/nuclaln.py). */
void nucl_rescore_batch(
    const uint8_t *pool, const int64_t *pool_off,
    const int32_t *row_qpool, const int32_t *row_tpool, int64_t n_rows,
    const int32_t *row_qstart, const int32_t *row_tstart,
    const uint8_t *bt_flat, const int64_t *bt_off,
    const uint8_t *enc_lut /*256*/, const int32_t *mat /*[nA*nA]*/,
    int32_t nA, int32_t gap_open, int32_t gap_extend,
    int64_t *out_score, int32_t *out_ids, int32_t *out_alnlen,
    uint8_t *new_bt, const int64_t *new_bt_off, int32_t *out_btlen) {
    for (int64_t r = 0; r < n_rows; r++) {
        const uint8_t *q = pool + pool_off[row_qpool[r]];
        const uint8_t *t = pool + pool_off[row_tpool[r]];
        const uint8_t *bt = bt_flat + bt_off[r];
        int64_t bn = bt_off[r + 1] - bt_off[r];
        uint8_t *ob = new_bt + new_bt_off[r];
        int64_t qp = row_qstart[r], tp = row_tstart[r];
        int64_t score = 0, o = 0;
        int32_t ids = 0, alnlen = 0;
        int64_t cnt = 0;
        for (int64_t i = 0; i < bn; i++) {
            uint8_t c = bt[i];
            if (c >= '0' && c <= '9') {
                cnt = cnt * 10 + (c - '0');
                continue;
            }
            int64_t n = cnt ? cnt : 1;
            int64_t n3 = n * 3;
            if (c == 'M') {
                for (int64_t k = 0; k < n3; k++) {
                    ids += (q[qp] == t[tp]);
                    score += mat[(int64_t)enc_lut[q[qp]] * nA
                                 + enc_lut[t[tp]]];
                    qp++;
                    tp++;
                }
            } else if (c == 'D') {
                tp += n3;
                score -= gap_open + ((n - 1) * 3) * gap_extend;
            } else if (c == 'I') {
                qp += n3;
                score -= gap_open + ((n - 1) * 3) * gap_extend;
            }
            alnlen += (int32_t)n3;
            /* append f"{n*3}{c}" */
            char tmp[24];
            int64_t v = n3, d = 0;
            do { tmp[d++] = (char)('0' + v % 10); v /= 10; } while (v);
            while (d) ob[o++] = (uint8_t)tmp[--d];
            ob[o++] = c;
            cnt = 0;
        }
        out_score[r] = score;
        out_ids[r] = ids;
        out_alnlen[r] = alnlen;
        out_btlen[r] = (int32_t)o;
    }
}

/* ---- on-demand ORF nucleotide derivation, batched ----
 *
 * One pass over many ORFs: contig slice, strand handling
 * (revcomp LUT on minus), U->T (both folded into per-strand LUTs by
 * the caller), optional control-DB codon reversal — the
 * SetDB.orf_nucl() reconstruction (Orf::getSequence +
 * ReverseSeqByCodon semantics) without a Python call per key. */
void orf_nucl_ranges(
    const uint8_t *contig_flat, const int64_t *contig_off,
    const int32_t *orf_contig, const int64_t *orf_from,
    const int64_t *orf_to,
    const int32_t *keys, int64_t n_keys,
    const uint8_t *fwd_lut /*256: U->T*/,
    const uint8_t *rc_lut /*256: complement + '.'->N + U->T*/,
    int32_t reverse_codons,
    const int64_t *out_off, uint8_t *out) {
    for (int64_t i = 0; i < n_keys; i++) {
        int32_t k = keys[i];
        const uint8_t *c = contig_flat + contig_off[orf_contig[k]];
        int64_t f = orf_from[k], t = orf_to[k];
        uint8_t *dst = out + out_off[i];
        int64_t len = out_off[i + 1] - out_off[i];
        if (f <= t) {
            for (int64_t j = 0; j < len; j++)
                dst[j] = fwd_lut[c[f + j]];
        } else {
            for (int64_t j = 0; j < len; j++)
                dst[j] = rc_lut[c[f - j]];
        }
        if (reverse_codons) {
            for (int64_t a = 0, b = len - 3; a < b; a += 3, b -= 3) {
                for (int64_t x = 0; x < 3; x++) {
                    uint8_t tmp = dst[a + x];
                    dst[a + x] = dst[b + x];
                    dst[b + x] = tmp;
                }
            }
        }
    }
}

/* run-length encode a raw M/I/D backtrace like
 * Matcher::compressAlignment (Matcher.cpp:214-233, including the
 * initial state='M' count=0 quirk). Returns the encoded length. */
static int64_t bt_rle(const uint8_t *bt, int64_t n, uint8_t *out) {
    uint8_t state = 'M';
    int64_t count = 0, o = 0;
    for (int64_t i = 0; i <= n; i++) {
        if (i < n && bt[i] == state) {
            count++;
            continue;
        }
        /* flush f"{count}{state}" */
        char tmp[24];
        int64_t c = count, d = 0;
        do { tmp[d++] = (char)('0' + c % 10); c /= 10; } while (c);
        while (d) out[o++] = (uint8_t)tmp[--d];
        out[o++] = state;
        if (i < n) {
            state = bt[i];
            count = 1;
        }
    }
    return o;
}

typedef struct {
    const uint8_t *qflat;
    const int64_t *qstarts;
    const int32_t *sub;
    int32_t A;
    const double *expected_tab;
    int32_t comp_bias_corr;
    const uint8_t *tflat;
    const int64_t *tstarts;
    const int32_t *pair_q, *pair_t, *pair_score, *pair_tend, *pair_qend;
    int64_t n_pairs;
    int32_t gap_open, gap_extend;
    int32_t *out_qstart, *out_tstart, *out_rscore, *out_aaids, *out_btlen;
    uint8_t *bt_buf;
    const int64_t *bt_off;
    uint8_t *rle_buf;              /* optional: RLE backtraces */
    const int64_t *rle_off;
    int32_t *out_rlelen;
    volatile int64_t *next_p;
} at_shared_t;

typedef struct {
    at_shared_t *sh;
    buf_t bias, prof, hrows, dir;
    int64_t cur_q;
} at_worker_t;

#define AT_CHUNK 8

static void *at_worker_main(void *arg) {
    at_worker_t *w = (at_worker_t *)arg;
    at_shared_t *sh = w->sh;
    w->cur_q = -1;
    for (;;) {
        int64_t p0 = __atomic_fetch_add(sh->next_p, AT_CHUNK,
                                        __ATOMIC_RELAXED);
        if (p0 >= sh->n_pairs)
            break;
        int64_t p1 = p0 + AT_CHUNK < sh->n_pairs ? p0 + AT_CHUNK
                                                 : sh->n_pairs;
        for (int64_t pi = p0; pi < p1; pi++) {
            int64_t qi = sh->pair_q[pi];
            const uint8_t *q = sh->qflat + sh->qstarts[qi];
            int64_t lq = sh->qstarts[qi + 1] - sh->qstarts[qi];
            if (qi != w->cur_q) {
                double *bias = (double *)buf_ensure(&w->bias, lq,
                                                    sizeof(double));
                int32_t *profT = (int32_t *)buf_ensure(
                    &w->prof, lq * sh->A, sizeof(int32_t));
                build_sw_profile(q, lq, sh->sub, sh->A, sh->expected_tab,
                                 sh->comp_bias_corr, bias, profT);
                w->cur_q = qi;
            }
            const int32_t *profT = (const int32_t *)w->prof.p;
            int32_t t = sh->pair_t[pi];
            const uint8_t *tseq = sh->tflat + sh->tstarts[t];
            int32_t t_end = sh->pair_tend[pi];
            int32_t q_end = sh->pair_qend[pi];
            /* reverse pass over the prefix rectangle (same exact
             * AVX2 i16 route as the forward batch when in range) */
            int use_simd = sw_simd_supported() && lq <= 256
                && sh->A <= 32
                && sw_profile_bound(profT, lq, (int32_t)lq, sh->A)
                   + (int32_t)lq * sh->gap_extend < 30000;
            int64_t out3[3];
            if (use_simd)
                sw_forward_i16(profT, lq, q_end + 1, sh->A, tseq,
                               t_end + 1, sh->gap_open, sh->gap_extend,
                               1, out3);
            else
                sw_forward(profT, lq, q_end + 1, tseq, t_end + 1,
                           sh->gap_open, sh->gap_extend, 1, out3);
            int32_t rscore = (int32_t)out3[0];
            int32_t t_start = t_end - (int32_t)out3[1];
            int32_t q_start = q_end - (int32_t)out3[2];
            sh->out_rscore[pi] = rscore;
            sh->out_qstart[pi] = q_start;
            sh->out_tstart[pi] = t_start;
            int32_t ids = 0;
            int64_t btlen = banded_backtrace(
                profT, lq, tseq + t_start, q + q_start, q_start,
                (int64_t)t_end - t_start + 1, (int64_t)q_end - q_start + 1,
                sh->pair_score[pi], sh->gap_open, sh->gap_extend,
                sh->bt_buf + sh->bt_off[pi],
                sh->bt_off[pi + 1] - sh->bt_off[pi],
                &ids, &w->hrows, &w->dir);
            sh->out_aaids[pi] = ids;
            sh->out_btlen[pi] = (int32_t)btlen;
            if (sh->rle_buf) {
                sh->out_rlelen[pi] = (btlen < 0) ? -1
                    : (int32_t)bt_rle(sh->bt_buf + sh->bt_off[pi], btlen,
                                      sh->rle_buf + sh->rle_off[pi]);
            }
        }
    }
    return NULL;
}

/* Reverse pass + banded backtrace for E-value survivor pairs.
 * bt_off[n_pairs+1] gives each pair's slice of bt_buf (capacity
 * >= lq_rect + lt_rect + 2). out_btlen[i] = -1 flags a traceback
 * error (caller falls back per pair). */
void align_traceback_batch(
    const uint8_t *qflat, const int64_t *qstarts,
    const int32_t *sub, int32_t A, const double *expected_tab,
    int32_t comp_bias_corr,
    const uint8_t *tflat, const int64_t *tstarts,
    const int32_t *pair_q, const int32_t *pair_t, int64_t n_pairs,
    const int32_t *pair_score, const int32_t *pair_tend,
    const int32_t *pair_qend,
    int32_t gap_open, int32_t gap_extend,
    int32_t *out_qstart, int32_t *out_tstart, int32_t *out_rscore,
    int32_t *out_aaids, int32_t *out_btlen,
    uint8_t *bt_buf, const int64_t *bt_off,
    uint8_t *rle_buf, const int64_t *rle_off, int32_t *out_rlelen) {
    volatile int64_t next_p = 0;
    at_shared_t sh = {
        qflat, qstarts, sub, A, expected_tab, comp_bias_corr,
        tflat, tstarts, pair_q, pair_t, pair_score, pair_tend, pair_qend,
        n_pairs, gap_open, gap_extend,
        out_qstart, out_tstart, out_rscore, out_aaids, out_btlen,
        bt_buf, bt_off, rle_buf, rle_off, out_rlelen, &next_p,
    };
    int nw = n_workers(n_pairs);
    at_worker_t workers[MAXW];
    memset(workers, 0, sizeof(workers));
    pthread_t tids[MAXW];
    int spawned = 0;
    for (int w = 0; w < nw; w++)
        workers[w].sh = &sh;
    for (int w = 1; w < nw; w++)
        if (pthread_create(&tids[w - 1], NULL, at_worker_main,
                           &workers[w]) == 0)
            spawned++;
    at_worker_main(&workers[0]);
    for (int t = 0; t < spawned; t++)
        pthread_join(tids[t], NULL);
    for (int w = 0; w < nw; w++) {
        free(workers[w].bias.p);
        free(workers[w].prof.p);
        free(workers[w].hrows.p);
        free(workers[w].dir.p);
    }
}
