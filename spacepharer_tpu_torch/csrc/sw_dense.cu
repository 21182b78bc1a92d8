// Dense all-pairs Smith-Waterman best scores on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of spacepharer_tpu/ops/sw_pallas.py:
// _sw_kernel (one query against every target, entered through
// sw_scores_one_query_pallas) and _sw_kernel_batch (Q queries against T
// targets, entered through sw_scores_pallas_batch). Both compute one
// function, which is also the per-shard scorer of the device mesh
// (spacepharer_tpu/parallel/sharding.py::sw_score_allpairs):
//
//   q_prof int32 [Q, LQ, A]  per-position query profiles (pad entries NEG)
//   q_len  int32 [Q]         rows j >= q_len are masked out
//   t_seqs int32 [LT, T]     target letters, transposed (column i of all
//                            targets is one contiguous row)
//   t_len  int32 [T]         columns i >= t_len change nothing
//   out    int32 [Q, T]      best local score, floored at 0
//
// with the Farrar E-from-pre-F recurrence of the reference's sw_sse2_byte:
//
//   h_pre = max(H[j-1](i-1) + S(j, t_i), E[j], 0)
//   E'[j] = max(h_pre - gap_open, E[j] - gap_extend, 0)
//   H[j]  = max(h_pre, F[j]);  F[j+1] = max(h_pre - gap_open, F[j] - gap_extend)
//   best  = max(best, H[j])
//
// A letter outside [0, A) scores 0, as the TPU kernel's one-hot product
// gives it: the shared profile has an extra zero column A for it.
//
// What bounds it on this card: integer ALU work, not bytes. A true cell
// (query row < q_len, target column < t_len) costs ~6 int32 add/max ops
// and one shared-memory profile read, while a thread reads one 4-byte
// letter per column and writes one score per pair. The design:
//   * one thread per (query, target) pair; a block is QT queries x
//     256 / QT targets, one query per warp, so every branch on the query
//     (its length, its stripes) is uniform across a warp;
//   * consecutive threads take consecutive targets, so the [LT, T] layout
//     makes each column's letter load one coalesced 128-byte line;
//   * H and E of a STRIPE of query rows live in registers (fully
//     unrolled), F runs down the column in one register, so a column
//     costs no memory traffic beyond its letter;
//   * the block's profile stripes sit in shared memory as [query][row]
//     [letter]: a warp reading one row at up to 32 distinct letters hits
//     distinct banks, equal letters broadcast;
//   * each thread stops at its own t_len and q_len, not at LT and LQ;
//   * a query longer than one stripe walks its target once per stripe and
//     hands each column's bottom-row H and outgoing F to the next stripe
//     through a global scratch line [LT] per pair, laid out [slot][LT][T]
//     so that those accesses coalesce too (the host gives a slot to every
//     such query of a launch).
// Rows past a query's end inside its last stripe carry a very negative
// profile value and never raise a score: their E stays 0, their h_pre is 0
// and their H is at most F <= best - gap_open. The TPU kernels' one-hot
// MXU gather and log2 shift-max cummax have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripe = 16;       // query rows per register stripe
constexpr int kThreads = 256;     // pairs per block
constexpr int kMaxAlpha = 128;    // profile columns a launch may have
constexpr int kNeg = -(1 << 24);  // pad rows of a stripe; initial F

template <int QT>
__global__ void __launch_bounds__(kThreads)
sw_dense_kernel(const int32_t* __restrict__ q_prof,  // [n_q, lq, a]
                const int32_t* __restrict__ q_len,   // [n_q]
                const int32_t* __restrict__ q_slot,  // [n_q] or null, -1 = none
                const int32_t* __restrict__ t_seqs,  // [lt, n_t]
                const int32_t* __restrict__ t_len,   // [n_t]
                int n_q, int lq, int a, int n_t, int lt, int gap_open,
                int gap_extend,
                int2* __restrict__ scratch,          // [slots, lt, n_t]
                int32_t* __restrict__ out) {         // [n_q, n_t]
  constexpr int TT = kThreads / QT;                  // targets per block
  extern __shared__ int32_t sprof[];                 // [QT][kStripe][a + 1]
  __shared__ int s_qlen[QT];
  const int stride = a + 1;
  const int ql = threadIdx.x / TT;
  const int q = blockIdx.y * QT + ql;
  const int t = blockIdx.x * TT + threadIdx.x % TT;
  const bool active = q < n_q && t < n_t;

  if (threadIdx.x < QT) {
    const int qg = blockIdx.y * QT + threadIdx.x;
    s_qlen[threadIdx.x] = qg < n_q ? min(max(q_len[qg], 0), lq) : 0;
  }
  __syncthreads();
  int max_len = 0;
#pragma unroll
  for (int k = 0; k < QT; ++k) max_len = max(max_len, s_qlen[k]);
  const int qlen = s_qlen[ql];
  const int tlen = active ? min(max(t_len[t], 0), lt) : 0;
  int2* scr = nullptr;
  if (active && qlen > kStripe)
    scr = scratch +
          static_cast<int64_t>(q_slot ? q_slot[q] : 0) * lt * n_t + t;
  const int32_t* tcol = t_seqs + (active ? t : 0);

  int best = 0;
  // every thread walks the block's stripes (max_len is block-uniform), so
  // the barriers are reached by all; a warp skips stripes its query lacks
  for (int s0 = 0; s0 < max_len; s0 += kStripe) {
    __syncthreads();  // the previous stripe's readers are done
    for (int k = threadIdx.x; k < QT * kStripe * stride; k += kThreads) {
      const int qq = k / (kStripe * stride);
      const int r = (k / stride) % kStripe;
      const int c = k % stride;
      const int qg = blockIdx.y * QT + qq;
      int v = 0;
      if (c < a)
        v = s0 + r < s_qlen[qq]
                ? q_prof[(static_cast<int64_t>(qg) * lq + s0 + r) * a + c]
                : kNeg;
      sprof[k] = v;
    }
    __syncthreads();
    if (!active || s0 >= qlen) continue;
    const int32_t* sp = sprof + ql * kStripe * stride;
    const bool top = s0 == 0;                  // no stripe above
    const bool bottom = s0 + kStripe >= qlen;  // no stripe below

    int H[kStripe], E[kStripe];
#pragma unroll
    for (int r = 0; r < kStripe; ++r) {
      H[r] = 0;
      E[r] = 0;
    }
    int above_prev = 0;  // the stripe above's bottom-row H at column i-1
    int next = tlen > 0 ? __ldg(tcol) : 0;
    for (int i = 0; i < tlen; ++i) {
      const int letter = next;
      if (i + 1 < tlen) next = __ldg(tcol + static_cast<int64_t>(i + 1) * n_t);
      const int32_t* col =
          sp + (static_cast<unsigned>(letter) < static_cast<unsigned>(a)
                    ? letter : a);
      int diag = 0;
      int f = kNeg;
      int2* cell = scr ? scr + static_cast<int64_t>(i) * n_t : nullptr;
      if (!top) {
        const int2 b = *cell;
        diag = above_prev;
        above_prev = b.x;
        f = b.y;
      }
#pragma unroll
      for (int r = 0; r < kStripe; ++r) {
        const int hp = max(diag + col[r * stride], E[r]);
        diag = H[r];
        E[r] = max(max(hp - gap_open, E[r] - gap_extend), 0);
        const int h = max(hp, f);
        f = max(hp - gap_open, f - gap_extend);
        H[r] = h;
        best = max(best, h);
      }
      if (!bottom) *cell = make_int2(H[kStripe - 1], f);
    }
  }
  if (active) out[static_cast<int64_t>(q) * n_t + t] = best;
}

template <int QT>
int launch(const void* q_prof, const void* q_len, const void* q_slot,
           const void* t_seqs, const void* t_len, int n_q, int lq, int a,
           int n_t, int lt, int gap_open, int gap_extend, void* scratch,
           void* out, void* stream) {
  if (n_q <= 0 || n_t <= 0) return 0;
  if (a <= 0 || a > kMaxAlpha || lq < 0 || lt < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int TT = kThreads / QT;
  const int64_t gy = (static_cast<int64_t>(n_q) + QT - 1) / QT;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((n_t + TT - 1) / TT, static_cast<unsigned>(gy));
  const size_t smem = sizeof(int32_t) * QT * kStripe * (a + 1);
  sw_dense_kernel<QT><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q_prof), static_cast<const int32_t*>(q_len),
      static_cast<const int32_t*>(q_slot), static_cast<const int32_t*>(t_seqs),
      static_cast<const int32_t*>(t_len), n_q, lq, a, n_t, lt, gap_open,
      gap_extend, static_cast<int2*>(scratch), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows per register stripe: a query longer than this needs a scratch slot
// of lt * n_t int2.
extern "C" int sw_dense_stripe() { return kStripe; }
// Largest profile width (letters) a launch takes.
extern "C" int sw_dense_max_alpha() { return kMaxAlpha; }
// Most queries one sw_batch launch takes.
extern "C" int sw_dense_max_queries() { return 65535 * 4; }

// B4: n_q queries x n_t targets on `stream`, 4 queries x 64 targets per
// block. q_slot[q] names the scratch slot of every query longer than one
// stripe. Returns cudaGetLastError() (0 = launched).
extern "C" int sw_batch(const void* q_prof, const void* q_len,
                        const void* q_slot, const void* t_seqs,
                        const void* t_len, int n_q, int lq, int a, int n_t,
                        int lt, int gap_open, int gap_extend, void* scratch,
                        void* out, void* stream) {
  return launch<4>(q_prof, q_len, q_slot, t_seqs, t_len, n_q, lq, a, n_t, lt,
                   gap_open, gap_extend, scratch, out, stream);
}

// B3: one query x n_t targets, 256 targets per block; a query longer than
// one stripe uses scratch slot 0.
extern "C" int sw_one_query(const void* q_prof, const void* q_len,
                            const void* t_seqs, const void* t_len, int lq,
                            int a, int n_t, int lt, int gap_open,
                            int gap_extend, void* scratch, void* out,
                            void* stream) {
  return launch<1>(q_prof, q_len, nullptr, t_seqs, t_len, 1, lq, a, n_t, lt,
                   gap_open, gap_extend, scratch, out, stream);
}
