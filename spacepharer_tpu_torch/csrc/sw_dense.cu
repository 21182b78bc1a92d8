// Dense all-pairs Smith-Waterman best scores on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of spacepharer_tpu/ops/sw_pallas.py:
// _sw_kernel (one query against every target, entered through
// sw_scores_one_query_pallas) and _sw_kernel_batch (Q queries against T
// targets, entered through sw_scores_pallas_batch). Both compute one
// function, which is also the per-shard scorer of the device mesh
// (spacepharer_tpu/parallel/sharding.py::sw_score_allpairs): the best local
// score, floored at 0, of every query profile q_prof int32 [Q, LQ, A] (rows
// j < q_len[q]) against every target (letters i < t_len[t]), with the
// Farrar E-from-pre-F recurrence of the reference's sw_sse2_byte:
//
//   h_pre = max(H[j-1](i-1) + S(j, t_i), E[j])      (E >= 0 gives the 0 floor)
//   E'[j] = max(h_pre - gap_open, E[j] - gap_extend, 0)
//   H[j]  = max(h_pre, F[j]);  F[j+1] = max(h_pre - gap_open, F[j] - gap_extend)
//   best  = max(best, H[j])
//
// The host (ops/sw_pallas.py) hands the targets over packed:
//
//   t_seqs uint8 [t_total]  each target's letters as one run starting at a
//                           multiple of 16 and padded to one, longest
//                           target first; a letter outside [0, A) is stored
//                           as A, a pad letter as A + 1
//   t_off  int64 [n_t]      start of each run;  t_len int32 [n_t] its length
//   t_idx  int64 [n_t]      the caller's index of each packed target
//
// (the layout of kernel B1's targets, ops/sw_packed.py::pack_runs). The
// shared profile has two extra columns: A scores 0 (the TPU kernels'
// one-hot product gives a letter outside the profile 0) and A + 1 holds
// kNeg.
//
// What bounds it on this card: integer ALU issue, not bytes. A true cell
// costs 6 int32 operations at the least (SW_OPS_PER_CELL in chip_smoke.py)
// and one shared-memory profile read; a thread reads one letter byte per
// column and writes one score per pair. The design:
//   * one thread per (query, target) pair; a block is one query x 128
//     length-sorted targets, so the 32 targets of a warp end together and
//     no warp idles behind a long neighbour, and every warp of a block
//     walks the same stripes; blocks of the longest targets are numbered
//     first and start first (2 or 4 queries per block measured no faster,
//     PERF.md);
//   * a thread fetches 16 letters with one 128-bit load;
//   * H and E of a STRIPE of 16 query rows live in registers (fully
//     unrolled), F runs down the column in one register, and the cell
//     update is four Hopper DPX instructions and two plain ones:
//     h_pre = __viaddmax_s32(diag, S, E), t = h_pre - gap_open,
//     E' = __viaddmax_s32_relu(E, -gap_extend, t), H = max(h_pre, F),
//     F' = __viaddmax_s32(F, -gap_extend, t), best = max(best, H);
//   * the query's profile stripe sits in shared memory as [row][letter]:
//     a warp reading one row at up to 32 distinct letters hits distinct
//     banks, equal letters broadcast;
//   * a query longer than one stripe walks its target once per stripe and
//     hands each column's bottom-row H and outgoing F to the next stripe
//     through a global scratch line laid out like the runs, [slot][t_total]
//     (the host gives a slot to every such query of a launch).
// Lanes stay int32: a 16-bit two-lane form would have to detect saturation
// and run again, and the kernel is exact at any query and target length.
// Pad rows (past a query's end inside its last stripe) and pad letters
// (past a target's end inside its last 16-letter chunk) read kNeg and never
// raise a score: E <= max(best - gap_open, 0) and F <= best - gap_open hold
// throughout, so such a cell's H is at most best.
// The TPU kernels' one-hot MXU gather and log2 shift-max cummax have no
// counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripe = 16;       // query rows per register stripe
constexpr int kThreads = 128;     // pairs per block
constexpr int kMaxAlpha = 128;    // profile columns a launch may have
constexpr int kNeg = -(1 << 24);  // pad rows and pad letters; initial F

__global__ void __launch_bounds__(kThreads)
sw_dense_kernel(const int32_t* __restrict__ q_prof,  // [n_q, lq, a]
                const int32_t* __restrict__ q_len,   // [n_q]
                const int32_t* __restrict__ q_slot,  // [n_q], -1 = none
                const uint8_t* __restrict__ t_seqs,  // [t_total] runs
                const int64_t* __restrict__ t_off,   // [n_t], 16-aligned
                const int32_t* __restrict__ t_len,   // [n_t]
                const int64_t* __restrict__ t_idx,   // [n_t]
                int n_q, int lq, int a, int n_t, int64_t t_total,
                int64_t ld_out, int gap_open, int gap_extend,
                int2* __restrict__ scratch,          // [slots, t_total]
                int32_t* __restrict__ out) {         // [n_q, ld_out]
  extern __shared__ int32_t sprof[];                 // [kStripe][a + 2]
  const int stride = a + 2;
  const int tile = static_cast<int>(blockIdx.x / n_q);
  const int q = static_cast<int>(blockIdx.x % n_q);
  const int t = tile * kThreads + threadIdx.x;
  const bool active = t < n_t;
  const int qlen = min(max(q_len[q], 0), lq);
  const int tlen = active ? t_len[t] : 0;
  const int n_chunks = (tlen + 15) >> 4;
  const int64_t off = active ? t_off[t] : 0;
  const uint4* tp = reinterpret_cast<const uint4*>(t_seqs + off);
  int2* scr = nullptr;
  if (active && qlen > kStripe)
    scr = scratch + static_cast<int64_t>(q_slot[q]) * t_total + off;
  const int neg_ge = -gap_extend;

  int best = 0;
  // qlen is block-uniform, so every thread reaches every barrier
  for (int s0 = 0; s0 < qlen; s0 += kStripe) {
    __syncthreads();  // the previous stripe's readers are done
    for (int k = threadIdx.x; k < kStripe * stride; k += kThreads) {
      const int r = k / stride;
      const int c = k % stride;
      int v = kNeg;
      if (s0 + r < qlen && c <= a)
        v = c < a ? q_prof[(static_cast<int64_t>(q) * lq + s0 + r) * a + c]
                  : 0;
      sprof[k] = v;
    }
    __syncthreads();
    if (!active) continue;
    const bool top = s0 == 0;                  // no stripe above
    const bool bottom = s0 + kStripe >= qlen;  // no stripe below

    int H[kStripe], E[kStripe];
#pragma unroll
    for (int r = 0; r < kStripe; ++r) {
      H[r] = 0;
      E[r] = 0;
    }
    int above_prev = 0;  // the stripe above's bottom-row H at column i-1
    for (int c = 0; c < n_chunks; ++c) {
      const uint4 w = __ldg(tp + c);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        // the host packs letters <= a + 1; the min keeps the shared-memory
        // index in bounds whatever the bytes hold
        const int letter =
            min(static_cast<int>((words[k >> 2] >> (8 * (k & 3))) & 0xffu),
                a + 1);
        const int32_t* col = sprof + letter;
        const int i = (c << 4) + k;
        int diag = 0;
        int f = kNeg;
        if (!top) {
          const int2 b = scr[i];
          diag = above_prev;
          above_prev = b.x;
          f = b.y;
        }
#pragma unroll
        for (int r = 0; r < kStripe; ++r) {
          const int hp = __viaddmax_s32(diag, col[r * stride], E[r]);
          diag = H[r];
          const int opened = hp - gap_open;
          E[r] = __viaddmax_s32_relu(E[r], neg_ge, opened);
          const int h = max(hp, f);
          f = __viaddmax_s32(f, neg_ge, opened);
          H[r] = h;
          best = max(best, h);
        }
        if (!bottom) scr[i] = make_int2(H[kStripe - 1], f);
      }
    }
  }
  if (active) out[static_cast<int64_t>(q) * ld_out + t_idx[t]] = best;
}

}  // namespace

// Rows per register stripe: a query longer than this needs a scratch slot
// of t_total int2.
extern "C" int sw_dense_stripe() { return kStripe; }
// Largest profile width (letters) a launch takes.
extern "C" int sw_dense_max_alpha() { return kMaxAlpha; }

// B3 and B4: n_q queries x n_t packed targets on `stream`, one query x 128
// targets per block; the score of (query p, packed target t) lands at
// out[p * ld_out + t_idx[t]]. q_slot[p] names the scratch slot of every
// query longer than one stripe. The caller guarantees the layouts above and
// a 16-byte aligned t_seqs. Returns cudaGetLastError() (0 = launched).
extern "C" int sw_dense_launch(const void* q_prof, const void* q_len,
                               const void* q_slot, const void* t_seqs,
                               const void* t_off, const void* t_len,
                               const void* t_idx, int n_q, int lq, int a,
                               int n_t, long long t_total, long long ld_out,
                               int gap_open, int gap_extend, void* scratch,
                               void* out, void* stream) {
  if (n_q <= 0 || n_t <= 0) return 0;
  if (a <= 0 || a > kMaxAlpha || lq < 0 || t_total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      static_cast<int64_t>(n_q) * ((n_t + kThreads - 1) / kThreads);
  if (blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(int32_t) * kStripe * (a + 2);
  sw_dense_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q_prof), static_cast<const int32_t*>(q_len),
      static_cast<const int32_t*>(q_slot), static_cast<const uint8_t*>(t_seqs),
      static_cast<const int64_t*>(t_off), static_cast<const int32_t*>(t_len),
      static_cast<const int64_t*>(t_idx), n_q, lq, a, n_t,
      static_cast<int64_t>(t_total), static_cast<int64_t>(ld_out), gap_open,
      gap_extend, static_cast<int2*>(scratch), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
