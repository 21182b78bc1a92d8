// Smith-Waterman best local scores on Hopper (sm_90a): kernel B1, with two
// entries.
//
// Replaces the TPU Pallas kernel spacepharer_tpu/ops/sw_packed.py::_kernel
// (entered through sw_allpairs_packed). Both entries compute its function,
// the exact affine-gap SW best local score of a query against a target, with
// per-query-row bias folded into the profile, X (letter 20) scored by the
// matrix, no score ceiling, and the Farrar E-from-pre-F recurrence of the
// reference's sw_sse2_byte:
//
//   h_pre = max(H[j-1](i-1) + S(j, t_i), E[j])      (E >= 0 gives the 0 floor)
//   E'[j] = max(h_pre - gap_open, E[j] - gap_extend, 0)
//   H[j]  = max(h_pre, F[j]);  F[j+1] = max(h_pre - gap_open, F[j] - gap_extend)
//   best  = max(best, H[j])
//
//   * sw_allpairs_kernel scores every query against every target (the TPU
//     kernel's dense [queries x targets] output);
//   * sw_pairs_kernel scores a list of (query, target) pairs, one score per
//     pair: the GPU scoring engine's entry, which needs the candidate pairs
//     of its host prefilter and nothing of the rectangle around them.
//
// What bounds both on this card: integer ALU issue and register pressure,
// not bytes. Each DP cell is ~6-10 int32 add/max ops plus one profile read,
// while a thread reads one target byte per column and writes one int per
// pair. Shared by both designs:
//   * one thread per (query, target) pair;
//   * H and E of a STRIPE of 16 query rows live in registers (fully
//     unrolled), F runs sequentially down the column in one register, so a
//     column costs no memory traffic beyond its letter and profile;
//   * a query longer than one stripe walks the target once per stripe and
//     hands each column's bottom-row H and outgoing F to the next stripe
//     through a global scratch line of target length (the host gives
//     scratch only to such queries, bounded per launch).
// There is no score ceiling and no query-length limit (the TPU kernel's
// BIG = 4096 segmentation offset and 2048-row block do not exist here).
// Pad rows (past a query's end, inside its last stripe) and pad letters
// carry a very negative profile value; such cells can never raise a best
// score, because E <= best - gap_open and F <= best - gap_open hold
// throughout, and a pad row lies below every true row, so it feeds none.
//
// sw_allpairs_kernel (the dense entry):
//   * a block = one query x 128 targets, so every branch on the query
//     (stripe count, rows) is uniform across the block;
//   * the stripe's int32 profile rows sit in shared memory as
//     [row][letter]: a warp reading row r at 32 different letters hits 32
//     distinct banks, and equal letters broadcast;
//   * targets are length-sorted by the host (warps finish together) and
//     16-byte aligned, so a thread fetches 16 letters with one 128-bit load.
//
// sw_pairs_kernel (the pair-list entry). The GPU engine's pairs come from
// many short queries with a few candidate targets each (spacer ORFs of 9-45
// residues), so a block of one query would leave most threads idle:
//   * a block = 128 consecutive pairs of a list the host sorted on the card
//     by stripe count, then target length, longest first: a warp's threads
//     walk the same stripes over near-equal targets and finish together,
//     whatever their queries; each score lands at the pair's own position;
//   * the query side is a per-query int8 profile, bias folded in, laid out
//     [stripe][letter] x 16 rows: one column of one stripe is one aligned
//     16-byte word, so a thread reads a column's 16 scores with one
//     128-bit load through L1/L2 (512 bytes per stripe; phase 3 of
//     chip_smoke.py keeps its ~13 MB in the 50 MB L2) and sign-extends each
//     byte. No shared memory, so no bank conflicts: the cost that takes
//     their place is a warp's distinct 16-byte words per load, which
//     chip_smoke.py counts on its pairs;
//   * the profile's int8 range holds every shipped matrix plus the int8
//     bias (the host checks it); pad rows and letters the matrix lacks
//     hold -128, which cannot raise a score for the reason above;
//   * targets are read where they lie, the search's whole target DB
//     uploaded once (not 16-aligned per target, padded by T_PAD bytes past
//     its end): 4 letters per funnel-shifted pair of aligned 32-bit loads.
//     A long pair's columns run one after the other, so latency, not
//     issue, bounds the longest warps: while a group of 4 columns runs,
//     the next group's 4 profile words and the letters of the group after
//     it are in flight;
//   * the cell update is four Hopper DPX instructions and two plain ones,
//     as in csrc/sw_dense.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripe = 16;    // query rows per register stripe
constexpr int kAlpha = 32;     // profile columns (letters), pad letter 31
constexpr int kThreads = 128;  // targets per block
constexpr int kNeg = -(1 << 24);

__global__ void __launch_bounds__(kThreads)
sw_allpairs_kernel(const int32_t* __restrict__ prof,     // [R, 32]
                   const int64_t* __restrict__ q_off,    // [n_q + 1]
                   const int32_t* __restrict__ q_slot,   // [n_q], -1 = none
                   const uint8_t* __restrict__ t_seqs,   // [t_total]
                   const int64_t* __restrict__ t_off,    // [n_t], 16-aligned
                   const int32_t* __restrict__ t_len,    // [n_t]
                   int n_t, int64_t t_total, int gap_open, int gap_extend,
                   int2* __restrict__ scratch,           // [slots, t_total]
                   int32_t* __restrict__ out) {          // [n_q, n_t]
  __shared__ int32_t sprof[kStripe][kAlpha];
  const int n_tiles = (n_t + kThreads - 1) / kThreads;
  const int q = blockIdx.x / n_tiles;
  const int t = (blockIdx.x % n_tiles) * kThreads + threadIdx.x;
  const bool active = t < n_t;

  const int64_t r0 = q_off[q];
  const int qlen = static_cast<int>(q_off[q + 1] - r0);
  const int tlen = active ? t_len[t] : 0;
  const int n_chunks = (tlen + 15) >> 4;
  const uint4* tp =
      reinterpret_cast<const uint4*>(t_seqs + (active ? t_off[t] : 0));
  int2* scr = nullptr;
  if (active && q_slot[q] >= 0)
    scr = scratch + static_cast<int64_t>(q_slot[q]) * t_total + t_off[t];

  int best = 0;
  for (int s0 = 0; s0 < qlen; s0 += kStripe) {
    const int nrows = min(kStripe, qlen - s0);
    __syncthreads();  // the previous stripe's readers are done
    for (int k = threadIdx.x; k < kStripe * kAlpha; k += kThreads) {
      const int r = k / kAlpha;
      sprof[r][k % kAlpha] = r < nrows ? prof[(r0 + s0 + r) * kAlpha + k % kAlpha]
                                       : kNeg;
    }
    __syncthreads();
    const bool top = s0 == 0;                    // no stripe above
    const bool bottom = s0 + kStripe >= qlen;    // no stripe below

    int H[kStripe], E[kStripe];
#pragma unroll
    for (int r = 0; r < kStripe; ++r) {
      H[r] = 0;
      E[r] = 0;
    }
    int above_prev = 0;  // stripe-above bottom-row H at column i-1
    for (int c = 0; c < n_chunks; ++c) {
      const uint4 w = tp[c];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        // the host packs letters < 32; the mask keeps the smem index
        // in bounds whatever the bytes hold
        const int letter = (words[k >> 2] >> (8 * (k & 3))) & (kAlpha - 1);
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
          const int hp = max(diag + sprof[r][letter], E[r]);
          diag = H[r];
          E[r] = max(max(hp - gap_open, E[r] - gap_extend), 0);
          const int h = max(hp, f);
          f = max(hp - gap_open, f - gap_extend);
          H[r] = h;
          best = max(best, h);
        }
        if (!bottom) scr[i] = make_int2(H[kStripe - 1], f);
      }
    }
  }
  if (active) out[static_cast<int64_t>(q) * n_t + t] = best;
}

constexpr int kPairThreads = 128;  // pairs per block (pair-list entry)
constexpr int kGroup = 4;          // target columns per 32-bit letter load

// Row r's score, sign-extended from the int8 column word of a stripe.
__device__ __forceinline__ int profile_row(const uint4& w, int r) {
  const uint32_t word = r < 4 ? w.x : r < 8 ? w.y : r < 12 ? w.z : w.w;
  return static_cast<int>(static_cast<int8_t>(word >> (8 * (r & 3))));
}

// The letters of columns c .. c + 3 of the target at tp, one per byte, from
// two aligned 32-bit loads (the host pads t_seqs so that they stay inside).
__device__ __forceinline__ uint32_t letters4(const uint8_t* tp, int c) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(tp + c);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  return __funnelshift_r(__ldg(w), __ldg(w + 1),
                         8 * static_cast<uint32_t>(a & 3));
}

__global__ void __launch_bounds__(kPairThreads)
sw_pairs_kernel(const uint4* __restrict__ prof,        // [stripes][32] x 16 int8
                const int64_t* __restrict__ q_stripe,  // [n_q] first stripe
                const int32_t* __restrict__ q_len,     // [n_q]
                const uint8_t* __restrict__ t_seqs,    // [t_total + pad]
                const int64_t* __restrict__ t_off,     // [n_t + 1]
                const int32_t* __restrict__ pair_q,    // [n] query of a pair
                const int32_t* __restrict__ pair_t,    // [n] target of a pair
                const int64_t* __restrict__ pair_pos,  // [n] output position
                const int64_t* __restrict__ scr_off,   // [n] int2s, -1 = none
                int n, int gap_open, int gap_extend,
                int2* __restrict__ scratch,
                int32_t* __restrict__ out) {
  const int p = blockIdx.x * kPairThreads + threadIdx.x;
  if (p >= n) return;  // no barrier follows
  const int q = pair_q[p];
  const int qlen = q_len[q];
  const int64_t t0 = t_off[pair_t[p]];
  const int tlen = static_cast<int>(t_off[pair_t[p] + 1] - t0);
  const uint8_t* tp = t_seqs + t0;
  const uint4* qp = prof + q_stripe[q] * kAlpha;
  int2* scr = scr_off[p] >= 0 ? scratch + scr_off[p] : nullptr;
  const int neg_ge = -gap_extend;
  constexpr uint32_t kMask = kAlpha - 1;  // keeps every profile index in
                                          // bounds whatever the bytes hold

  int best = 0;
  for (int s0 = 0; s0 < qlen; s0 += kStripe, qp += kAlpha) {
    const bool top = s0 == 0;                    // no stripe above
    const bool bottom = s0 + kStripe >= qlen;    // no stripe below
    int H[kStripe], E[kStripe];
#pragma unroll
    for (int r = 0; r < kStripe; ++r) {
      H[r] = 0;
      E[r] = 0;
    }
    int above_prev = 0;  // stripe-above bottom-row H at column i-1
    // in flight while a group of 4 columns runs: the next group's profile
    // words and the letters of the group after it
    uint4 next[kGroup];
    uint32_t ahead = 0;
    if (tlen > 0) {
      const uint32_t lw = letters4(tp, 0);
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        next[k] = __ldg(qp + ((lw >> (8 * k)) & kMask));
      if (tlen > kGroup) ahead = letters4(tp, kGroup);
    }
    for (int c = 0; c < tlen; c += kGroup) {
      uint4 cur[kGroup];
      int2 b[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        cur[k] = next[k];
        b[k] = !top && c + k < tlen ? scr[c + k] : make_int2(0, 0);
      }
      if (c + kGroup < tlen) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          next[k] = __ldg(qp + ((ahead >> (8 * k)) & kMask));
        if (c + 2 * kGroup < tlen) ahead = letters4(tp, c + 2 * kGroup);
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int i = c + k;
        if (i >= tlen) break;
        int diag = 0;
        int f = kNeg;
        if (!top) {
          diag = above_prev;
          above_prev = b[k].x;
          f = b[k].y;
        }
#pragma unroll
        for (int r = 0; r < kStripe; ++r) {
          const int hp = __viaddmax_s32(diag, profile_row(cur[k], r), E[r]);
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
  out[pair_pos[p]] = best;
}

}  // namespace

// Rows per register stripe: the host gives a scratch slot to every query
// longer than this.
extern "C" int sw_allpairs_stripe() { return kStripe; }

// Launches the kernel on `stream` for n_q queries x n_t targets and returns
// cudaGetLastError() (0 = launched). The caller guarantees the layouts in the
// kernel's parameter comments and 16-byte alignment of t_seqs + t_off[t].
extern "C" int sw_allpairs_launch(const void* prof, const void* q_off,
                                  const void* q_slot, const void* t_seqs,
                                  const void* t_off, const void* t_len,
                                  int n_q, int n_t, long long t_total,
                                  int gap_open, int gap_extend, void* scratch,
                                  void* out, void* stream) {
  const int64_t n_tiles = (n_t + kThreads - 1) / kThreads;
  const int64_t blocks = n_tiles * n_q;
  if (n_q <= 0 || n_t <= 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  sw_allpairs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(prof), static_cast<const int64_t*>(q_off),
      static_cast<const int32_t*>(q_slot), static_cast<const uint8_t*>(t_seqs),
      static_cast<const int64_t*>(t_off), static_cast<const int32_t*>(t_len),
      n_t, static_cast<int64_t>(t_total), gap_open, gap_extend,
      static_cast<int2*>(scratch), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches the pair-list entry on `stream` for n pairs (the layouts in the
// kernel's parameter comments; pairs in any order, a warp's best sorted by
// stripe count and target length; t_seqs readable 8 bytes past the last
// target) and returns cudaGetLastError() (0 = launched). The score of pair p lands at out[pair_pos[p]]. scr_off[p]
// names the first int2 of pair p's scratch line of its target's length for
// every pair whose query is longer than one stripe.
extern "C" int sw_pairs_launch(const void* prof, const void* q_stripe,
                               const void* q_len, const void* t_seqs,
                               const void* t_off, const void* pair_q,
                               const void* pair_t, const void* pair_pos,
                               const void* scr_off, int n, int gap_open,
                               int gap_extend, void* scratch, void* out,
                               void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (static_cast<unsigned>(n) + kPairThreads - 1) /
                          kPairThreads;
  sw_pairs_kernel<<<blocks, kPairThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(prof), static_cast<const int64_t*>(q_stripe),
      static_cast<const int32_t*>(q_len), static_cast<const uint8_t*>(t_seqs),
      static_cast<const int64_t*>(t_off), static_cast<const int32_t*>(pair_q),
      static_cast<const int32_t*>(pair_t),
      static_cast<const int64_t*>(pair_pos),
      static_cast<const int64_t*>(scr_off), n, gap_open, gap_extend,
      static_cast<int2*>(scratch), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
