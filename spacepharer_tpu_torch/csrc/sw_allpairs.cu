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
// What bounds both on this card: integer ALU issue and, where one thread
// walks a long target, the latency of its serial chain; not bytes. Each DP
// cell is ~6-10 int32 add/max ops plus one profile read, while a thread
// reads one target byte per column and writes one int per pair.
// The dense entry's design:
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
// many short queries (spacer ORFs of 9-45 residues) with a few candidate
// targets each, and the targets' lengths have a long tail: on phase 3 of
// chip_smoke.py the median pair's serial work (stripes x target length) is
// 82 columns and the longest 1,522. One thread per pair let that pair's
// column walk set the launch time (0.21 ms of 0.24), so the pairs split in
// two classes, scored in one launch:
//   * pair_keys_kernel gives each pair an int16 sort key: a pair whose
//     serial work reaches the host's split (sw_packed.PAIR_TAIL_WORK) is a
//     TAIL pair and sorts first, longest first; the BULK follows by stripe
//     count, row class and target length, so a warp's threads walk the same
//     stripes over near-equal targets. The host sorts the keys once;
//   * the first blocks take the tail, a half-warp a pair (two pairs of
//     near-equal work a warp), so that they start first: lanes over column
//     blocks (tail_pair). Each lane owns 16 target columns of a 256-column
//     pass and walks the stripe's rows one step behind its left neighbour,
//     16 cells a step, so the 1,495-column pair takes 6 passes of 31 steps
//     where one thread took 1,495 columns of 16 dependent rows. Kept over
//     two anti-diagonal wavefronts with lanes over rows, measured on phase
//     3's pairs (PERF.md, section 6): lanes over one column's 32 rows, F
//     from a warp max-plus scan (a column's chain is seven shuffles: twice
//     the time), and lanes over the rows of a 16-row stripe, one or two a
//     lane (a step's chain is one shuffle and one or two add-maxes, but a
//     lone warp issues all ~25 instructions of a step, ~80 cycles, and the
//     longest pair has 1,510 steps);
//   * the other blocks take the bulk, a thread a pair: the query side is a
//     per-query int8 profile, bias folded in, laid out [stripe][letter] x
//     16 rows, so one column of one stripe is one aligned 16-byte word read
//     through L1/L2 (512 bytes per stripe; phase 3's ~13 MB stay in the
//     50 MB L2). No shared memory, so no bank conflicts: the cost that takes
//     their place is a warp's distinct 16-byte words per load, which
//     chip_smoke.py counts. A query of at most 12 rows runs a 12-row
//     variant (variants of 8, 10, 12 and 14 rows ran slower). Targets
//     are read where they lie, the search's whole target DB uploaded once
//     (not 16-aligned per target, padded by T_PAD bytes past its end): 4
//     letters per funnel-shifted pair of aligned 32-bit loads, the next
//     group's profile words in flight while a group runs;
//   * the profile's int8 range holds every shipped matrix plus the int8
//     bias (the host checks it); pad rows and letters the matrix lacks
//     hold -128, which cannot raise a score for the reason above;
//   * the cell update is four Hopper DPX instructions and two plain ones,
//     as in csrc/sw_dense.cu; two rows share a three-way max into the best.

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

constexpr int kPairThreads = 128;  // threads per block (pair-list entry)
constexpr int kGroup = 4;          // target columns per 32-bit letter load
constexpr int kTailLanes = 16;     // lanes of a tail pair, a block each
constexpr int kTailPairs = kPairThreads / kTailLanes;  // tail pairs a block
constexpr int kPassCols = kTailLanes * kStripe;  // target columns a pass
constexpr int kShortRows = 12;     // rows of the short bulk variant
// int16 sort keys: a tail pair's holds kTailKey and its work, above every
// bulk pair's: stripes (2 bits), whether the query has more than kShortRows
// rows (1 bit), target length (11 bits), each clamped to its bits
constexpr int kTailKey = 1 << 14;
constexpr int kKeyLenBits = 11;
// a scratch line's length rounds up to this: the tail writes a lane's 16
// columns whole, the bulk 4-column groups
constexpr int kLineCols = kStripe;
static_assert(kLineCols % kGroup == 0, "the bulk writes whole groups");
constexpr uint32_t kFull = 0xffffffffu;

// Row r's score, sign-extended from the int8 column word of a stripe: one
// PRMT whose selector takes byte r % 4 and fills the rest with its sign bit
// (r is a constant wherever the loops are unrolled).
__device__ __forceinline__ int profile_row(const uint4& w, int r) {
  const uint32_t word = r < 4 ? w.x : r < 8 ? w.y : r < 12 ? w.z : w.w;
  const uint32_t b = r & 3;
  int v;
  asm("prmt.b32 %0, %1, 0, %2;"
      : "=r"(v)
      : "r"(word), "r"(b | (8 | b) << 4 | (8 | b) << 8 | (8 | b) << 12));
  return v;
}

// The letters of columns c .. c + 3 of the target at tp, one per byte, from
// two aligned 32-bit loads (the host pads t_seqs so that they stay inside).
__device__ __forceinline__ uint32_t letters4(const uint8_t* tp, int c) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(tp + c);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  return __funnelshift_r(__ldg(w), __ldg(w + 1),
                         8 * static_cast<uint32_t>(a & 3));
}

// The two aligned 32-bit words that hold the letters of columns c .. c + 3,
// and the shift that letters4 would take; the caller funnel-shifts them
// when it needs the letters, so the loads' latency is not waited for here.
__device__ __forceinline__ void letter_words(const uint8_t* tp, int c,
                                             uint32_t& w0, uint32_t& w1,
                                             uint32_t& sh) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(tp + c);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  w0 = __ldg(w);
  w1 = __ldg(w + 1);
  sh = 8 * static_cast<uint32_t>(a & 3);
}

// Letter k of a letters4 word at column c, the pad letter past the target's
// end; the mask keeps every profile index in bounds whatever the bytes hold.
__device__ __forceinline__ int letter_at(uint32_t w, int k, int c, int tlen) {
  return c + k < tlen ? (w >> (8 * k)) & (kAlpha - 1) : kAlpha - 1;
}

// A bulk pair: one thread, the kRows rows of a 16-row stripe in registers,
// the stripes one after the other (kRows = 12 takes a query of at most 12
// rows, one stripe, and skips the 4 pad rows that the 16-row stripe would
// compute). A group of 4 columns is one branch-free block: its columns
// run whole (pad letters past the target's end), the stripe above's bottom
// row comes in and this stripe's goes out as two 16-byte words of the
// scratch line, so the compiler overlaps a column's 16-deep F chain with the
// next columns' rows; a cell waits on its left and upper-left neighbours.
template <int kRows>
__device__ __forceinline__ int bulk_pair(const uint4* qp, int qlen,
                                         const uint8_t* tp, int tlen,
                                         int2* scr, int gap_open,
                                         int neg_ge) {
  int best = 0;
  for (int s0 = 0; s0 < qlen; s0 += kStripe, qp += kAlpha) {
    const bool top = s0 == 0;                    // no stripe above
    const bool bottom = s0 + kStripe >= qlen;    // no stripe below
    int H[kRows], E[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      H[r] = 0;
      E[r] = 0;
    }
    int above_prev = 0;  // stripe-above bottom-row H at column i-1
    // in flight while a group of 4 columns runs, loaded without a branch
    // and first used by the next group: that group's profile words, and
    // the two aligned words that hold the letters of the group after it
    // (read from min(column, tlen), inside the T_PAD bytes past the end)
    uint4 next[kGroup];
    uint32_t lw0 = 0, lw1 = 0, lsh = 0;
    if (tlen > 0) {
      const uint32_t lw = letters4(tp, 0);
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        next[k] = __ldg(qp + letter_at(lw, k, 0, tlen));
      letter_words(tp, min(kGroup, tlen), lw0, lw1, lsh);
    }
    for (int c = 0; c < tlen; c += kGroup) {
      uint4 cur[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) cur[k] = next[k];
      int4 in01 = make_int4(0, kNeg, 0, kNeg), in23 = in01;  // (H, F) x 2
      if (!top) {
        const int4* line = reinterpret_cast<const int4*>(scr + c);
        in01 = line[0];
        in23 = line[1];
      }
      const int in_h[kGroup] = {in01.x, in01.z, in23.x, in23.z};
      const int in_f[kGroup] = {in01.y, in01.w, in23.y, in23.w};
      const uint32_t ahead = __funnelshift_r(lw0, lw1, lsh);
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        next[k] = __ldg(qp + letter_at(ahead, k, c + kGroup, tlen));
      letter_words(tp, min(c + 2 * kGroup, tlen), lw0, lw1, lsh);
      int out_h[kGroup], out_f[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        int diag = above_prev;
        above_prev = in_h[k];
        int f = in_f[k];
#pragma unroll
        for (int r = 0; r < kRows; r += 2) {
          int h2[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int hp = __viaddmax_s32(diag, profile_row(cur[k], r + j),
                                          E[r + j]);
            diag = H[r + j];
            const int opened = hp - gap_open;
            E[r + j] = __viaddmax_s32_relu(E[r + j], neg_ge, opened);
            h2[j] = max(hp, f);
            f = __viaddmax_s32(f, neg_ge, opened);
            H[r + j] = h2[j];
          }
          best = __vimax3_s32(best, h2[0], h2[1]);
        }
        out_h[k] = H[kRows - 1];
        out_f[k] = f;
      }
      if (!bottom) {
        int4* line = reinterpret_cast<int4*>(scr + c);
        line[0] = make_int4(out_h[0], out_f[0], out_h[1], out_f[1]);
        line[1] = make_int4(out_h[2], out_f[2], out_h[3], out_f[3]);
      }
    }
  }
  return best;
}

// Tail pairs, the layout kept: a half-warp a pair (two pairs of near-equal
// work a warp), lanes over column blocks. In a pass over 256 target
// columns lane l owns the 16 columns from 256 p + 16 l and walks the
// stripe's 16 rows one a step, one step behind lane l - 1: at step s it
// computes row s - l of its block, 16 cells whose E runs along the row in
// the lane (E' = max(E - min(go, ge), diag + S - go, 0), exact since
// h_pre - go = max(diag + S - go, E - go): one add-max a cell on the
// chain) and whose F and upper-left H come down the column in the lane's
// registers. The H and E at the block's left edge come from lane l - 1 by
// shuffle, lane 0's from lane 15 of the previous pass through shared
// memory; the stripe above's bottom row (or 0 and kNeg) comes at the
// pass's start from the scratch line, and the bottom row goes there.
// Scores come from the pair's table, the stripe's profile widened to int32
// ([letter][row] in shared memory: the 16 lanes of a pair stand on 16
// different rows, so they read 16 different banks). A lane outside rows
// 0..15 keeps its registers; columns past the target's end read the pad
// letter and pad rows lie below every true row, so neither can raise a
// best score (see the top of this file). The pairs of a warp run the same
// loop counts (the larger of the two), so every shuffle names the whole
// warp: a pair out of stripes or passes scores an all -128 table, which
// leaves its best score as it was; a half without a pair
// (qlen = tlen = 0) does the same.
__device__ __forceinline__ int tail_pair(const uint4* qp, int qlen,
                                         const uint8_t* tp, int tlen,
                                         int2* scr, int gap_open,
                                         int gap_extend, int* tbl,
                                         int2* edge, int lane) {
  const int l = lane & (kStripe - 1);
  const int neg_ge = -gap_extend;
  const int neg_min = -min(gap_open, gap_extend);
  const int stripes = (qlen + kStripe - 1) / kStripe;
  const int n_stripes = __reduce_max_sync(kFull, stripes);
  const int passes = (tlen + kPassCols - 1) / kPassCols;
  const int n_passes = __reduce_max_sync(kFull, passes);
  int best = 0;
  for (int si = 0; si < n_stripes; ++si, qp += kAlpha) {
    const bool active = si < stripes;            // this pair has stripe si
    const int rows = active ? min(kStripe, qlen - si * kStripe) : 1;
    const bool top = si == 0;                    // no stripe above
    const bool writes = si + 1 < stripes;        // a stripe below
    __syncwarp();  // the previous stripe's readers are done
    {
      // lane l widens letters 2l and 2l + 1: 32 bytes of the stripe
      const uint4* src = qp + 2 * l;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 w = active ? __ldg(src + h)
                               : make_uint4(0x80808080u, 0x80808080u,
                                            0x80808080u, 0x80808080u);
        int* dst = tbl + (2 * l + h) * kStripe;
#pragma unroll
        for (int r = 0; r < kStripe; ++r) dst[r] = profile_row(w, r);
      }
    }
    __syncwarp();
    // the last true row, the larger of the two pairs'
    const int n_rows = __reduce_max_sync(kFull, rows);
    int carry = 0;  // lane 15's top-row H at its last column, last pass
    for (int pass = 0; pass < n_passes; ++pass) {
      const int c0 = pass * kPassCols + l * kStripe;  // this lane's block
      // its letters' table offsets, the pad letter outside [0, tlen)
      int off[kStripe];
#pragma unroll
      for (int g = 0; g < kStripe / 4; ++g) {
        const uint32_t w = letters4(tp, min(c0 + 4 * g, tlen));
#pragma unroll
        for (int k = 0; k < 4; ++k)
          off[4 * g + k] = (c0 + 4 * g + k < tlen
                                ? (w >> (8 * k)) & (kAlpha - 1)
                                : kAlpha - 1) * kStripe;
      }
      // the row above the stripe over this block: H (the next row's
      // upper-left) and the F into row 0
      int hup[kStripe], f[kStripe];
      const bool fetch = active && !top && c0 < tlen;
#pragma unroll
      for (int k = 0; k < kStripe; ++k) {
        hup[k] = 0;
        f[k] = kNeg;
      }
      if (fetch) {
        const int4* line = reinterpret_cast<const int4*>(scr + c0);
#pragma unroll
        for (int k = 0; k < kStripe / 2; ++k) {
          const int4 v = line[k];
          hup[2 * k] = v.x;
          f[2 * k] = v.y;
          hup[2 * k + 1] = v.z;
          f[2 * k + 1] = v.w;
        }
      }
      // the corner above row 0 at the column left of the block: lane l
      // takes it from lane l - 1 as the row above the stripe at its last
      // column, the first value of its h_out; lane 0 from lane 15 of the
      // previous pass (0 in the first), which read it before that pass
      // wrote this stripe's bottom row over it in the line
      const int corner = __shfl_sync(kFull, carry, kStripe - 1, kStripe);
      carry = hup[kStripe - 1];
      // this lane's last row at its right edge, first the row above the
      // stripe
      int h_out = hup[kStripe - 1], e_out = 0;
      int left_h_prev = corner;    // H left of the block, one row up
      for (int s = 0; s < n_rows + kStripe - 1; ++s) {
        const int r = s - l;
        // the left edge of row r: lane l - 1's last row, lane 0's from
        // lane 15 of the previous pass (0 and 0 in the first)
        int left_h = __shfl_up_sync(kFull, h_out, 1, kStripe);
        int left_e = __shfl_up_sync(kFull, e_out, 1, kStripe);
        if (l == 0) {
          const int2 v = pass > 0 && s < n_rows ? edge[s] : make_int2(0, 0);
          left_h = v.x;
          left_e = v.y;
        }
        if (static_cast<unsigned>(r) < static_cast<unsigned>(n_rows)) {
          const int* row = tbl + r;
          int diag = left_h_prev;
          int e = left_e;
          int hmax = 0;
#pragma unroll
          for (int k = 0; k < kStripe; ++k) {
            const int sc = row[off[k]];
            const int hp = __viaddmax_s32(diag, sc, e);
            e = __viaddmax_s32_relu(e, neg_min, diag + sc - gap_open);
            diag = hup[k];
            const int h = max(hp, f[k]);
            f[k] = __viaddmax_s32(f[k], neg_ge, hp - gap_open);
            hup[k] = h;
            hmax = k & 1 ? __vimax3_s32(hmax, h, hup[k - 1]) : hmax;
          }
          best = max(best, hmax);
          h_out = hup[kStripe - 1];
          e_out = e;
          if (l == kStripe - 1) edge[r] = make_int2(h_out, e_out);
        }
        left_h_prev = left_h;
      }
      // a stripe below has 16 rows here, so hup and f hold row 15's H and
      // the F out of it
      if (writes && c0 < tlen) {
        int4* line = reinterpret_cast<int4*>(scr + c0);
#pragma unroll
        for (int k = 0; k < kStripe / 2; ++k)
          line[k] = make_int4(hup[2 * k], f[2 * k], hup[2 * k + 1],
                              f[2 * k + 1]);
      }
      __syncwarp();  // lane 15's edge is written before lane 0 reads it
    }
  }
#pragma unroll
  for (int d = kStripe / 2; d; d >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, d, kStripe));
  return best;
}

// Each pair's sort key, scratch need and the launch's counts: tail pairs
// (serial work stripes x target length >= tail_work) above every bulk pair,
// longest first; bulk pairs by stripe count, then target length, clamped
// into their bits (the order is a matter of speed, never of the scores).
// A pair whose query is longer than one stripe needs a scratch line, which
// hands each stripe's bottom row to the next stripe: its target's length in
// int2s, rounded up to kLineCols. This is the one place that sizes a line:
// the scoring kernel finds each line's start in the running sum of these.
__global__ void __launch_bounds__(kPairThreads)
pair_keys_kernel(const int32_t* __restrict__ q_len,    // [n_q]
                 const int64_t* __restrict__ t_off,    // [n_t + 1]
                 const int32_t* __restrict__ pair_q,   // [n]
                 const int32_t* __restrict__ pair_t,   // [n]
                 int n, long long tail_work,
                 int16_t* __restrict__ key,            // [n]
                 int64_t* __restrict__ need,           // [n] int2s
                 unsigned long long* __restrict__ stats) {  // tail, cells
  const int p = blockIdx.x * kPairThreads + threadIdx.x;
  unsigned tail = 0;
  unsigned long long cells = 0;
  if (p < n) {
    const int qlen = q_len[pair_q[p]];
    const int64_t t = pair_t[p];
    const int tlen = static_cast<int>(t_off[t + 1] - t_off[t]);
    const int stripes = (qlen + kStripe - 1) / kStripe;
    const long long work = static_cast<long long>(stripes) * tlen;
    tail = work >= tail_work;
    key[p] = static_cast<int16_t>(
        tail ? kTailKey | static_cast<int>(min(
                              work, static_cast<long long>(kTailKey - 1)))
             : min(stripes, 3) << (kKeyLenBits + 1) |
                   (qlen > kShortRows) << kKeyLenBits |
                   min(tlen, (1 << kKeyLenBits) - 1));
    need[p] = qlen > kStripe ? (tlen + kLineCols - 1) / kLineCols * kLineCols
                             : 0;
    cells = static_cast<unsigned long long>(qlen) * tlen;
  }
  tail = __reduce_add_sync(kFull, tail);
#pragma unroll
  for (int d = 16; d; d >>= 1) cells += __shfl_xor_sync(kFull, cells, d);
  if ((threadIdx.x & 31) == 0) {
    if (tail) atomicAdd(stats, static_cast<unsigned long long>(tail));
    if (cells) atomicAdd(stats + 1, cells);
  }
}

// One launch for both classes. The first blocks take the tail, four pairs
// of pairs each, a half-warp a pair, so that they start first; block b of T
// takes the pairs of pairs b, b + T, b + 2T and b + 3T, so every block
// holds heavy and light ones alike. The other blocks take the bulk, a
// thread a pair. Sorted position i is pair order[i]; its score lands at
// out[pair].
__global__ void __launch_bounds__(kPairThreads)
sw_pairs_kernel(const uint4* __restrict__ prof,        // [stripes][32] x 16 int8
                const int64_t* __restrict__ q_stripe,  // [n_q] first stripe
                const int32_t* __restrict__ q_len,     // [n_q]
                const uint8_t* __restrict__ t_seqs,    // [t_total + pad]
                const int64_t* __restrict__ t_off,     // [n_t + 1]
                const int32_t* __restrict__ pair_q,    // [*] query of a pair
                const int32_t* __restrict__ pair_t,    // [*] target of a pair
                const int64_t* __restrict__ order,     // [n] pair at position
                const int64_t* __restrict__ scr_end,   // [n] needs, summed
                int n, int n_tail, long long scr_base, int gap_open,
                int gap_extend, int2* __restrict__ scratch,
                int32_t* __restrict__ out) {
  __shared__ int tbl[kTailPairs][kAlpha * kStripe];
  __shared__ int2 edge[kTailPairs][kStripe];
  const int tail_blocks = (n_tail + kTailPairs - 1) / kTailPairs;
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) >= tail_blocks) {
    const int i = n_tail + (blockIdx.x - tail_blocks) * kPairThreads +
                  threadIdx.x;
    if (i >= n) return;  // no barrier follows
    const int64_t p = order[i];
    const int q = pair_q[p];
    const int qlen = q_len[q];
    const int64_t t0 = t_off[pair_t[p]];
    const int tlen = static_cast<int>(t_off[pair_t[p] + 1] - t0);
    int2* scr = scratch + (i > 0 ? scr_end[i - 1] - scr_base : 0);
    const uint4* qp = prof + q_stripe[q] * kAlpha;
    const uint8_t* tp = t_seqs + t0;
    out[p] = qlen <= kShortRows
                 ? bulk_pair<kShortRows>(qp, qlen, tp, tlen, scr, gap_open,
                                         -gap_extend)
                 : bulk_pair<kStripe>(qp, qlen, tp, tlen, scr, gap_open,
                                      -gap_extend);
    return;
  }
  // this warp's pair of pairs, and a half's pair in it
  const int i0 = 2 * ((threadIdx.x / 32) * tail_blocks + blockIdx.x);
  const int i = i0 + lane / kTailLanes;
  // a warp with one pair runs its other half on none: it must reach the
  // warp's shuffles; no barrier follows the return
  if (i0 >= n_tail) return;
  const bool has = i < n_tail;
  const int64_t p = has ? order[i] : 0;
  const int q = has ? pair_q[p] : 0;
  const int qlen = has ? q_len[q] : 0;
  const int64_t t0 = has ? t_off[pair_t[p]] : 0;
  const int tlen = has ? static_cast<int>(t_off[pair_t[p] + 1] - t0) : 0;
  int2* scr = scratch + (has && i > 0 ? scr_end[i - 1] - scr_base : 0);
  const uint4* qp = prof + (has ? q_stripe[q] : 0) * kAlpha;
  const int slot = threadIdx.x / kTailLanes;
  const int best = tail_pair(qp, qlen, t_seqs + t0, tlen, scr, gap_open,
                             gap_extend, tbl[slot], edge[slot], lane);
  if (has && (lane & (kTailLanes - 1)) == 0) out[p] = best;
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

// Zeroes the two counts of `stats` and launches the pair-list entry's key
// pass on `stream` for n pairs (the layouts in pair_keys_kernel's parameter
// comments); returns the first CUDA error (0 = launched).
extern "C" int sw_pairs_keys_launch(const void* q_len, const void* t_off,
                                    const void* pair_q, const void* pair_t,
                                    int n, long long tail_work, void* key,
                                    void* need, void* stats, void* stream) {
  cudaError_t err = cudaMemsetAsync(stats, 0, 2 * sizeof(unsigned long long),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const unsigned blocks = (static_cast<unsigned>(n) + kPairThreads - 1) /
                          kPairThreads;
  pair_keys_kernel<<<blocks, kPairThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q_len), static_cast<const int64_t*>(t_off),
      static_cast<const int32_t*>(pair_q), static_cast<const int32_t*>(pair_t),
      n, tail_work, static_cast<int16_t*>(key), static_cast<int64_t*>(need),
      static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// The pair-list entry's layout, for the host to check against its own
// copy: out[0..4] = kStripe, kTailKey, kKeyLenBits, kShortRows, kLineCols.
extern "C" void sw_pairs_layout(int* out) {
  const int layout[] = {kStripe, kTailKey, kKeyLenBits, kShortRows,
                        kLineCols};
  for (int k = 0; k < 5; ++k) out[k] = layout[k];
}

// Launches the pair-list entry on `stream` for the n sorted positions of
// `order` (the layouts in the kernel's parameter comments; the first n_tail
// positions hold the tail pairs; t_seqs readable 8 bytes past the last
// target) and returns cudaGetLastError() (0 = launched). The score of
// position i lands at out[order[i]]. Position i's scratch line (as long as
// the key pass sized it) starts scr_end[i - 1] - scr_base int2s into
// `scratch`, position 0's at its start.
extern "C" int sw_pairs_launch(const void* prof, const void* q_stripe,
                               const void* q_len, const void* t_seqs,
                               const void* t_off, const void* pair_q,
                               const void* pair_t, const void* order,
                               const void* scr_end, int n, int n_tail,
                               long long scr_base, int gap_open,
                               int gap_extend, void* scratch, void* out,
                               void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_tail + kTailPairs - 1) / kTailPairs) +
      (static_cast<unsigned>(n - n_tail) + kPairThreads - 1) / kPairThreads;
  sw_pairs_kernel<<<blocks, kPairThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(prof), static_cast<const int64_t*>(q_stripe),
      static_cast<const int32_t*>(q_len), static_cast<const uint8_t*>(t_seqs),
      static_cast<const int64_t*>(t_off), static_cast<const int32_t*>(pair_q),
      static_cast<const int32_t*>(pair_t), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(scr_end), n, n_tail, scr_base, gap_open,
      gap_extend, static_cast<int2*>(scratch), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
