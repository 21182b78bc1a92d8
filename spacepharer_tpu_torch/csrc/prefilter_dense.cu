// Dense k-mer prefilter on Hopper (sm_90a): per-tile hit counts and hit
// emission.
//
// Replaces the TPU Pallas kernel spacepharer_tpu/ops/prefilter_dense.py::
// _counts_kernel (entered through _counts_pallas) and the extraction around
// it (_extract_fn, which re-ran the product of 64 hit tiles at a time and
// copied their [64, 256, 512] boolean masks to the host for np.nonzero).
// Both compute, for query k-mer row i and target position j,
//
//   K[i, j] = sum_p Qexp[i, p*21 + t[j + off_p]]     (6 spaced offsets)
//           = (Qexp . Texp^T)[i, j],  Texp[j, p*21 + a] = [t[j + off_p] == a]
//   hit     = K[i, j] >= thr[i]  and  tval[j]
//
// Both kernels form K on the tensor cores, as the TPU formed it on the MXU,
// and what bounds each on this card is the int8 product, 2 x 128
// operations per cell of the rows that can match (|K| <= 6 * 127 = 762, so
// int8 x {0, 1} with int32 sums is exact): over every target position for
// counts_kernel, over the 512 positions of each hit tile for emit_kernel.
// The shared design:
//   * the host compacts the rows that can match (thr <= 762; ~28 % of them
//     at catalog scale) into Qexp' with their thresholds, query tiles and
//     original row ids, padded to a multiple of 128 rows with rows that
//     never hit; the kept rows stay in order, so each query tile owns one
//     contiguous range of them (qt_start);
//   * a block of 8 warps covers one 512-position target tile; each warp
//     owns 64 positions and builds their one-hot Texp columns once, straight
//     into the registers of its B fragments (8 n-tiles x 4 k-steps of
//     mma.m16n8k32: a fragment's 4 bytes are 4 consecutive k of one
//     position, one if k is one of that position's six p*21 + letter);
//   * stages of up to 128 compacted rows stream through a double buffer in
//     shared memory by cp.async (rows 144 bytes apart, so the fragment loads
//     are free of bank conflicts), and each warp runs a stage, 16 rows at a
//     time, against its resident B fragments with
//     mma.sync.m16n8k32.s32.s8.s8.s32: per k-step one ldmatrix.x4 A fragment
//     feeds all 8 n-tiles (mma.sync rather than wgmma: the B operand stays
//     in registers for the whole block, and one instruction shape covers the
//     tile; wgmma would need B in shared memory and a 64-row warpgroup
//     schedule);
//   * the accumulator starts at -thr_i (the C operand, the same values for
//     every n-tile), so a hit is acc >= 0 and tval_j; a chain of three-way
//     maxima over a warp's 16 x 64 accumulators screens out the row groups
//     without one (~1e-6 of the cells hit), and only those read tval;
//   * registers are budgeted for two blocks (16 warps) per SM, 128 a
//     thread: ptxas spills a few, and this still ran faster on the card
//     than one block per SM without spills.
// counts_kernel: one block per target tile streams every compacted row tile
// and atomically adds its hits into counts[tile, query tile of the row]
// (zeroed by the host). Integer adds do not depend on order, so the counts
// are exact.
// emit_kernel: one block per run of at most max_run hit tiles of one target
// tile (the host lists the hit tiles in ascending flat id and cuts the
// runs). It builds its B fragments once for the run, reads the run's
// tiles' row ranges into shared memory, and streams only each hit tile's
// own compacted rows: stages never cross a tile, and the rows
// past a stage's end, up to the next multiple of 16, are zeroed in shared
// memory with a threshold no K reaches, never read from device memory.
// Each hit takes a slot from its tile's shared-memory counter and lands at
// the tile's base (an exclusive prefix sum of the counts) plus the slot.
// Slots past the tile's count are never written, and each tile reports how
// many hits it found, so the host checks both passes against each other on
// every launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileT = 512;                 // target positions per tile
constexpr int kKdim = 128;                  // Qexp bytes per row
constexpr int kOff = 6;                     // spaced offsets
constexpr int kAlpha = 21;                  // letters per offset block
constexpr int kX = 20;                      // letter X (largest valid)
constexpr int kThreads = 256;
constexpr int kRowTile = 128;               // compacted rows per stage
constexpr int kRowStride = kKdim + 16;      // shared bytes per row
constexpr int kWarpPos = kTileT / (kThreads / 32);   // 64
constexpr int kNT = kWarpPos / 8;           // n-tiles per warp
constexpr int kKS = kKdim / 32;             // k-steps
constexpr int kNoHit = 1 << 30;             // threshold of a zeroed row
constexpr int kMaxRun = 256;                // most hit tiles per emit block

struct Offsets {
  int o[kOff];
};

struct Stage {
  __align__(16) int8_t q[kRowTile * kRowStride];
  __align__(16) int32_t thr[kRowTile];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16 x 32 int8, row) . b (32 x 8 int8, col), int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies compacted row tile `stage` (rows and thresholds) into `s`.
__device__ __forceinline__ void load_stage(const int8_t* __restrict__ qexp,
                                           const int32_t* __restrict__ thr,
                                           int stage, Stage& s) {
  const int8_t* src = qexp + static_cast<int64_t>(stage) * kRowTile * kKdim;
  for (int k = threadIdx.x; k < kRowTile * kKdim / 16; k += kThreads) {
    const int r = k / (kKdim / 16);
    const int c = (k % (kKdim / 16)) * 16;
    cp_async16(s.q + r * kRowStride + c, src + r * kKdim + c);
  }
  if (threadIdx.x < kRowTile / 4)
    cp_async16(s.thr + threadIdx.x * 4,
               thr + static_cast<int64_t>(stage) * kRowTile + threadIdx.x * 4);
  asm volatile("cp.async.commit_group;\n" ::);
}

// The B fragments of a warp's 64 positions pos0..: the one-hot Texp columns
// of this thread's positions. Returns their validity, bit 2j + e for
// position pos0 + 8j + 2tq + e (the accumulator columns the thread holds).
__device__ __forceinline__ uint32_t build_fragments(
    const uint8_t* __restrict__ letters, const uint8_t* __restrict__ tval,
    const Offsets& offs, int64_t pos0, int g, int tq,
    uint32_t (&b)[kNT][kKS][2]) {
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    int col[kOff];
    const int64_t n = pos0 + j * 8 + g;
#pragma unroll
    for (int p = 0; p < kOff; ++p)
      col[p] = p * kAlpha + min(static_cast<int>(letters[n + offs.o[p]]), kX);
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = s * 32 + h * 16 + tq * 4;
        uint32_t w = 0;
#pragma unroll
        for (int p = 0; p < kOff; ++p) {
          const int d = col[p] - k0;
          if (static_cast<unsigned>(d) < 4u) w |= 1u << (8 * d);
        }
        b[j][s][h] = w;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (tval[pos0 + j * 8 + tq * 2 + e]) valid |= 1u << (2 * j + e);
  }
  return valid;
}

// acc = -thr of 16 rows (c_lo of row g, c_hi of row g + 8) plus their K
// against the resident B fragments. `a` addresses this lane's ldmatrix.x4
// row: lanes 0-7, 8-15, 16-23, 24-31 address the rows of the (rows 0-7,
// k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) blocks. Returns the
// largest accumulator: >= 0 if any of the 16 x 64 cells reaches its
// threshold.
__device__ __forceinline__ int product16(int (&acc)[kNT][4], int c_lo,
                                         int c_hi, const int8_t* a,
                                         const uint32_t (&b)[kNT][kKS][2]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    acc[j][0] = acc[j][1] = c_lo;
    acc[j][2] = acc[j][3] = c_hi;
  }
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, a + ks * 32);
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_s8(acc[j], af, b[j][ks]);
  }
  int mx = max(acc[0][0], acc[0][1]);
#pragma unroll
  for (int j = 0; j < kNT; ++j) mx = __vimax3_s32(mx, acc[j][2], acc[j][3]);
#pragma unroll
  for (int j = 1; j < kNT; ++j) mx = __vimax3_s32(mx, acc[j][0], acc[j][1]);
  return mx;
}

// Two blocks per SM: 128 registers a thread, 16 warps per SM.
__global__ void __launch_bounds__(kThreads, 2)
counts_kernel(const int8_t* __restrict__ qexp,     // [n_stages * 128, 128]
              const int32_t* __restrict__ thr,     // [n_stages * 128]
              const int32_t* __restrict__ q_tile,  // [n_stages * 128]
              const uint8_t* __restrict__ letters, // [>= C + max offset]
              const uint8_t* __restrict__ tval,    // [C]
              Offsets offs, int n_stages, int nqt,
              int32_t* __restrict__ counts) {      // [C / 512, nqt], zeroed
  __shared__ Stage st[2];
  const int64_t tt = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;     // fragment row group / B column
  const int tq = lane & 3;     // thread in group
  load_stage(qexp, thr, 0, st[0]);
  uint32_t b[kNT][kKS][2];
  const uint32_t valid = build_fragments(letters, tval, offs,
                                         tt * kTileT + warp * kWarpPos, g,
                                         tq, b);

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  for (int s = 0; s < n_stages; ++s) {
    const Stage& S = st[s & 1];
    if (s + 1 < n_stages) {
      load_stage(qexp, thr, s + 1, st[(s + 1) & 1]);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll 1
    for (int m = 0; m < kRowTile / 16; ++m) {
      int acc[kNT][4];
      if (product16(acc, -S.thr[m * 16 + g], -S.thr[m * 16 + g + 8],
                    S.q + (m * 16 + a_row) * kRowStride + a_col, b) >= 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (acc[j][e] >= 0 && ((valid >> (2 * j + (e & 1))) & 1u)) {
              const int64_t row = static_cast<int64_t>(s) * kRowTile +
                                  m * 16 + g + (e >> 1) * 8;
              atomicAdd(counts + tt * nqt + q_tile[row], 1);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with S before it is refilled
  }
}

// Copies compacted rows a .. a + nr - 1 (nr <= kRowTile) and their
// thresholds into `s`; the rows from nr up to the next multiple of 16 are
// zeroed, with threshold kNoHit, and never read from device memory.
__device__ __forceinline__ void load_rows(const int8_t* __restrict__ qexp,
                                          const int32_t* __restrict__ thr,
                                          int a, int nr, Stage& s) {
  const int8_t* src = qexp + static_cast<int64_t>(a) * kKdim;
  const int end = (nr + 15) & ~15;
  for (int k = threadIdx.x; k < end * (kKdim / 16); k += kThreads) {
    const int r = k / (kKdim / 16);
    const int c = (k % (kKdim / 16)) * 16;
    if (r < nr)
      cp_async16(s.q + r * kRowStride + c, src + r * kKdim + c);
    else
      *reinterpret_cast<int4*>(s.q + r * kRowStride + c) = make_int4(0, 0, 0,
                                                                     0);
  }
  for (int r = threadIdx.x; r < end; r += kThreads) {
    if (r < nr)
      cp_async4(s.thr + r, thr + a + r);
    else
      s.thr[r] = kNoHit;
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Two blocks per SM, as counts_kernel.
__global__ void __launch_bounds__(kThreads, 2)
emit_kernel(const int8_t* __restrict__ qexp,        // [Rc, 128] compacted
            const int32_t* __restrict__ thr,        // [Rc]
            const int32_t* __restrict__ row_id,     // [Rc] original row
            const int32_t* __restrict__ qt_start,   // [nqt + 1]
            const uint8_t* __restrict__ letters,    // [>= C + max offset]
            const uint8_t* __restrict__ tval,       // [C]
            Offsets offs, int nqt,
            const int64_t* __restrict__ tiles,      // [n] flat ids, ascending
            const int32_t* __restrict__ run_start,  // [n_runs + 1]
            int max_run,
            const int64_t* __restrict__ base,       // [n] first slot
            const int32_t* __restrict__ tile_counts,  // [n] slots per tile
            int32_t* __restrict__ gi,               // [total] query row
            int32_t* __restrict__ gj,               // [total] position
            int32_t* __restrict__ written) {        // [n] hits found
  __shared__ Stage st[2];
  // per tile of the run: hits found, and its compacted rows lo .. hi - 1
  __shared__ int n_hits[kMaxRun], row_lo[kMaxRun], row_hi[kMaxRun];
  const int k0 = run_start[blockIdx.x];
  const int k1 = run_start[blockIdx.x + 1];
  if (k1 <= k0) return;
  if (k1 - k0 > max_run) {   // not a run the host cut: fail the check
    for (int k = k0 + threadIdx.x; k < k1; k += kThreads) written[k] = -1;
    return;
  }
  const int64_t tt = tiles[k0] / nqt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int n = k1 - k0;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int qt = static_cast<int>(tiles[k0 + t] % nqt);
    n_hits[t] = 0;
    row_lo[t] = qt_start[qt];
    row_hi[t] = qt_start[qt + 1];
  }
  __syncthreads();

  // the stages of the run: up to kRowTile rows of one tile's range at a
  // time; (k, r0) is the next one to load, rows r0.. of the range of the
  // run's tile k (its ranges sit in shared memory, so that no stage waits
  // on a device-memory load to find its rows)
  int k = 0, r0 = 0;
  auto next_stage = [&](int& sk, int& sa, int& snr) {
    const int lo = row_lo[k], hi = row_hi[k];
    sk = k;
    sa = lo + r0;
    snr = min(kRowTile, hi - sa);
    r0 += kRowTile;
    if (lo + r0 >= hi) {
      ++k;
      r0 = 0;
    }
  };
  int cur_k, cur_a, cur_nr;
  next_stage(cur_k, cur_a, cur_nr);
  load_rows(qexp, thr, cur_a, cur_nr, st[0]);
  const int64_t pos0 = tt * kTileT + warp * kWarpPos;
  uint32_t b[kNT][kKS][2];
  const uint32_t valid = build_fragments(letters, tval, offs, pos0, g, tq,
                                         b);

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  for (int s = 0;; ++s) {
    const Stage& S = st[s & 1];
    const bool more = k < n;
    int nxt_k = 0, nxt_a = 0, nxt_nr = 0;
    if (more) {
      next_stage(nxt_k, nxt_a, nxt_nr);
      load_rows(qexp, thr, nxt_a, nxt_nr, st[(s + 1) & 1]);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll 1
    for (int m = 0; m < (cur_nr + 15) / 16; ++m) {
      int acc[kNT][4];
      if (product16(acc, -S.thr[m * 16 + g], -S.thr[m * 16 + g + 8],
                    S.q + (m * 16 + a_row) * kRowStride + a_col, b) >= 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (acc[j][e] >= 0 && ((valid >> (2 * j + (e & 1))) & 1u)) {
              const int slot = atomicAdd(&n_hits[cur_k], 1);
              if (slot < tile_counts[k0 + cur_k]) {
                const int64_t at = base[k0 + cur_k] + slot;
                gi[at] = row_id[cur_a + m * 16 + g + (e >> 1) * 8];
                gj[at] = static_cast<int32_t>(pos0 + j * 8 + tq * 2 +
                                              (e & 1));
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with S before it is refilled
    if (!more) break;
    cur_k = nxt_k;
    cur_a = nxt_a;
    cur_nr = nxt_nr;
  }
  for (int t = threadIdx.x; t < n; t += kThreads) written[k0 + t] = n_hits[t];
}

Offsets to_offsets(const int* offs) {
  Offsets o;
  for (int p = 0; p < kOff; ++p) o.o[p] = offs[p];
  return o;
}

}  // namespace

// Both launchers run on `stream` and return cudaGetLastError() (0 =
// launched). The caller guarantees the layouts in the kernels' parameter
// comments, C = ntt * 512 positions, and six host-side offsets in `offs`
// (unused ones 0, with zero Qexp columns). Both take the compacted rows
// (n_rows of them, a multiple of 128, 16-byte aligned, with their
// thresholds; counts their query tiles, emit their original row ids and
// each query tile's first compacted row). The emit launcher takes n_runs
// runs of at most max_run (<= kMaxRun) listed tiles of one target tile
// each, run r being tiles run_start[r] .. run_start[r + 1] - 1.
// Rows per compacted row tile: the host pads its compacted rows to a
// positive multiple of this.
extern "C" int prefilter_dense_row_tile() { return kRowTile; }

extern "C" int prefilter_dense_counts_launch(const void* qexp, const void* thr,
                                             const void* q_tile,
                                             const void* letters,
                                             const void* tval, const int* offs,
                                             int n_rows, int nqt, int ntt,
                                             void* counts, void* stream) {
  if (ntt <= 0) return 0;
  if (n_rows <= 0 || n_rows % kRowTile)
    return static_cast<int>(cudaErrorInvalidValue);
  counts_kernel<<<static_cast<unsigned>(ntt), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qexp), static_cast<const int32_t*>(thr),
      static_cast<const int32_t*>(q_tile),
      static_cast<const uint8_t*>(letters), static_cast<const uint8_t*>(tval),
      to_offsets(offs), n_rows / kRowTile, nqt,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int prefilter_dense_emit_launch(
    const void* qexp, const void* thr, const void* row_id,
    const void* qt_start, const void* letters, const void* tval,
    const int* offs, int nqt, const void* tiles, const void* run_start,
    int n_runs, int max_run, const void* base, const void* tile_counts,
    void* gi, void* gj, void* written, void* stream) {
  if (n_runs <= 0) return 0;
  if (max_run <= 0 || max_run > kMaxRun)
    return static_cast<int>(cudaErrorInvalidValue);
  emit_kernel<<<static_cast<unsigned>(n_runs), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qexp), static_cast<const int32_t*>(thr),
      static_cast<const int32_t*>(row_id),
      static_cast<const int32_t*>(qt_start),
      static_cast<const uint8_t*>(letters), static_cast<const uint8_t*>(tval),
      to_offsets(offs), nqt, static_cast<const int64_t*>(tiles),
      static_cast<const int32_t*>(run_start), max_run,
      static_cast<const int64_t*>(base),
      static_cast<const int32_t*>(tile_counts), static_cast<int32_t*>(gi),
      static_cast<int32_t*>(gj), static_cast<int32_t*>(written));
  return static_cast<int>(cudaGetLastError());
}
