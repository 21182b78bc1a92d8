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
// counts_kernel: K on the tensor cores, as the TPU formed it on the MXU.
// What bounds it on this card: the int8 product, 2 x 128 operations per
// cell of the rows that can match (|K| <= 6 * 127 = 762, so int8 x {0, 1}
// with int32 sums is exact). The design:
//   * the host compacts the rows that can match (thr <= 762; ~28 % of them
//     at catalog scale) into Qexp' with their thresholds and their query
//     tiles, padded to a multiple of 128 rows with rows that never hit;
//   * one block of 8 warps per 512-position target tile; each warp owns 64
//     positions and builds their one-hot Texp columns once, straight into
//     the registers of its B fragments (8 n-tiles x 4 k-steps of
//     mma.m16n8k32: a fragment's 4 bytes are 4 consecutive k of one
//     position, one if k is one of that position's six p*21 + letter);
//   * every compacted row tile of 128 rows streams through a double
//     buffer in shared memory by cp.async (rows 144 bytes apart, so the
//     fragment loads are free of bank conflicts), and each warp runs it,
//     16 rows at a time, against its resident B fragments with
//     mma.sync.m16n8k32.s32.s8.s8.s32: per k-step one ldmatrix.x4 A
//     fragment feeds all 8 n-tiles (mma.sync rather than wgmma: the B
//     operand stays in registers for the whole block, and one instruction
//     shape covers the tile; wgmma would need B in shared memory and a
//     64-row warpgroup schedule, a later PR);
//   * the accumulator starts at -thr_i (the C operand, the same values for
//     every n-tile), so a hit is acc >= 0 and tval_j; a chain of three-way
//     maxima over a warp's 16 x 64 accumulators screens out the row
//     groups without one, and only those with one read tval and atomically
//     add their hits into counts[tile, query tile of the row] (zeroed by
//     the host). Integer adds do not depend on order, so the counts are
//     exact;
//   * registers are budgeted for two blocks (16 warps) per SM, 128 a
//     thread: ptxas spills a few, and this still ran faster on the card
//     than one block per SM without spills.
// emit_kernel keeps the gather of the first port: only tiles with a count >
// 0 are recomputed, K as six shared-memory lookups per cell; each hit takes
// a slot from a shared-memory atomic and lands at its tile's base (an
// exclusive prefix sum of the counts) plus the slot. Slots past the tile's
// count are never written, and each tile reports how many hits it found,
// so the host checks both passes against each other on every launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 256;                 // query k-mer rows per tile
constexpr int kTileT = 512;                 // target positions per tile
constexpr int kKdim = 128;                  // Qexp bytes per row
constexpr int kOff = 6;                     // spaced offsets
constexpr int kAlpha = 21;                  // letters per offset block
constexpr int kX = 20;                      // letter X (largest valid)
constexpr int kMaxK = kOff * 127;           // no K can exceed this
constexpr int kThreads = 256;
constexpr int kPos = kTileT / kThreads;     // target positions per thread

struct Offsets {
  int o[kOff];
};

struct Tile {
  __align__(16) int8_t q[kTileQ * kKdim];
  int32_t thr[kTileQ];
};

// Loads query tile qt (Qexp rows and thresholds) into shared memory and
// computes the caller's positions' column offsets and validity.
__device__ __forceinline__ void load_tile(
    const int8_t* __restrict__ qexp, const int32_t* __restrict__ thr,
    const uint8_t* __restrict__ letters, const uint8_t* __restrict__ tval,
    const Offsets& offs, int qt, int64_t tt, Tile& s, int (&col)[kPos][kOff],
    bool (&valid)[kPos]) {
  const int4* src = reinterpret_cast<const int4*>(
      qexp + static_cast<int64_t>(qt) * kTileQ * kKdim);
  int4* dst = reinterpret_cast<int4*>(s.q);
  for (int k = threadIdx.x; k < kTileQ * kKdim / 16; k += kThreads)
    dst[k] = src[k];
  for (int k = threadIdx.x; k < kTileQ; k += kThreads)
    s.thr[k] = thr[static_cast<int64_t>(qt) * kTileQ + k];
#pragma unroll
  for (int q = 0; q < kPos; ++q) {
    const int64_t j = tt * kTileT + threadIdx.x + q * kThreads;
    valid[q] = tval[j] != 0;
#pragma unroll
    for (int p = 0; p < kOff; ++p) {
      // the host passes letters <= X; the min keeps the shared-memory
      // index in bounds whatever the bytes hold
      const int a = min(static_cast<int>(letters[j + offs.o[p]]), kX);
      col[q][p] = p * kAlpha + a;
    }
  }
}

__device__ __forceinline__ int score(const int8_t* row, const int (&col)[kOff]) {
  int k = 0;
#pragma unroll
  for (int p = 0; p < kOff; ++p) k += row[col[p]];
  return k;
}

// counts_kernel's shapes: 8 warps of 64 positions, mma.m16n8k32 tiles
// over 128-row stages
constexpr int kRowTile = 128;               // compacted rows per stage
constexpr int kRowStride = kKdim + 16;      // shared bytes per row
constexpr int kWarpPos = kTileT / (kThreads / 32);   // 64
constexpr int kNT = kWarpPos / 8;           // n-tiles per warp
constexpr int kKS = kKdim / 32;             // k-steps

struct Stage {
  __align__(16) int8_t q[kRowTile * kRowStride];
  __align__(16) int32_t thr[kRowTile];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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
  const int64_t pos0 = tt * kTileT + warp * kWarpPos;
  load_stage(qexp, thr, 0, st[0]);

  // B fragments: the one-hot Texp columns of this thread's positions
  uint32_t b[kNT][kKS][2];
  uint32_t valid = 0;  // bit 2j + e: position pos0 + 8j + 2tq + e is valid
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

  // ldmatrix.x4: lanes 0-7, 8-15, 16-23, 24-31 address the rows of the
  // (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) blocks
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
      const int c_lo = -S.thr[m * 16 + g];
      const int c_hi = -S.thr[m * 16 + g + 8];
      int acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        acc[j][0] = acc[j][1] = c_lo;
        acc[j][2] = acc[j][3] = c_hi;
      }
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, S.q + (m * 16 + a_row) * kRowStride + ks * 32 +
                           a_col);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[j], a, b[j][ks]);
      }
      int mx = max(acc[0][0], acc[0][1]);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = __vimax3_s32(mx, acc[j][2], acc[j][3]);
#pragma unroll
      for (int j = 1; j < kNT; ++j)
        mx = __vimax3_s32(mx, acc[j][0], acc[j][1]);
      if (mx >= 0) {
        // rare: ~1e-6 of the cells hit
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

__global__ void __launch_bounds__(kThreads)
emit_kernel(const int8_t* __restrict__ qexp, const int32_t* __restrict__ thr,
            const uint8_t* __restrict__ letters,
            const uint8_t* __restrict__ tval, Offsets offs, int nqt,
            const int64_t* __restrict__ tiles,        // [n] flat tile ids
            const int64_t* __restrict__ base,         // [n] first slot
            const int32_t* __restrict__ tile_counts,  // [n] slots per tile
            int32_t* __restrict__ gi,                 // [total] query row
            int32_t* __restrict__ gj,                 // [total] position
            int32_t* __restrict__ written) {          // [n] hits found
  __shared__ Tile s;
  __shared__ int n_hits;
  const int64_t tile = tiles[blockIdx.x];
  const int qt = static_cast<int>(tile % nqt);
  const int64_t tt = tile / nqt;
  int col[kPos][kOff];
  bool valid[kPos];
  if (threadIdx.x == 0) n_hits = 0;
  load_tile(qexp, thr, letters, tval, offs, qt, tt, s, col, valid);
  __syncthreads();

  const int64_t b = base[blockIdx.x];
  const int cap = tile_counts[blockIdx.x];
  for (int i = 0; i < kTileQ; ++i) {
    const int t = s.thr[i];
    if (t > kMaxK) continue;
    const int8_t* row = s.q + i * kKdim;
#pragma unroll
    for (int q = 0; q < kPos; ++q) {
      if (score(row, col[q]) >= t && valid[q]) {
        const int slot = atomicAdd(&n_hits, 1);
        if (slot < cap) {
          gi[b + slot] = qt * kTileQ + i;
          gj[b + slot] =
              static_cast<int32_t>(tt * kTileT + threadIdx.x + q * kThreads);
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) written[blockIdx.x] = n_hits;
}

Offsets to_offsets(const int* offs) {
  Offsets o;
  for (int p = 0; p < kOff; ++p) o.o[p] = offs[p];
  return o;
}

}  // namespace

// Both launchers run on `stream` and return cudaGetLastError() (0 =
// launched). The caller guarantees the layouts in the kernels' parameter
// comments, C = ntt * 512 positions, 16-byte aligned qexp, and six
// host-side offsets in `offs` (unused ones 0, with zero Qexp columns). The
// counts launcher takes the compacted rows (n_rows of them, a multiple of
// 128, with their thresholds and query tiles); the emit launcher the
// original R = nqt * 256 rows.
// Rows per compacted row tile of the counts kernel: the host pads its
// compacted rows to a positive multiple of this.
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
    const void* qexp, const void* thr, const void* letters, const void* tval,
    const int* offs, int nqt, const void* tiles, const void* base,
    const void* tile_counts, int n_tiles, void* gi, void* gj, void* written,
    void* stream) {
  if (n_tiles <= 0) return 0;
  emit_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qexp), static_cast<const int32_t*>(thr),
      static_cast<const uint8_t*>(letters), static_cast<const uint8_t*>(tval),
      to_offsets(offs), nqt, static_cast<const int64_t*>(tiles),
      static_cast<const int64_t*>(base),
      static_cast<const int32_t*>(tile_counts), static_cast<int32_t*>(gi),
      static_cast<int32_t*>(gj), static_cast<int32_t*>(written));
  return static_cast<int>(cudaGetLastError());
}
