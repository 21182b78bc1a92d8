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
//   hit     = K[i, j] >= thr[i]  and  tval[j]
//
// The TPU formed K as a one-hot bf16 matmul on the MXU. Here K is what it
// is, a gather: six table lookups and five adds per cell.
//
// What bounds it on this card: shared-memory load issue. Each cell costs six
// 1-byte shared loads, a compare and a count, while a block reads 32 KB of
// Qexp and 512 x 7 target bytes once for 131,072 cells. The design follows
// from that:
//   * one block per (target tile of 512 positions, query tile of 256 rows),
//     the TPU kernel's grid; its 256 x 128 int8 Qexp rows (32 KB) and
//     thresholds sit in shared memory;
//   * each thread owns two target positions, reads their letters and tval
//     once, turns them into six column offsets, and walks the tile's rows:
//     a warp reading one 128-byte Qexp row at 32 positions' columns touches
//     each bank at most once (equal words broadcast), so lookups never
//     conflict;
//   * a row whose threshold exceeds 6 * 127, the largest K an int8 Qexp can
//     give, cannot match: invalid and pad rows (THR_INVALID) are skipped by
//     a branch that is uniform across the block. Spacer ORFs are ~11 residues
//     with ~3 valid k-mers, so most rows go;
//   * counts: warp shuffle and block reduction, one int32 per tile;
//   * emit: only tiles with a count > 0 are recomputed; each hit takes a slot
//     from a shared-memory atomic and lands at its tile's base (an exclusive
//     prefix sum of the counts) plus the slot. Slots past the tile's count
//     are never written, and each tile reports how many hits it found, so the
//     host can check both passes agree. Hits are rare (~1e-6 of the cells),
//     so the atomics cost nothing that shows.

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

__global__ void __launch_bounds__(kThreads)
counts_kernel(const int8_t* __restrict__ qexp,     // [R, 128]
              const int32_t* __restrict__ thr,     // [R]
              const uint8_t* __restrict__ letters, // [>= C + max offset]
              const uint8_t* __restrict__ tval,    // [C]
              Offsets offs, int nqt,
              int32_t* __restrict__ counts) {      // [C / 512, nqt]
  __shared__ Tile s;
  __shared__ int warp_sum[kThreads / 32];
  const int qt = blockIdx.x % nqt;
  const int64_t tt = blockIdx.x / nqt;
  int col[kPos][kOff];
  bool valid[kPos];
  load_tile(qexp, thr, letters, tval, offs, qt, tt, s, col, valid);
  __syncthreads();

  int n = 0;
  for (int i = 0; i < kTileQ; ++i) {
    const int t = s.thr[i];
    if (t > kMaxK) continue;                  // uniform across the block
    const int8_t* row = s.q + i * kKdim;
#pragma unroll
    for (int q = 0; q < kPos; ++q)
      n += (score(row, col[q]) >= t && valid[q]) ? 1 : 0;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_down_sync(0xffffffffu, n, d);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    counts[blockIdx.x] = total;
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
// comments, R = nqt * 256 rows, C = ntt * 512 positions, 16-byte aligned
// qexp, and six host-side offsets in `offs` (unused ones 0, with zero Qexp
// columns).
extern "C" int prefilter_dense_counts_launch(const void* qexp, const void* thr,
                                             const void* letters,
                                             const void* tval, const int* offs,
                                             int nqt, int ntt, void* counts,
                                             void* stream) {
  if (nqt <= 0 || ntt <= 0) return 0;
  const int64_t blocks = static_cast<int64_t>(nqt) * ntt;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  counts_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qexp), static_cast<const int32_t*>(thr),
      static_cast<const uint8_t*>(letters), static_cast<const uint8_t*>(tval),
      to_offsets(offs), nqt, static_cast<int32_t*>(counts));
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
