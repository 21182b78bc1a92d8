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
// int8 x {0, 1} with int32 sums is exact): over every target position
// for counts_kernel, over the 512 positions of each hit tile for
// emit_kernel. The host compacts the rows that can match (thr <= 762; ~28 %
// of them at catalog scale) into Qexp' with their thresholds, query tiles
// and original row ids, padded to a multiple of 128 rows with rows that
// never hit; the kept rows stay in order, so each query tile owns one
// contiguous range of them (qt_start).
//
// counts_kernel: every compacted row against every target position; each
// hit adds one to counts[target tile, query tile of the row] (zeroed by the
// host). Integer adds do not depend on order, so the counts are exact. It
// replaces an mma.sync design (8 warps per 512-position tile, the one-hot
// as register B fragments, stages by cp.async from every thread, the
// threshold screen in the warps that issue the products), which stayed
// under 40 % of the int8 rate: on Hopper only wgmma reaches it. Two things
// bound the kernel: the int8 tensor rate, and the bytes of the query
// stages, which every target span reads again from L2 into shared memory.
// The design:
//   * products on wgmma.mma_async.m64n128k32.s32.s8.s8. The target's
//     one-hot is the register A operand (M = 64 positions; a lane holds
//     positions g and g + 8 of its warp's 16, bytes tq*4.. and 16 + tq*4..
//     of each k-step, as mma.m16n8k32 lays out A), built once per target
//     span from shared memory: 16 registers a thread per 64 positions. A
//     stage of 128 query rows is the B operand in shared memory (N = 128,
//     K-major, each row's 128 bytes one line of the 128-byte swizzle).
//     That orientation leaves shared memory one operand to serve, 64 bytes
//     a clock at the full rate of an SM (the other, the one-hot as B in
//     shared memory and the query rows as A, reads A besides and writes
//     64 KB of one-hot per span);
//   * the thresholds ride in the product. Qexp's bytes 126 and 127 are
//     unused (6 x 21 = 126), so once a stage lands, two producer warps
//     write each row's -thr there in shared memory, as 64 c + d, and the
//     one-hot carries the constants 64 and 1 at those bytes: each product
//     leaves K - thr, the first k-step overwriting the accumulators. No
//     instruction initialises an accumulator or reads a threshold;
//   * the screen: a hit is an accumulator >= 0 at a position with tval. A
//     tree of three-way maxima (eight runs of eight, then those) screens
//     a thread's 64 accumulators; only a warp with a hit (the cells hit at
//     about 1e-5) looks further, and only into the runs that reached 0,
//     adding at each hit row's query tile, which the same producer warps
//     copy beside the stage in shared memory. Every warp of a warpgroup
//     waits for the slowest at its next product: on an H100, at a hit
//     density of 1.7e-5, a scan of all 64 accumulators that read the query
//     tiles from device memory held the kernel at 67 % of its bound, and
//     this screen at 83 % (90 % without hits);
//   * one producer and two consumer warpgroups per block. The producer's
//     first warp keeps a ring of kRing stages in flight, one TMA load of
//     the 128 x 128-byte rows per stage (a tensor map with the 128-byte
//     swizzle that the wgmma descriptor names); its second copies each
//     target span's letters and tval into one of two shared buffers, so
//     that no consumer waits on device memory to build its one-hot; the
//     last two patch. setmaxnreg drops the producer to 40 registers a
//     thread and raises the consumers to 232, what a consumer holds (64 of
//     A fragments and two accumulator sets of 64). Registers go to whole
//     warpgroups: a block of one producer warp and 8 consumer warps got
//     168 a thread, and spilled;
//   * each consumer warpgroup owns 256 of a span's 512 positions (4
//     m-tiles) and runs every stage against them. The m-tiles of a stage
//     alternate between the two accumulator sets: the next one's four
//     products are issued before the last one is waited for and screened
//     (wgmma.wait_group 1), so a warpgroup's screen runs under its own
//     products, and the two warpgroups run apart. No product stays in
//     flight past its stage: one carried across the loop's back edge, or
//     a spin on a barrier while products were in flight, made ptxas
//     serialize or drain every product of the kernel;
//   * a persistent grid of min(ntt, SMs) blocks, one per SM (about 105 KB
//     of shared memory), block b walking target tiles b, b + grid, ...: a
//     span of 512 positions gets 2 x 512 operations out of each byte it
//     reads from L2, about 1.9 TB/s of L2 at the full rate. The schedule
//     depends on n_rows / 128 stages and ntt alone.
// emit_kernel (mma.sync, unchanged since its redesign): one block of 8
// warps per run of at most max_run hit tiles of one target tile (the host
// lists the hit tiles in ascending flat id and cuts the runs). Each warp
// owns 64 of the tile's positions and builds their one-hot Texp columns
// once, straight into the registers of its B fragments (8 n-tiles x 4
// k-steps of mma.m16n8k32: a fragment's 4 bytes are 4 consecutive k of one
// position, one if k is one of that position's six p*21 + letter). The
// block reads the run's tiles' row ranges into shared memory and streams
// only each hit tile's own compacted rows, up to 128 at a time, through a
// double buffer by cp.async (rows 144 bytes apart, so the fragment loads
// are free of bank conflicts): stages never cross a tile, and the rows
// past a stage's end, up to the next multiple of 16, are zeroed in shared
// memory with a threshold no K reaches, never read from device memory.
// Each warp runs a stage 16 rows at a time with
// mma.sync.m16n8k32.s32.s8.s8.s32, one ldmatrix.x4 A fragment per k-step
// feeding all 8 n-tiles; the accumulator starts at -thr_i, so a hit is
// acc >= 0 and tval_j, and a chain of three-way maxima over a warp's 16 x
// 64 accumulators screens out the row groups without one. Registers are
// budgeted for two blocks (16 warps) per SM, 128 a thread. Each hit takes
// a slot from its tile's shared-memory counter and lands at the tile's
// base (an exclusive prefix sum of the counts) plus the slot. Slots past
// the tile's count are never written, and each tile reports how many hits
// it found, so the host checks both passes against each other on every
// launch.

#include <cuda.h>            // CUtensorMap and its enums (nothing linked)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileT = 512;                 // target positions per tile
constexpr int kKdim = 128;                  // Qexp bytes per row
constexpr int kOff = 6;                     // spaced offsets
constexpr int kAlpha = 21;                  // letters per offset block
constexpr int kX = 20;                      // letter X (largest valid)
constexpr int kThreads = 256;               // emit block
constexpr int kRowTile = 128;               // compacted rows per stage
constexpr int kRowStride = kKdim + 16;      // emit: shared bytes per row
constexpr int kWarpPos = kTileT / (kThreads / 32);   // 64
constexpr int kNT = kWarpPos / 8;           // n-tiles per warp
constexpr int kKS = kKdim / 32;             // k-steps
constexpr int kNoHit = 1 << 30;             // threshold of a zeroed row
constexpr int kMaxRun = 256;                // most hit tiles per emit block
// counts_kernel
constexpr int kCWarps = 8;                  // two consumer warpgroups
constexpr int kCThreads = kCWarps * 32 + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 40;           // registers a producer thread
constexpr int kConsumerRegs = 232;          // and a consumer thread
constexpr int kPatchThreads = kRowTile / 2;  // producer threads that patch
constexpr int kMaxK = kOff * 127;           // no K reaches further
constexpr int kRing = 6;                    // query stages in flight
constexpr int kStageBytes = kRowTile * kKdim;  // one TMA box, 16 KB
constexpr int kMaxOffset = 127;             // largest spaced offset
constexpr int kWin = kTileT + kMaxOffset;   // letters a span reads
constexpr int kGroupPos = kTileT / 2;       // positions per warpgroup
constexpr int kMT = kGroupPos / 64;         // its m-tiles
constexpr int kAcc = kRowTile / 2;          // accumulators a thread
static_assert(kMT == 4, "the consumer's stage runs four m-tiles");

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

// The shared memory of a counts block: the ring of query stages (each
// 1024-byte aligned, as the 128-byte swizzle needs) and their barriers, and
// two buffers of a target span's letters and tval.
struct CountsSmem {
  alignas(1024) int8_t q[kRing][kStageBytes];
  int32_t q_tile[kRing][kRowTile];   // the query tile of each row
  uint8_t letters[2][kWin];
  uint8_t tval[2][kTileT];
  uint64_t full[kRing];     // the TMA: the stage has landed
  uint64_t ready[kRing];    // each patching thread: thresholds written
  uint64_t empty[kRing];    // each consumer warp: done with the stage
  uint64_t span_full[2];    // each lane of the copying warp: span copied
  uint64_t span_empty[2];   // each consumer warp: its one-hot is built
};
constexpr int kCountsSmem = sizeof(CountsSmem) + 1024;   // with alignment

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of `bar` with this parity has completed (the
// loop in C++, so that the compiler reconverges the warp after it).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Rows row .. row + 127 of the compacted rows into `dst`, 128-byte
// swizzled, completing on `bar`.
__device__ __forceinline__ void tma_stage(void* dst, const CUtensorMap* map,
                                          int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// Writes -thr (clamped to what K can reach: thr in [-762, 763]) into bytes
// 126 and 127 of row r of a swizzled stage, as 64 c + d with d in [0, 64):
// against the one-hot's constant bytes 64 and 1 there, the product of the
// row is K - thr.
__device__ __forceinline__ void patch_threshold(int8_t* stage, int r,
                                                int thr) {
  const int v = -min(max(thr, -kMaxK), kMaxK + 1);
  const int c = v >> 6;                 // floor(v / 64)
  const int d = v - 64 * c;
  *reinterpret_cast<uint16_t*>(stage + r * kKdim + ((7 ^ (r & 7)) << 4) +
                               14) =
      static_cast<uint16_t>((c & 0xFF) | (d << 8));
}

// The wgmma descriptor of a K-major operand in shared memory under the
// 128-byte swizzle: start address / 16, leading offset 1 (unused by this
// layout), 1024 bytes between 8-row groups, layout 1 (128-byte swizzle).
// A k-step of 32 bytes adds 2 to it.
__device__ __forceinline__ uint64_t stage_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
__device__ __forceinline__ void fence_acc(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 64 accumulators of a product as asm operands %0 .. %63.
#define ACC64(c)                                                            \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),    \
  c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),       \
  c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),     \
  c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),     \
  c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),     \
  c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),     \
  c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),     \
  c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),     \
  c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define ACC_WRITE(x) "=r"(x)
#define ACC_UPDATE(x) "+r"(x)
#define WGMMA_S8                                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"

// d (64 positions x 128 rows, int32) = a (64 x 32 int8, registers) .
// b (32 x 128 int8 at desc, K-major): the first k-step of a product, which
// leaves d's old values unread.
__device__ __forceinline__ void wgmma_s8_first(int (&d)[kAcc],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(WGMMA_S8
               : ACC64(ACC_WRITE)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                 "r"(0));
}

// d += a . b, the later k-steps.
__device__ __forceinline__ void wgmma_s8(int (&d)[kAcc],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(WGMMA_S8
               : ACC64(ACC_UPDATE)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                 "r"(1));
}

// The one-hot of this thread's target positions as register A fragments:
// a[mt][ks][2 * kh + h] holds bytes k = ks*32 + kh*16 + tq*4 .. + 3 of
// position p(mt, h) = p0 + mt*64 + h*8 of the span: 1 where k is one of
// the position's six p*21 + letter (all below 126), and the constants 64
// and 1 at k = 126 and 127, against which the patched rows hold -thr.
// Returns their validity, bit 2 mt + h.
__device__ __forceinline__ uint32_t build_onehot(
    const uint8_t* __restrict__ win, const uint8_t* __restrict__ tv,
    const Offsets& offs, int p0, int tq, uint32_t (&a)[kMT][kKS][4]) {
  uint32_t valid = 0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + mt * 64 + h * 8;
      int col[kOff];
#pragma unroll
      for (int o = 0; o < kOff; ++o)
        col[o] = o * kAlpha + min(static_cast<int>(win[p + offs.o[o]]), kX);
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int k0 = ks * 32 + kh * 16 + tq * 4;
          uint32_t w = k0 == kKdim - 4 ? (64u << 16) | (1u << 24) : 0u;
#pragma unroll
          for (int o = 0; o < kOff; ++o) {
            const int d = col[o] - k0;
            if (static_cast<unsigned>(d) < 4u) w |= 1u << (8 * d);
          }
          a[mt][ks][2 * kh + h] = w;
        }
      }
      if (tv[p]) valid |= 1u << (2 * mt + h);
    }
  }
  return valid;
}

// Starts K - thr of one m-tile against the stage at desc: four k-steps,
// the first overwriting acc, committed as one group.
__device__ __forceinline__ void issue_mtile(int (&acc)[kAcc], uint64_t desc,
                                            const uint32_t (&a)[kKS][4]) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_s8_first(acc, a[0], desc);
#pragma unroll
  for (int ks = 1; ks < kKS; ++ks) wgmma_s8(acc, a[ks], desc + 2 * ks);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(acc);
}

// Waits until at most N groups of this warpgroup's products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Adds the hits of one finished m-tile: acc[4j + e] is position h = e >> 1
// (valid if bit h of `valid`) against row 8j + 2tq + (e & 1) of the stage
// (its query tile in qt, shared), a hit where it is >= 0.
__device__ __forceinline__ void screen_mtile(int (&acc)[kAcc],
                                             uint32_t valid,
                                             const int32_t* qt,
                                             int32_t* __restrict__ cnt,
                                             int tq) {
  fence_acc(acc);
  int m[8];   // the maxima of eight runs of eight, then of those
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int* v = acc + 8 * k;
    m[k] = max(__vimax3_s32(__vimax3_s32(v[0], v[1], v[2]), v[3], v[4]),
               __vimax3_s32(v[5], v[6], v[7]));
  }
  const int mx = __vimax3_s32(__vimax3_s32(m[0], m[1], m[2]),
                              __vimax3_s32(m[3], m[4], m[5]),
                              max(m[6], m[7]));
  if (__any_sync(0xffffffffu, mx >= 0)) {
    // only the runs that reached 0 (see the note at the top)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (m[k] >= 0) {
#pragma unroll
        for (int i = 8 * k; i < 8 * k + 8; ++i) {   // j = i / 4, e = i % 4
          if (acc[i] >= 0 && ((valid >> ((i & 3) >> 1)) & 1u))
            atomicAdd(cnt + qt[8 * (i >> 2) + 2 * tq + (i & 1)], 1);
        }
      }
    }
  }
  __syncwarp();
}

// One block per SM: 12 warps, whose registers setmaxnreg moves from the
// producer warpgroup to the consumers.
__global__ void __launch_bounds__(kCThreads, 1)
counts_kernel(const __grid_constant__ CUtensorMap rows,  // [n_stages * 128,
                                                         //  128] compacted
              const int32_t* __restrict__ thr,     // [n_stages * 128]
              const int32_t* __restrict__ q_tile,  // [n_stages * 128]
              const uint8_t* __restrict__ letters, // [>= C + max offset]
              const uint8_t* __restrict__ tval,    // [C]
              Offsets offs, int win, int n_stages, int nqt, int ntt,
              int32_t* __restrict__ counts) {      // [C / 512, nqt], zeroed
  extern __shared__ uint8_t smem_raw[];
  CountsSmem& sm = *reinterpret_cast<CountsSmem*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.ready[i], kPatchThreads);
      mbar_init(&sm.empty[i], kCWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.span_full[i], 32);
      mbar_init(&sm.span_empty[i], kCWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kCWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    int slot = 0;
    uint32_t phase = 0;
    if (warp == kCWarps) {   // the stages, by the TMA
      if (lane == 0) {
        for (int64_t tt = blockIdx.x; tt < ntt; tt += gridDim.x) {
          for (int s = 0; s < n_stages; ++s) {
            mbar_wait(&sm.empty[slot], phase ^ 1);
            mbar_expect_tx(&sm.full[slot], kStageBytes);
            tma_stage(sm.q[slot], &rows, s * kRowTile, &sm.full[slot]);
            if (++slot == kRing) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
      return;
    }
    if (warp == kCWarps + 1) {   // each span's letters and tval
      int buf = 0;
      for (int64_t tt = blockIdx.x; tt < ntt; tt += gridDim.x) {
        mbar_wait(&sm.span_empty[buf], phase ^ 1);
        const int64_t c0 = tt * kTileT;
        for (int i = lane; i < win; i += 32)
          sm.letters[buf][i] = letters[c0 + i];
        for (int i = lane; i < kTileT; i += 32)
          sm.tval[buf][i] = tval[c0 + i];
        mbar_arrive(&sm.span_full[buf]);
        if (++buf == 2) {
          buf = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // the last two warps: each landed stage's thresholds into its rows, and
    // the rows' query tiles beside it
    const int r = threadIdx.x - (kCWarps + 2) * 32;   // 0 .. 63
    for (int64_t tt = blockIdx.x; tt < ntt; tt += gridDim.x) {
      for (int s = 0; s < n_stages; ++s) {
        const int64_t row = static_cast<int64_t>(s) * kRowTile + r;
        const int t0 = thr[row], t1 = thr[row + kPatchThreads];
        const int g0 = q_tile[row], g1 = q_tile[row + kPatchThreads];
        mbar_wait(&sm.full[slot], phase);
        patch_threshold(sm.q[slot], r, t0);
        patch_threshold(sm.q[slot], r + kPatchThreads, t1);
        sm.q_tile[slot][r] = g0;
        sm.q_tile[slot][r + kPatchThreads] = g1;
        // the products read the rows through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&sm.ready[slot]);
        if (++slot == kRing) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns positions wg*256 .. + 255 of a span;
  // each stage's four m-tiles alternate between two accumulator sets, one
  // screened while the next is in flight, and none stays in flight past
  // the stage (a product carried across the loop's back edge made ptxas
  // serialize every product of the kernel)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tq = lane & 3;
  const int p0 = (warp >> 2) * kGroupPos + (warp & 3) * 16 + (lane >> 2);
  int slot = 0, buf = 0;
  uint32_t phase = 0, buf_phase = 0;
  uint32_t a[kMT][kKS][4];
  int acc0[kAcc], acc1[kAcc];
  for (int64_t tt = blockIdx.x; tt < ntt; tt += gridDim.x) {
    mbar_wait(&sm.span_full[buf], buf_phase);
    const uint32_t valid = build_onehot(sm.letters[buf], sm.tval[buf], offs,
                                        p0, tq, a);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.span_empty[buf]);
    if (++buf == 2) {
      buf = 0;
      buf_phase ^= 1;
    }
    int32_t* cnt = counts + tt * nqt;
    for (int s = 0; s < n_stages; ++s) {
      mbar_wait(&sm.ready[slot], phase);
      const uint64_t desc = stage_desc(sm.q[slot]);
      const int32_t* qt = sm.q_tile[slot];
      issue_mtile(acc0, desc, a[0]);
      issue_mtile(acc1, desc, a[1]);
      wgmma_wait<1>();
      screen_mtile(acc0, valid, qt, cnt, tq);
      issue_mtile(acc0, desc, a[2]);
      wgmma_wait<1>();
      screen_mtile(acc1, valid >> 2, qt, cnt, tq);
      issue_mtile(acc1, desc, a[3]);
      wgmma_wait<1>();
      screen_mtile(acc0, valid >> 4, qt, cnt, tq);
      wgmma_wait<0>();
      screen_mtile(acc1, valid >> 6, qt, cnt, tq);
      if (lane == 0) mbar_arrive(&sm.empty[slot]);
      if (++slot == kRing) {
        slot = 0;
        phase ^= 1;
      }
    }
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

// Two blocks per SM: 128 registers a thread, 16 warps per SM.
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

// cuTensorMapEncodeTiled from the driver, through the runtime (nothing is
// linked against libcuda), or null.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// Both launchers run on `stream` and return a CUDA error code (0 =
// launched). The caller guarantees the layouts in the kernels' parameter
// comments, C = ntt * 512 positions, and six host-side offsets in `offs`
// (unused ones 0, with zero Qexp columns). Both take the compacted rows
// (n_rows of them, a multiple of 128, 16-byte aligned, with their
// thresholds; counts their query tiles, emit their original row ids and
// each query tile's first compacted row). The counts launcher takes
// offsets of at most prefilter_dense_max_offset() and reads no Qexp byte
// 126 or 127 (none of 6 x 21 columns). The emit launcher takes n_runs
// runs of at most max_run (<= kMaxRun) listed tiles of one target tile
// each, run r being tiles run_start[r] .. run_start[r + 1] - 1.
// Rows per compacted row tile: the host pads its compacted rows to a
// positive multiple of this.
extern "C" int prefilter_dense_row_tile() { return kRowTile; }

extern "C" int prefilter_dense_max_offset() { return kMaxOffset; }

extern "C" int prefilter_dense_counts_launch(const void* qexp, const void* thr,
                                             const void* q_tile,
                                             const void* letters,
                                             const void* tval, const int* offs,
                                             int n_rows, int nqt, int ntt,
                                             void* counts, void* stream) {
  if (ntt <= 0) return 0;
  if (n_rows <= 0 || n_rows % kRowTile ||
      reinterpret_cast<uintptr_t>(qexp) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int max_off = 0;
  for (int p = 0; p < kOff; ++p) {
    if (offs[p] < 0 || offs[p] > kMaxOffset)
      return static_cast<int>(cudaErrorInvalidValue);
    max_off = offs[p] > max_off ? offs[p] : max_off;
  }
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the compacted rows as a 2-D uint8 tensor, one 128 x 128 box per stage
  CUtensorMap rows;
  const cuuint64_t dims[2] = {kKdim, static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {kKdim};
  const cuuint32_t box[2] = {kKdim, kRowTile};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(&rows, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<void*>(qexp), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(counts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCountsSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  counts_kernel<<<static_cast<unsigned>(ntt < sms ? ntt : sms), kCThreads,
                  kCountsSmem, static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const int32_t*>(thr),
      static_cast<const int32_t*>(q_tile),
      static_cast<const uint8_t*>(letters), static_cast<const uint8_t*>(tval),
      to_offsets(offs), kTileT + max_off, n_rows / kRowTile, nqt, ntt,
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
