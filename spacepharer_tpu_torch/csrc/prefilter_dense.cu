// Dense k-mer prefilter on Hopper (sm_90a): every hit of the query k-mer
// rows against a target chunk, in one pass.
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
// The TPU counted the hits per (target tile, query tile) first and then
// recomputed the tiles with hits to extract them. Here one kernel forms K
// once and writes each hit's coordinates where it finds it: the row's
// original id (gi) and its chunk-relative position (gj), into an append
// buffer in device memory, in no fixed order. A cursor counts every hit;
// hits past the buffer's capacity are counted and not written, so the host
// learns the exact number from one 8-byte read and runs the chunk again
// into a buffer of that size where it overflowed. The kernel is still
// named counts_kernel, for the pass it grew from.
//
// It forms K on the tensor cores, as the TPU formed it on the MXU, and
// what bounds it on this card is the int8 product, 2 x 128 operations per
// cell of the rows that can match over every target position (|K| <= 6 *
// 127 = 762, so int8 x {0, 1} with int32 sums is exact). The host compacts
// the rows that can match (thr <= 762; ~28 % of them at catalog scale)
// into Qexp' with their thresholds and original row ids, padded to a
// multiple of 128 rows with rows that never hit. Two things bound the
// kernel: the int8 tensor rate, and the bytes of the query stages, which
// every target span reads again from L2 into shared memory. The design:
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
//     about 1e-5) looks further, and only into the runs that reached 0.
//     Every warp of a warpgroup waits for the slowest at its next product:
//     on an H100, at a hit density of 1.7e-5, a scan of all 64
//     accumulators that read the query tiles from device memory held the
//     kernel at 67 % of its bound, and this screen at 83 % (90 % without
//     hits);
//   * the hits: a warp with hits stages them in its own area of shared
//     memory (kStageHits of them), one ballot per round in which some
//     lane still has one, each lane taking its lowest; the staged count is
//     the same in every lane, so no atomic is needed there. The rows'
//     original ids sit beside each stage in shared memory, copied there by
//     the producer warps that patch it. Only a full area, and each warp's
//     last, goes to device memory: one atomic add on the cursor reserves
//     its slots, and the warp writes them coalesced. A global atomic with
//     a return per hit would stall the warp, and with it its warpgroup's
//     next product, for a round trip to L2 at every hit;
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
//   * a persistent grid of min(ntt, SMs) blocks, one per SM (about 113 KB
//     of shared memory), block b walking target tiles b, b + grid, ...: a
//     span of 512 positions gets 2 x 512 operations out of each byte it
//     reads from L2, about 1.9 TB/s of L2 at the full rate. The schedule
//     depends on n_rows / 128 stages and ntt alone.

#include <cuda.h>            // CUtensorMap and its enums (nothing linked)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileT = 512;                 // target positions per tile
constexpr int kKdim = 128;                  // Qexp bytes per row
constexpr int kOff = 6;                     // spaced offsets
constexpr int kAlpha = 21;                  // letters per offset block
constexpr int kX = 20;                      // letter X (largest valid)
constexpr int kRowTile = 128;               // compacted rows per stage
constexpr int kKS = kKdim / 32;             // k-steps
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
constexpr int kStageHits = 128;             // hits a consumer warp stages
static_assert(kMT == 4, "the consumer's stage runs four m-tiles");

struct Offsets {
  int o[kOff];
};

// Where the hits go: hit k of the pass at gi[k] (the row's original id)
// and gj[k] (its chunk-relative position) while k < cap; *cursor counts
// every hit (zeroed before the launch).
struct HitOut {
  int32_t* gi;
  int32_t* gj;
  unsigned long long* cursor;
  unsigned long long cap;
};

// The shared memory of a counts block: the ring of query stages (each
// 1024-byte aligned, as the 128-byte swizzle needs) and their barriers,
// two buffers of a target span's letters and tval, and each consumer
// warp's staged hits.
struct CountsSmem {
  alignas(1024) int8_t q[kRing][kStageBytes];
  int32_t row_id[kRing][kRowTile];   // the original id of each row
  int2 hits[kCWarps][kStageHits];    // (gi, gj) of each staged hit
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

// Writes a consumer warp's n staged hits to device memory: one atomic add
// on the cursor reserves their slots, the lanes write them coalesced, and
// slots at or past the capacity are counted but not written.
__device__ __forceinline__ void flush_hits(const int2* st, int n,
                                           const HitOut& out, int lane) {
  __syncwarp();   // every lane's staged hits, seen by the warp
  unsigned long long base = 0;
  if (lane == 0)
    base = atomicAdd(out.cursor, static_cast<unsigned long long>(n));
  base = __shfl_sync(0xffffffffu, base, 0);
  for (int e = lane; e < n; e += 32) {
    const unsigned long long at = base + e;
    if (at < out.cap) {
      const int2 h = st[e];
      out.gi[at] = h.x;
      out.gj[at] = h.y;
    }
  }
  __syncwarp();   // read before the area is refilled
}

// Stages the hits of one finished m-tile: acc[4j + e] is position
// pos + 8 (e >> 1) of the chunk (valid if bit e >> 1 of `valid`) against
// row 8j + 2tq + (e & 1) of the stage (its original id in rid, shared),
// a hit where it is >= 0. n, the warp's staged hits, is the same in
// every lane.
__device__ __forceinline__ void screen_mtile(int (&acc)[kAcc],
                                             uint32_t valid,
                                             const int32_t* rid, int pos,
                                             int2* st, int& n,
                                             const HitOut& out, int lane,
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
    // this lane's hits as bits i of acc[i], only from the runs that
    // reached 0 (see the note at the top)
    uint64_t hm = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (m[k] >= 0) {
#pragma unroll
        for (int i = 8 * k; i < 8 * k + 8; ++i) {   // j = i / 4, e = i % 4
          if (acc[i] >= 0 && ((valid >> ((i & 3) >> 1)) & 1u))
            hm |= 1ull << i;
        }
      }
    }
    // a round per hit of the lane with the most: each lane with one left
    // stages its lowest, after the lanes below it
    for (;;) {
      const uint32_t ball = __ballot_sync(0xffffffffu, hm != 0);
      if (ball == 0) break;
      if (n + 32 > kStageHits) {
        flush_hits(st, n, out, lane);
        n = 0;
      }
      if (hm != 0) {
        const int i = __ffsll(static_cast<long long>(hm)) - 1;
        hm &= hm - 1;
        st[n + __popc(ball & ((1u << lane) - 1u))] =
            make_int2(rid[8 * (i >> 2) + 2 * tq + (i & 1)],
                      pos + ((i >> 1) & 1) * 8);
      }
      n += __popc(ball);
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
              const int32_t* __restrict__ row_id,  // [n_stages * 128]
              const uint8_t* __restrict__ letters, // [>= C + max offset]
              const uint8_t* __restrict__ tval,    // [C]
              Offsets offs, int win, int n_stages, int ntt,
              const __grid_constant__ HitOut out) {
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
    // the rows' original ids beside it
    const int r = threadIdx.x - (kCWarps + 2) * 32;   // 0 .. 63
    for (int64_t tt = blockIdx.x; tt < ntt; tt += gridDim.x) {
      for (int s = 0; s < n_stages; ++s) {
        const int64_t row = static_cast<int64_t>(s) * kRowTile + r;
        const int t0 = thr[row], t1 = thr[row + kPatchThreads];
        const int g0 = row_id[row], g1 = row_id[row + kPatchThreads];
        mbar_wait(&sm.full[slot], phase);
        patch_threshold(sm.q[slot], r, t0);
        patch_threshold(sm.q[slot], r + kPatchThreads, t1);
        sm.row_id[slot][r] = g0;
        sm.row_id[slot][r + kPatchThreads] = g1;
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
  int2* st = sm.hits[warp];
  int n_st = 0;   // hits staged in st
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
    const int pos = static_cast<int>(tt) * kTileT + p0;   // m-tile 0's
    for (int s = 0; s < n_stages; ++s) {
      mbar_wait(&sm.ready[slot], phase);
      const uint64_t desc = stage_desc(sm.q[slot]);
      const int32_t* rid = sm.row_id[slot];
      issue_mtile(acc0, desc, a[0]);
      issue_mtile(acc1, desc, a[1]);
      wgmma_wait<1>();
      screen_mtile(acc0, valid, rid, pos, st, n_st, out, lane, tq);
      issue_mtile(acc0, desc, a[2]);
      wgmma_wait<1>();
      screen_mtile(acc1, valid >> 2, rid, pos + 64, st, n_st, out, lane, tq);
      issue_mtile(acc1, desc, a[3]);
      wgmma_wait<1>();
      screen_mtile(acc0, valid >> 4, rid, pos + 128, st, n_st, out, lane,
                   tq);
      wgmma_wait<0>();
      screen_mtile(acc1, valid >> 6, rid, pos + 192, st, n_st, out, lane,
                   tq);
      if (lane == 0) mbar_arrive(&sm.empty[slot]);
      if (++slot == kRing) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
  if (n_st) flush_hits(st, n_st, out, lane);
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

// Rows per compacted row tile: the host pads its compacted rows to a
// positive multiple of this.
extern "C" int prefilter_dense_row_tile() { return kRowTile; }

extern "C" int prefilter_dense_max_offset() { return kMaxOffset; }

// Zeroes the cursor, then launches the pass on `stream`; returns a CUDA
// error code (0 = launched). The caller guarantees the layouts in the
// kernel's parameter comments, C = ntt * 512 positions (at most 2^31 - 1),
// six host-side offsets in `offs` of at most prefilter_dense_max_offset()
// (unused ones 0, with zero Qexp columns), and the compacted rows: n_rows
// of them, a positive multiple of 128, 16-byte aligned, with their
// thresholds and original row ids, no byte 126 or 127 read (none of 6 x 21
// columns). gi and gj hold `capacity` int32 each; cursor is one uint64.
extern "C" int prefilter_dense_hits_launch(
    const void* qexp, const void* thr, const void* row_id,
    const void* letters, const void* tval, const int* offs, int n_rows,
    int ntt, void* gi, void* gj, long long capacity, void* cursor,
    void* stream) {
  if (n_rows <= 0 || n_rows % kRowTile || capacity < 0 ||
      reinterpret_cast<uintptr_t>(qexp) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int max_off = 0;
  for (int p = 0; p < kOff; ++p) {
    if (offs[p] < 0 || offs[p] > kMaxOffset)
      return static_cast<int>(cudaErrorInvalidValue);
    max_off = offs[p] > max_off ? offs[p] : max_off;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(cursor, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess || ntt <= 0) return static_cast<int>(err);
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
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(counts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCountsSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const HitOut out = {static_cast<int32_t*>(gi), static_cast<int32_t*>(gj),
                      static_cast<unsigned long long*>(cursor),
                      static_cast<unsigned long long>(capacity)};
  counts_kernel<<<static_cast<unsigned>(ntt < sms ? ntt : sms), kCThreads,
                  kCountsSmem, s>>>(
      rows, static_cast<const int32_t*>(thr),
      static_cast<const int32_t*>(row_id),
      static_cast<const uint8_t*>(letters), static_cast<const uint8_t*>(tval),
      to_offsets(offs), kTileT + max_off, n_rows / kRowTile, ntt, out);
  return static_cast<int>(cudaGetLastError());
}
