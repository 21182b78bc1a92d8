// The query side of the GPU scoring engine on Hopper (sm_90a): each query
// residue's composition bias and the whole int8 stripe profile that
// csrc/sw_allpairs.cu's sw_pairs_kernel reads, in one pass.
//
// The JAX package has no device kernel for this: it computes the bias per
// query on the host with numpy (spacepharer_tpu/pipeline/predictmatch.py,
// _search_tpu's sw_bias_i8 loop). The function is the reference's
// SubstitutionMatrix::calcLocalAaBiasCorrection rounded as ssw_init rounds
// it (ops/align.py::sw_bias_i8): for residue i of a query of length n,
//
//   lo, hi = max(0, i - 20), min(n, i + 20)
//   bias_i = round_half_away(-(sum_{lo <= j < hi, j != i} S[q_i][q_j])
//                            / (hi - lo) + E[q_i])
//
// with E the host's fixed float64 expected-score table
// (ops/bias.py::expected_score_tab: a dgemv recomputed here could differ in
// the last ulp from the host engines' table), then
//
//   prof[q_stripe[q] + i / 16][c][i % 16] = S[q_i][c] + bias_i   (c < alpha)
//
// and -128 in every other byte of the [n_stripes, 32, 16] profile (pad
// rows, letters the matrix lacks), in the layout of ops/sw_packed.py's
// module docstring. The kernel writes every byte itself: the caller
// allocates the profile uninitialised.
//
// Exactness: the window sum is a sum of integers, kept in int32. The bias
// is the host's integer: window_bias takes it from one float64 multiply
// by fl(1 / w) and one add where that value lies clear of every rounding
// boundary (then provably the same integer), and elsewhere repeats the
// host's arithmetic exactly: the quotient correctly rounded from its
// integer division (neg_quotient: no float64 divide, whose fast path is
// DFMAs), the add and the rounding's +-0.5 as explicit round-to-nearest
// intrinsics, so no contraction into a DFMA can move a bit (chip_smoke.py
// phase 0 fails on a DFMA in this library). A bias that differs by one
// would change which pairs pass the E-value screen, and so the result
// text. The profile bytes are S + bias mod 256, the value itself wherever
// it lies in [-127, 127]; the flag reports every other.
//
// What bounds it on this card: bytes, 512 of profile a stripe (~12 MB at
// the GPU engine's 2.5e5 residues, against ~0.25 MB of letters), written
// once, fully coalesced. What stands in the way is the work per byte, in
// shared-memory traffic and issue slots (39 matrix lookups a residue, 16
// gathered rows a letter), and the latency of a stripe's two dependent
// global loads (its query, then its letters). The design:
//  - a block takes kQueries consecutive queries, whose stripes are
//    consecutive (no search: their offsets and first stripes are one
//    coalesced load); its kWarps warps take the stripes in turn, one warp
//    a stripe, the owner found by a ballot over the block's first stripes;
//  - each warp loads its next stripe's letters before it works on this
//    one, with a 20-residue halo on each side and letters outside the
//    stripe's query replaced by kPad, whose matrix column is 0, so the
//    window needs no bounds: lane r sums offsets -20..-1 of row r, lane
//    r + 16 offsets 0..19 (the residue itself taken out after one
//    shuffle), each reading its letters as aligned words;
//  - a query of at most 20 residues is every one of its rows' window, so
//    there the two lanes of a row split the query's 20 staged positions
//    and make 10 lookups each, not 20 (spacer ORFs are 9-45 residues);
//  - the matrix is staged once a block, its rows at an odd stride (kWin)
//    so that lanes with different letters spread over the banks;
//  - the bias comes from one float64 multiply by fl(1 / w) and one add
//    (window_bias), exact wherever that lies clear of a rounding
//    boundary, else from the exact quotient (rare);
//  - a row's range check is one compare of its bias with the row's least
//    and greatest matrix value;
//  - each lane adds its row's bias to 16 of the row's matrix bytes at
//    once (one 16-byte load, four byte-wise adds) and stores them in a
//    row-major tile with one 16-byte store; lane c gathers letter c's 16
//    rows from it and writes them as one 16-byte store: the warp's 512
//    bytes in one instruction (a lane that received each row's matrix
//    offset and bias instead would read 128 bytes of them a stripe);
//  - a warp vote, then at most one atomic per warp into the flag.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStripe = 16;    // query rows per stripe (sw_allpairs.cu)
constexpr int kAlpha = 32;     // profile columns; the matrix has <= 32
constexpr int kHalfWin = 20;   // window offsets -20 .. 19
constexpr int kMaxWin = 2 * kHalfWin;
constexpr int kQueries = 32;   // queries a block (<= 32: one ballot)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// resident blocks an SM: caps the registers at 40 (no spills), so that 132
// SMs hold 792 blocks, the 716 of the GPU engine's 2.3e4 queries at once
constexpr int kBlocksPerSm = 6;
constexpr int kPad = kAlpha;   // staged letter outside the stripe's query
constexpr int kWin = kAlpha + 1;   // window matrix row stride; kPad column 0
constexpr int kOutRow = 48;    // output matrix row stride in bytes (odd
                               // multiple of 16: rows spread over banks)
constexpr int kSpan = kStripe + 2 * kHalfWin;   // letters a stripe stages
constexpr int kSpanWords = 16;                  // 64 bytes a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kFlagRange = 1;    // a value left [-127, 127]
constexpr int32_t kFlagLetter = 2;   // a query letter >= alpha

// x + y byte by byte, each byte mod 256
__device__ __forceinline__ uint32_t add_bytes(uint32_t x, uint32_t y) {
  return ((x & 0x7f7f7f7fu) + (y & 0x7f7f7f7fu)) ^ ((x ^ y) & 0x80808080u);
}

// per window length w in [1, kMaxWin]: fl(1 / w), folded by the
// compiler (IEEE division), and ceil(2^64 / w) for w >= 2; read where a
// stripe uses them (one length a stripe for queries of <= 20 residues)
constexpr unsigned long long kInv(int w) {
  return w >= 2 ? ~0ull / static_cast<unsigned long long>(w) + 1 : 0;
}
__constant__ double kRcp[kMaxWin + 1] = {
    0.0, 1.0 / 1, 1.0 / 2, 1.0 / 3, 1.0 / 4, 1.0 / 5,
    1.0 / 6, 1.0 / 7, 1.0 / 8, 1.0 / 9, 1.0 / 10,
    1.0 / 11, 1.0 / 12, 1.0 / 13, 1.0 / 14, 1.0 / 15,
    1.0 / 16, 1.0 / 17, 1.0 / 18, 1.0 / 19, 1.0 / 20,
    1.0 / 21, 1.0 / 22, 1.0 / 23, 1.0 / 24, 1.0 / 25,
    1.0 / 26, 1.0 / 27, 1.0 / 28, 1.0 / 29, 1.0 / 30,
    1.0 / 31, 1.0 / 32, 1.0 / 33, 1.0 / 34, 1.0 / 35,
    1.0 / 36, 1.0 / 37, 1.0 / 38, 1.0 / 39, 1.0 / 40};
__constant__ unsigned long long kInvTab[kMaxWin + 1] = {
    0, kInv(1), kInv(2), kInv(3), kInv(4), kInv(5),
    kInv(6), kInv(7), kInv(8), kInv(9), kInv(10),
    kInv(11), kInv(12), kInv(13), kInv(14), kInv(15),
    kInv(16), kInv(17), kInv(18), kInv(19), kInv(20),
    kInv(21), kInv(22), kInv(23), kInv(24), kInv(25),
    kInv(26), kInv(27), kInv(28), kInv(29), kInv(30),
    kInv(31), kInv(32), kInv(33), kInv(34), kInv(35),
    kInv(36), kInv(37), kInv(38), kInv(39), kInv(40)};

// fl(-num / den) in float64, rounded to nearest, ties to even, for den in
// [1, 40] and inv = ceil(2^64 / den) (den >= 2): t = floor(|num| *
// 2^(32 + z) / den), 58 to 64 bits, from one high 64-bit multiply by the
// reciprocal, which is exact or one too many (|num| normalised to 32 bits
// by its z leading zeros), the remainder as the sticky bit, then one
// rounding to 53 bits.
__device__ __noinline__ double neg_quotient(int num, int den, uint64_t inv) {
  if (num == 0) return -0.0;
  if (den == 1) return -static_cast<double>(num);
  const uint64_t sign = num > 0 ? 1ull << 63 : 0;
  const uint32_t a = static_cast<uint32_t>(
      num > 0 ? static_cast<int64_t>(num) : -static_cast<int64_t>(num));
  const int z = __clz(a);
  const uint64_t x = static_cast<uint64_t>(a << z) << 32;
  const uint64_t d = static_cast<uint64_t>(den);
  uint64_t t = __umul64hi(x, inv);
  uint64_t rem = x - t * d;
  if (rem >= d) {                   // one too many: the remainder wrapped
    --t;
    rem += d;
  }
  const int sh = 64 - __clzll(static_cast<long long>(t)) - 53;  // 5 .. 11
  uint64_t m = t >> sh;
  const uint64_t rest = t & ((1ull << sh) - 1), half = 1ull << (sh - 1);
  if (rest > half || (rest == half && (rem != 0 || (m & 1)))) ++m;
  int e = sh;                       // |quotient| = m * 2^(e - 32 - z)
  if (m >> 53) {
    m >>= 1;
    ++e;
  }
  return __longlong_as_double(static_cast<long long>(
      sign | (static_cast<uint64_t>(1043 + e - z) << 52) |
      (m & ((1ull << 52) - 1))));
}

// round_half_away(fl(fl(-sum / win) + e)), the host's bias. The fast path
// computes y = fl(fl(-sum * fl(1 / win)) + e): with |-sum / win| and |e|
// below 2^12 it differs from the host's value by less than 2^-37, and
// every rounding boundary (where fl(v +- 0.5) crosses an integer) lies
// within 2^-39 of a half-integer, so where y lies more than 2^-30 from
// every half-integer both round to the integer nearest y. Elsewhere the
// host's arithmetic is repeated exactly.
__device__ __forceinline__ int window_bias(int sum, int win, double e) {
  const double t = __dmul_rn(-static_cast<double>(sum), kRcp[win]);
  const double y = __dadd_rn(t, e);
  const double ay = fabs(y);
  const double f = __dsub_rn(ay, floor(ay));
  if (fabs(t) < 4096.0 && fabs(e) < 4096.0 &&
      fabs(__dsub_rn(f, 0.5)) > 9.313225746154785e-10)   // 2^-30
    return __double2int_rn(y);
  const double x = __dadd_rn(neg_quotient(sum, win, kInvTab[win]), e);
  return static_cast<int>(x < 0.0 ? ceil(__dsub_rn(x, 0.5))
                                  : floor(__dadd_rn(x, 0.5)));
}

// letter t (0 .. kSpan - 1) of the stripe whose first row is residue i0 of
// the query of n residues at `start`: residue i0 - 20 + t, -1 outside
__device__ __forceinline__ int stage_letter(const uint8_t* __restrict__ letters,
                                            int start, int n, int i0, int t) {
  const int i = i0 - kHalfWin + t;
  return t < kSpan && i >= 0 && i < n ? __ldg(letters + start + i) : -1;
}

// a staged letter as the window reads it: kPad outside the query, 0 (and
// flagged) where it is not below alpha
__device__ __forceinline__ uint8_t staged(int letter, int alpha, bool& bad) {
  if (letter < 0) return kPad;
  if (letter >= alpha) {
    bad = true;
    return 0;
  }
  return static_cast<uint8_t>(letter);
}

// row srow's matrix entries summed over the first `terms` (<= 4 * kWords)
// staged letters from byte p of stage on, read as the words that hold
// them, shifted into place
template <int kWords>
__device__ __forceinline__ int window_sum(const int32_t* srow,
                                          const uint32_t* stage, int p,
                                          int terms) {
  const uint32_t* w = stage + (p >> 2);
  const int shift = 8 * (p & 3);
  uint32_t x[kWords + 1];
#pragma unroll
  for (int j = 0; j <= kWords; ++j) x[j] = w[j];
#pragma unroll
  for (int j = 0; j < kWords; ++j) x[j] = __funnelshift_r(x[j], x[j + 1], shift);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < 4 * kWords; ++k)
    if (k < terms) sum += srow[__byte_perm(x[k >> 2], 0, 0x4440 | (k & 3))];
  return sum;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
pair_profile_kernel(const uint8_t* __restrict__ letters,   // [total]
                    const int64_t* __restrict__ q_off,     // [n_q + 1]
                    const int64_t* __restrict__ q_stripe,  // [n_q]
                    int n_q, int64_t n_stripes,
                    const int32_t* __restrict__ scores,    // [alpha, alpha]
                    const double* __restrict__ expected,   // [alpha]
                    int alpha, int comp_bias,
                    int8_t* __restrict__ prof,             // [S, 32, 16]
                    int32_t* __restrict__ flag) {
  // swin[a * kWin + b]: S[a][b], 0 for b >= alpha (kPad among them);
  // sout[a * kOutRow + c]: the low byte of S[a][c], -128 in row kPad
  __shared__ int32_t swin[kAlpha * kWin];
  __shared__ __align__(16) uint8_t sout[(kAlpha + 1) * kOutRow];
  __shared__ int32_t srange[kAlpha][2];        // row a's least, greatest
  __shared__ double sexp[kAlpha];
  __shared__ int32_t qoff[kQueries + 1];       // residues from the block's
  __shared__ int32_t qstr[kQueries + 1];       // stripes from the block's
  __shared__ uint32_t stage[kWarps][kSpanWords];
  __shared__ __align__(16) uint8_t tile[kWarps][kStripe * kAlpha];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_begin = blockIdx.x * kQueries;
  const int cnt = min(kQueries, n_q - q_begin);
  // the block's stripes: from its first query's on (from 0 in the first
  // block) to the next block's first query's
  const int64_t s0 = blockIdx.x ? __ldg(q_stripe + q_begin) : 0;
  const int64_t r0 = __ldg(q_off + q_begin);
  const uint8_t* block_letters = letters + r0;

#pragma unroll
  for (int k = tid; k < (kAlpha + 1) * kAlpha; k += kThreads) {
    const int a = k >> 5, c = k & (kAlpha - 1);
    sout[a * kOutRow + c] = static_cast<uint8_t>(
        a < alpha && c < alpha ? __ldg(scores + a * alpha + c) : -128);
  }
#pragma unroll
  for (int k = tid; k < kAlpha * kWin; k += kThreads) {
    const int a = k / kWin, b = k - a * kWin;
    if (a < alpha) swin[k] = b < alpha ? __ldg(scores + a * alpha + b) : 0;
  }
  if (tid < alpha) {
    int lo = __ldg(scores + tid * alpha), hi = lo;
#pragma unroll
    for (int c = 1; c < kAlpha; ++c)
      if (c < alpha) {
        const int v = __ldg(scores + tid * alpha + c);
        lo = min(lo, v);
        hi = max(hi, v);
      }
    srange[tid][0] = lo;
    srange[tid][1] = hi;
    sexp[tid] = __ldg(expected + tid);
  }
  if (tid <= cnt) {
    qoff[tid] = static_cast<int32_t>(__ldg(q_off + q_begin + tid) - r0);
    qstr[tid] = static_cast<int32_t>(
        (q_begin + tid < n_q ? __ldg(q_stripe + q_begin + tid) : n_stripes) -
        s0);
  }
  __syncthreads();

  // the owner of stripe s is the last query whose first stripe is <= s
  // (empty queries share their stripe with the next one); rows past its
  // end, and every row of a stripe no query owns, are pad
  const int s_end = qstr[cnt];
  const int first = lane < cnt ? qstr[lane] : INT32_MAX;
  const int r = lane & (kStripe - 1), h = lane >> 4;
  uint8_t* st = reinterpret_cast<uint8_t*>(stage[warp]);
  bool bad_range = false, bad_letter = false;

  int start = 0, n = 0, i0 = 0, pre0 = -1, pre1 = -1;
  auto locate = [&](int stripe) {       // start, n, i0 and its letters
    const int t = __popc(__ballot_sync(kFull, first <= stripe)) - 1;
    start = n = i0 = 0;
    if (t >= 0) {
      start = qoff[t];
      n = qoff[t + 1] - start;
      i0 = (stripe - qstr[t]) * kStripe;
    }
    pre0 = stage_letter(block_letters, start, n, i0, lane);
    pre1 = stage_letter(block_letters, start, n, i0, lane + 32);
  };
  int s = warp;
  if (s < s_end) locate(s);
  while (s < s_end) {
    const int cur_i0 = i0, cur_n = n, b0 = pre0, b1 = pre1;
    const int next = s + kWarps;
    if (next < s_end) locate(next);     // its loads fly during this stripe
    st[lane] = staged(b0, alpha, bad_letter);
    if (lane + 32 < kSpan) st[lane + 32] = staged(b1, alpha, bad_letter);
    __syncwarp();

    const int a = st[kHalfWin + r];
    const bool row = a != kPad;
    int bias = 0;
    if (comp_bias) {
      const int32_t* srow = swin + (row ? a : 0) * kWin;
      int sum, win;
      if (cur_n <= kHalfWin) {
        // every row's window is the whole query, staged from byte
        // 20 - i0 on: each lane of a row sums half of its 20 positions
        sum = window_sum<3>(srow, stage[warp],
                            kHalfWin - cur_i0 + h * (kHalfWin / 2),
                            kHalfWin / 2);
        win = cur_n;
      } else {
        sum = window_sum<5>(srow, stage[warp], r + h * kHalfWin, kHalfWin);
        const int i = cur_i0 + r;
        win = min(cur_n, i + kHalfWin) - max(0, i - kHalfWin);
      }
      sum += __shfl_xor_sync(kFull, sum, 16);
      if (row)
        bias = window_bias(sum - srow[a], win, sexp[a]);
    }
    if (row)
      bad_range |= srange[a][0] + bias < -127 || srange[a][1] + bias > 127;
    // lane (r, h): row r at letters 16h .. 16h + 15, its matrix bytes plus
    // the bias byte by byte (exact wherever the value is in range: the
    // range check flags the rest), into the row-major tile; lane c then
    // gathers letter c's 16 rows and stores them
    uint4 v = *reinterpret_cast<const uint4*>(sout + (row ? a : kPad) * kOutRow +
                                              h * kStripe);
    const uint32_t b4 = static_cast<uint32_t>(bias & 0xff) * 0x01010101u;
    v = make_uint4(add_bytes(v.x, b4), add_bytes(v.y, b4),
                   add_bytes(v.z, b4), add_bytes(v.w, b4));
    reinterpret_cast<uint4*>(tile[warp])[2 * r + h] = v;   // row r, half h
    __syncwarp();
    uint32_t word[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint8_t* t = tile[warp] + 4 * k * kAlpha + lane;
      word[k] = __byte_perm(__byte_perm(t[0], t[kAlpha], 0x0040),
                            __byte_perm(t[2 * kAlpha], t[3 * kAlpha], 0x0040),
                            0x5410);
    }
    const uint4 chunk = lane < alpha ? make_uint4(word[0], word[1], word[2],
                                                  word[3])
                                     : make_uint4(0x80808080u, 0x80808080u,
                                                  0x80808080u, 0x80808080u);
    reinterpret_cast<uint4*>(prof)[(s0 + s) * kAlpha + lane] = chunk;
    __syncwarp();                   // the stage and tile are rewritten next
    s = next;
  }
  const bool range_vote = __any_sync(kFull, bad_range);
  const bool letter_vote = __any_sync(kFull, bad_letter);
  if (lane == 0 && (range_vote || letter_vote))
    atomicOr(flag, (range_vote ? kFlagRange : 0) |
                       (letter_vote ? kFlagLetter : 0));
}

}  // namespace

extern "C" int pair_profile_max_alpha() { return kAlpha; }

// Zeroes the 4-byte flag and launches the kernel on `stream` over the
// n_stripes stripes of the profile of n_q queries (the layouts in the
// kernel's parameter comments; prof uninitialised, 16-byte aligned), one
// block per kQueries queries, and returns the first CUDA error (0 =
// launched). The flag becomes kFlagRange where a profile value leaves
// [-127, 127], ORed with kFlagLetter where a query letter is not below
// alpha. q_stripe must hold each query's first stripe, in order, the
// queries' stripes not overlapping.
extern "C" int pair_profile_launch(const void* letters, const void* q_off,
                                   const void* q_stripe, int n_q,
                                   long long n_stripes, const void* scores,
                                   const void* expected, int alpha,
                                   int comp_bias, void* prof, void* flag,
                                   void* stream) {
  if (n_stripes <= 0) return 0;
  if (alpha <= 0 || alpha > kAlpha || n_q < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at least one block, which writes stripes no query owns as pad
  const unsigned blocks =
      n_q ? static_cast<unsigned>((n_q + kQueries - 1) / kQueries) : 1;
  pair_profile_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(letters), static_cast<const int64_t*>(q_off),
      static_cast<const int64_t*>(q_stripe), n_q,
      static_cast<int64_t>(n_stripes), static_cast<const int32_t*>(scores),
      static_cast<const double*>(expected), alpha, comp_bias,
      static_cast<int8_t*>(prof), static_cast<int32_t*>(flag));
  return static_cast<int>(cudaGetLastError());
}
