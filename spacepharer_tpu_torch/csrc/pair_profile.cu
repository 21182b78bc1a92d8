// The query side of the GPU scoring engine on Hopper (sm_90a): each query
// residue's composition bias and its column of the int8 stripe profile that
// csrc/sw_allpairs.cu's sw_pairs_kernel reads, in one pass.
//
// The JAX package has no device kernel for this: it computes the bias per
// query on the host with numpy (spacepharer_tpu/pipeline/predictmatch.py,
// _search_tpu's sw_bias_i8 loop), and the port did the same until this
// kernel (_query_bias_i8, a [block, longest, 21] float64 table gathered 40
// times). The function is the reference's
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
// in the layout of ops/sw_packed.py's module docstring. The caller fills the
// profile with -128 first (pad rows and letters the matrix lacks).
//
// Exactness: the window sum is a sum of integers, kept in int32 and
// converted exactly; the divide, the add and the rounding's +-0.5 are
// explicit round-to-nearest float64 intrinsics, so no contraction into an
// FMA can move a bit, and the result equals numpy's float64 arithmetic bit
// for bit. A bias that differs by one would change which pairs pass the
// E-value screen, and so the result text.
//
// What bounds it on this card: bytes, barely. One thread per residue reads
// its 40 neighbours' letters (L1 hits: a warp's windows overlap), 40 matrix
// entries from shared memory and one float64 from the table, does three
// float64 operations, and writes alpha profile bytes; the 16 residues of a
// stripe write 16 consecutive bytes per letter, so a warp's stores
// coalesce into 16-byte segments. At the GPU engine's shapes (10^5 - 10^7
// residues) the pass is far under a millisecond; launch latency dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // residues per block
constexpr int kStripe = 16;    // query rows per stripe (sw_allpairs.cu)
constexpr int kAlpha = 32;     // profile columns; the matrix has <= 32
constexpr int kHalfWin = 20;   // window offsets -20 .. 19

__global__ void __launch_bounds__(kThreads)
pair_profile_kernel(const uint8_t* __restrict__ letters,   // [total]
                    const int64_t* __restrict__ q_off,     // [n_q + 1]
                    const int64_t* __restrict__ q_stripe,  // [n_q]
                    int n_q, int64_t total,
                    const int32_t* __restrict__ scores,    // [alpha, alpha]
                    const double* __restrict__ expected,   // [alpha]
                    int alpha, int comp_bias,
                    int8_t* __restrict__ prof,             // [S, 32, 16]
                    int32_t* __restrict__ flag) {          // out of int8
  __shared__ int32_t smat[kAlpha * kAlpha];
  for (int k = threadIdx.x; k < alpha * alpha; k += kThreads)
    smat[k] = scores[k];
  __syncthreads();
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= total) return;

  // the query holding residue g: the last q with q_off[q] <= g (empty
  // queries share their offset with the next one and are passed over)
  int lo = 0, hi = n_q - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(q_off + mid) <= g) lo = mid; else hi = mid - 1;
  }
  const int64_t start = __ldg(q_off + lo);
  const int n = static_cast<int>(__ldg(q_off + lo + 1) - start);
  const int i = static_cast<int>(g - start);
  const int a = __ldg(letters + g);
  const int32_t* row = smat + a * alpha;

  int bias = 0;
  if (comp_bias) {
    const int j0 = max(0, i - kHalfWin);
    const int j1 = min(n, i + kHalfWin);
    int sum = 0;
    for (int j = j0; j < j1; ++j)
      sum += row[__ldg(letters + start + j)];
    sum -= row[a];  // the residue itself
    const double x = __dadd_rn(
        __ddiv_rn(-static_cast<double>(sum), static_cast<double>(j1 - j0)),
        __ldg(expected + a));
    bias = static_cast<int>(x < 0.0 ? ceil(__dsub_rn(x, 0.5))
                                    : floor(__dadd_rn(x, 0.5)));
  }

  int8_t* col = prof + (__ldg(q_stripe + lo) + i / kStripe) * (kAlpha * kStripe)
                + i % kStripe;
  bool out_of_range = false;
  for (int c = 0; c < alpha; ++c) {
    const int v = row[c] + bias;
    out_of_range |= v < -127 || v > 127;
    col[c * kStripe] = static_cast<int8_t>(v);
  }
  if (out_of_range) flag[0] = 1;
}

}  // namespace

extern "C" int pair_profile_max_alpha() { return kAlpha; }

// Launches the kernel on `stream` over `total` residues of n_q queries (the
// layouts in the kernel's parameter comments; prof already holds -128
// everywhere, flag 0) and returns cudaGetLastError() (0 = launched). flag
// becomes 1 where a profile value leaves [-127, 127].
extern "C" int pair_profile_launch(const void* letters, const void* q_off,
                                   const void* q_stripe, int n_q,
                                   long long total, const void* scores,
                                   const void* expected, int alpha,
                                   int comp_bias, void* prof, void* flag,
                                   void* stream) {
  if (total <= 0 || n_q <= 0) return 0;
  if (alpha <= 0 || alpha > kAlpha)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  pair_profile_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(letters), static_cast<const int64_t*>(q_off),
      static_cast<const int64_t*>(q_stripe), n_q, static_cast<int64_t>(total),
      static_cast<const int32_t*>(scores), static_cast<const double*>(expected),
      alpha, comp_bias, static_cast<int8_t*>(prof),
      static_cast<int32_t*>(flag));
  return static_cast<int>(cudaGetLastError());
}
