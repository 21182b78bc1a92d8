// The dense prefilter's match streams on Hopper (sm_90a): the reference's
// match-stream order rebuilt from the dense hits, on the card.
//
// The JAX package has no device kernel for this: it rebuilds the streams on
// the host with numpy (spacepharer_tpu/ops/prefilter_dense.py::
// hits_to_streams), and the port did the same until these kernels. The dense
// pass (csrc/prefilter_dense.cu) finds every (query k-mer row gi, target
// position gj) whose spaced k-mers score at least the row's threshold. The
// reference's postings walk (QueryMatcher.cpp:84-323) emits the same matches
// in a fixed order, which the dup filter downstream depends on:
//
//   row gi ascending (query key, then k-mer position), then the similar
//   k-mer enumeration order of the row: (rank of the target's half 1 under
//   the row's half 1, rank of its half 2 under the row's half 2), each half
//   list ordered by (score desc, code asc) (KmerGenerator.cpp:186-), then
//   target sequence ascending; one entry per (row, code, sequence), at its
//   first position in the sequence (IndexTable.h:341-).
//
// The kernels, in the order the host launches them:
//
//   mark_halves_kernel  a grid of at most 512 blocks over the hits: each
//                       block gathers the base-21 codes (X included) of its
//                       hits' two query halves in a shared bitmap, then ORs
//                       it into the global one (a few thousand halves take
//                       millions of hits: one flag store per hit queued on
//                       a few hundred hot L2 lines);
//   slots_kernel        one block: numbers the flagged codes in ascending
//                       order (slot_of[code], uniq[slot], n_uniq);
//   rank_tables_kernel  one block of 256 threads per flagged half q:
//                       rank[q][c] of each of the 8,000 target half-codes c
//                       = (c0, c1, c2) under (score desc, code asc), where
//                       score = A[c0] + B[c1] + D[c2], the rows of the seed
//                       matrix S at q's letters (|S| <= 127, so scores lie
//                       in [-381, 381]). A stable counting sort in closed
//                       form: the codes fall in 20 super-blocks of 400
//                       (c0 fixed), whose order within is fixed by B + D
//                       alone (peers[c12]: the earlier codes with the same
//                       B + D); one block scan over (bucket in descending
//                       score, super-block), bucket-major and limited to
//                       the half's score range, gives each super-block its
//                       first rank per bucket; then rank = first[c0][bucket]
//                       + peers[c12], every code at once, 8 per 16-byte
//                       store. No thread walks the codes in order;
//   keys_kernel         one thread per hit: the six target letters, the two
//                       half-codes and their ranks, the target sequence (a
//                       binary search of t_starts) and the position in it,
//                       and the sort key
//                         key = ((gi * 8000 + r1) * 8000 + r2) << seq_bits
//                               | t_seq
//                       when it fits 63 bits, else (gi * 8000 + r1) * 8000
//                       + r2 alone (the host then sorts by t_seq first,
//                       stably). Pad rows (gi >= n_rows) and positions past
//                       the target get key -1 and drop out; a hit whose
//                       k-mer holds an X or runs past the target counts in
//                       `bad` (the host raises: the dense pass never emits
//                       one);
//   (the host sorts the keys: torch.sort, CUB's radix sort, which returns
//    the sorted keys beside the permutation)
//   run_count_kernel    each warp over 16 x 32 consecutive sorted hits (a
//                       block over 4,096): the runs of equal (key, t_seq)
//                       that start there, from the sorted keys read in
//                       order (a packed key carries t_seq and the row; the
//                       sequences of wider keys are compared only between
//                       equal keys);
//   run_write_kernel    the same hits: each block sums the counts of the
//                       blocks before it, each warp counts again and takes
//                       its offset, and each run's first lane gathers the
//                       positions of the run's hits through the permutation
//                       (their least) and writes m_t = t_seq, m_d = (gi -
//                       q_start[key] - pos) & 0xFFFF at the run's rank and
//                       the bounds of the query keys up to its own (runs
//                       are in key order, since gi leads the key); the last
//                       block writes the count of runs and the bounds past
//                       the last run.
//
// What bounds them on this card: bytes. The key and run kernels read or
// write a few dozen bytes per hit with a few integer operations, the run
// kernels the sorted keys in order and one gathered position per hit (the
// row and sequence too where the keys are not packed); rank_tables_kernel
// writes 16,000 bytes per distinct query half after a few hundred
// shared-memory operations per thread. The other gathers (the query and
// target letters, the rank tables, t_starts, q_starts) are random reads
// served mostly from L2. Nothing here needs the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNOff = 6;                 // spaced offsets (3 + 3)
constexpr int kQBase = 21;               // query half letters, X included
constexpr int kQHalves = kQBase * kQBase * kQBase;   // 9,261
constexpr int kTHalves = 8000;           // target half-codes, letters < 20
constexpr int kScoreOff = 384;           // half scores lie in [-381, 381]
constexpr int kBuckets = 2 * kScoreOff + 1;
constexpr int kThreads = 256;            // hits per block
constexpr int kScanThreads = 1024;
constexpr int kQWords = (kQHalves + 31) / 32;  // the halves' bitmap
constexpr unsigned kMarkBlocks = 512;   // blocks that gather the halves
// rank tables: one block of 8 warps per query half; a half's codes (c0,
// c12 = c1 * 20 + c2) fall in 20 super-blocks of 400 (c0 fixed)
constexpr int kRankThreads = 256;
constexpr int kSuper = kTHalves / 20;          // 400 codes per super-block
constexpr int kBD = 509;                       // B[c1] + D[c2] in [-254, 254]
constexpr int kDV = 255;                       // D[c2] in [-127, 127]
// run kernels: each warp takes kRunRounds x 32 consecutive sorted hits
constexpr int kRunRounds = 16;
constexpr int kRunTile = kThreads * kRunRounds;   // 4,096 per block
constexpr int64_t kRowCodes = static_cast<int64_t>(kTHalves) * kTHalves;

struct Offs {
  int o[kNOff];
};

__device__ __forceinline__ int query_half(const uint8_t* __restrict__ q,
                                          int64_t row, const Offs& offs,
                                          int h) {
  return (q[row + offs.o[3 * h]] * kQBase + q[row + offs.o[3 * h + 1]]) *
             kQBase +
         q[row + offs.o[3 * h + 2]];
}

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive scan of x over a block of kT threads (every thread must call
// it); *total gets the block's sum. sums: shared, at least 33 ints.
template <int kT>
__device__ __forceinline__ int block_exclusive_scan(int x, int* sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(x);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kT / 32 ? sums[lane] : 0;
    const int wi = warp_inclusive_scan(w);
    if (lane < kT / 32) sums[lane] = wi - w;
    if (lane == 31) sums[32] = wi;
  }
  __syncthreads();
  const int excl = sums[warp] + incl - x;
  *total = sums[32];
  __syncthreads();  // sums may be reused by the next call
  return excl;
}

__global__ void __launch_bounds__(kThreads)
mark_halves_kernel(const int32_t* __restrict__ gi, int64_t n, int64_t n_rows,
                   const uint8_t* __restrict__ q, Offs offs,
                   uint32_t* __restrict__ present) {
  // many hits share a few thousand halves: each block gathers its halves
  // in shared memory and ORs them into the global bitmap once per word
  __shared__ uint32_t seen[kQWords];
  for (int w = threadIdx.x; w < kQWords; w += kThreads) seen[w] = 0;
  __syncthreads();
  for (int64_t h = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       h < n; h += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t row = gi[h];
    if (row < 0 || row >= n_rows) continue;
    for (int half = 0; half < 2; ++half) {
      const int c = query_half(q, row, offs, half);
      atomicOr(&seen[c >> 5], 1u << (c & 31));
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < kQWords; w += kThreads)
    if (seen[w] != 0) atomicOr(&present[w], seen[w]);
}

__global__ void __launch_bounds__(kScanThreads)
slots_kernel(const uint32_t* __restrict__ present,
             int32_t* __restrict__ slot_of, int32_t* __restrict__ uniq,
             int32_t* __restrict__ n_uniq) {
  __shared__ int sums[33];
  int carry = 0;
  for (int c0 = 0; c0 < kQHalves; c0 += kScanThreads) {
    const int c = c0 + threadIdx.x;
    const int f = c < kQHalves && (present[c >> 5] >> (c & 31) & 1u);
    int total;
    const int excl = block_exclusive_scan<kScanThreads>(f, sums, &total);
    if (c < kQHalves) slot_of[c] = f ? carry + excl : -1;
    if (f) uniq[carry + excl] = c;
    carry += total;
  }
  if (threadIdx.x == 0) n_uniq[0] = carry;
}

__global__ void __launch_bounds__(kRankThreads)
rank_tables_kernel(const int32_t* __restrict__ uniq,
                   const int32_t* __restrict__ seed, int alpha,
                   int16_t* __restrict__ tables) {
  // first[c0][b]: the rank of super-block c0's first code in bucket b
  __shared__ __align__(16) uint16_t first[20 * kBuckets];
  __shared__ __align__(16) int16_t bd[kSuper];     // B[c1] + D[c2] of c12
  __shared__ __align__(16) uint16_t peers[kSuper]; // earlier c12, same bd
  __shared__ int n_bd[kBD];                        // c12 per bd + 254
  __shared__ int n_d[kDV];                         // c2 per D + 127
  __shared__ int rows[3][20];                      // A, B, D
  __shared__ int range[2];                         // buckets in use
  __shared__ int sums[33];
  const int tid = threadIdx.x;
  const int code = uniq[blockIdx.x];
  if (tid < 60) {
    const int h = code / (kQBase * kQBase), m = code / kQBase % kQBase;
    const int letter = tid < 20 ? h : tid < 40 ? m : code % kQBase;
    rows[tid / 20][tid % 20] = seed[letter * alpha + tid % 20];
  }
  for (int i = tid; i < kBD; i += kRankThreads) n_bd[i] = 0;
  if (tid < kDV) n_d[tid] = 0;
  __syncthreads();
  if (tid < 32) {   // the bucket range: the rows' least and greatest sums
    int lo = 0, hi = 0;
    for (int r = 0; r < 3; ++r) {
      int mn = tid < 20 ? rows[r][tid] : 1 << 20;
      int mx = tid < 20 ? rows[r][tid] : -(1 << 20);
      for (int d = 16; d > 0; d >>= 1) {
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, d));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      }
      lo += mx;
      hi += mn;
    }
    if (tid == 0) {
      range[0] = kScoreOff - lo;
      range[1] = kScoreOff - hi;
    }
  }
  if (tid < 20) atomicAdd(&n_d[rows[2][tid] + 127], 1);
  for (int c = tid; c < kSuper; c += kRankThreads) {
    const int v = rows[1][c / 20] + rows[2][c % 20];
    bd[c] = static_cast<int16_t>(v);
    atomicAdd(&n_bd[v + 254], 1);
  }
  __syncthreads();
  // a super-block's order is fixed by B + D: the earlier codes with the same
  // sum are those of earlier c1 with D = bd - B[c1'], and of earlier c2 with
  // the same D
  for (int c = tid; c < kSuper; c += kRankThreads) {
    const int c1 = c / 20, c2 = c % 20, v = bd[c], d = rows[2][c2];
    int e = 0;
    for (int j = 0; j < c2; ++j) e += rows[2][j] == d;
    for (int j = 0; j < c1; ++j) {
      const int x = v - rows[1][j] + 127;
      if (x >= 0 && x < kDV) e += n_d[x];
    }
    peers[c] = static_cast<uint16_t>(e);
  }
  // one exclusive scan over (bucket, super-block), bucket-major: bucket b
  // (score kScoreOff - b) of super-block c0 holds the codes with bd =
  // kScoreOff - b - A[c0]
  const int b_lo = range[0], b_hi = range[1];
  int carry = 0;
  for (int b0 = b_lo; b0 <= b_hi; b0 += kRankThreads) {
    const int b = b0 + tid;
    int in_b = 0;
    if (b <= b_hi)
      for (int c0 = 0; c0 < 20; ++c0) {
        const int v = kScoreOff - b - rows[0][c0] + 254;
        if (v >= 0 && v < kBD) in_b += n_bd[v];
      }
    int total;
    int at = carry + block_exclusive_scan<kRankThreads>(in_b, sums, &total);
    if (b <= b_hi)
      for (int c0 = 0; c0 < 20; ++c0) {
        first[c0 * kBuckets + b] = static_cast<uint16_t>(at);
        const int v = kScoreOff - b - rows[0][c0] + 254;
        if (v >= 0 && v < kBD) at += n_bd[v];
      }
    carry += total;
  }
  __syncthreads();
  // rank = first[c0][bucket] + peers[c12], 8 consecutive codes (one
  // super-block) per 16-byte store
  uint4* dst = reinterpret_cast<uint4*>(tables +
                                        static_cast<int64_t>(blockIdx.x) *
                                            kTHalves);
  for (int g = tid; g < kTHalves / 8; g += kRankThreads) {
    const int c0 = g / (kSuper / 8), c12 = g % (kSuper / 8) * 8;
    const uint4 bd8 = *reinterpret_cast<const uint4*>(bd + c12);
    const uint4 pe8 = *reinterpret_cast<const uint4*>(peers + c12);
    const int16_t* v = reinterpret_cast<const int16_t*>(&bd8);
    const uint16_t* e = reinterpret_cast<const uint16_t*>(&pe8);
    const uint16_t* f = first + c0 * kBuckets + kScoreOff - rows[0][c0];
    uint4 out;
    uint16_t* r = reinterpret_cast<uint16_t*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = static_cast<uint16_t>(f[-v[j]] + e[j]);
    dst[g] = out;
  }
}

__global__ void __launch_bounds__(kThreads)
keys_kernel(const int32_t* __restrict__ gi, const int64_t* __restrict__ gj,
            int64_t n, int64_t n_rows, const uint8_t* __restrict__ q,
            Offs offs, const uint8_t* __restrict__ t, int64_t t_res,
            const int64_t* __restrict__ t_starts, int n_seqs,
            const int32_t* __restrict__ slot_of,
            const int16_t* __restrict__ tables, int seq_bits, int narrow,
            int64_t* __restrict__ key, int32_t* __restrict__ tseq,
            int32_t* __restrict__ tpos, int32_t* __restrict__ bad) {
  const int64_t h = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (h >= n) return;
  const int64_t row = gi[h], j = gj[h];
  key[h] = -1;
  tseq[h] = 0;
  tpos[h] = 0;
  if (row < 0 || row >= n_rows || j < 0 || j >= t_res) return;
  int l[kNOff];
  bool ok = true;
  for (int p = 0; p < kNOff; ++p) {
    const int64_t at = j + offs.o[p];
    l[p] = at < t_res ? t[at] : 20;
    ok &= l[p] < 20;
  }
  if (!ok) {
    atomicAdd(bad, 1);
    return;
  }
  const int c1 = l[0] * 400 + l[1] * 20 + l[2];
  const int c2 = l[3] * 400 + l[4] * 20 + l[5];
  const int64_t r1 =
      tables[static_cast<int64_t>(slot_of[query_half(q, row, offs, 0)]) *
                 kTHalves + c1];
  const int64_t r2 =
      tables[static_cast<int64_t>(slot_of[query_half(q, row, offs, 1)]) *
                 kTHalves + c2];
  // the sequence holding j: the last s with t_starts[s] <= j
  int lo = 0, hi = n_seqs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t_starts[mid] <= j) lo = mid; else hi = mid - 1;
  }
  const int64_t row_code = (row * kTHalves + r1) * kTHalves + r2;
  key[h] = narrow ? (row_code << seq_bits) | lo : row_code;
  tseq[h] = lo;
  tpos[h] = static_cast<int32_t>(j - t_starts[lo]);
}

// The sorted hits as the run kernels read them: the sorted keys skey and
// the permutation perm, with t_seq and the rows gi in hit order. When the
// keys are packed (shift = seq_bits >= 0) a key holds its row and t_seq;
// else (shift < 0) they are gathered through perm.
struct Sorted {
  const int64_t* __restrict__ skey;
  const int64_t* __restrict__ perm;
  const int32_t* __restrict__ tseq;
  const int32_t* __restrict__ gi;
  int64_t n;
  int shift;

  __device__ __forceinline__ int64_t row(int64_t i, int64_t k) const {
    return shift >= 0 ? (k >> shift) / kRowCodes
                      : __ldcg(gi + __ldcg(perm + i));
  }
  __device__ __forceinline__ int32_t seq(int64_t i, int64_t k) const {
    return shift >= 0 ? static_cast<int32_t>(k & ((int64_t{1} << shift) - 1))
                      : __ldcg(tseq + __ldcg(perm + i));
  }
  // which of the 32 sorted hits from i - lane start a run: a kept hit whose
  // (key, t_seq) differs from the hit before it (read through perm only
  // between equal keys that do not carry t_seq)
  __device__ __forceinline__ unsigned firsts(int64_t i, int lane) const {
    const int64_t k = i < n ? __ldcg(skey + i) : -1;
    int64_t prev = __shfl_up_sync(0xffffffffu, k, 1);
    if (lane == 0) prev = i > 0 && i < n ? __ldcg(skey + i - 1) : -1;
    const bool f = k >= 0 && (i == 0 || k != prev ||
                              (shift < 0 && seq(i, k) != seq(i - 1, prev)));
    return __ballot_sync(0xffffffffu, f);
  }
};

// The query key holding row g: the last kk with q_starts[kk] <= g, searched
// above `from` (a key at or below it).
__device__ __forceinline__ int key_of(const int64_t* __restrict__ q_starts,
                                      int n_keys, int64_t g, int from) {
  int lo = from, hi = n_keys - 1;
  if (lo == hi || q_starts[lo + 1] > g) return lo;   // the usual case
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (q_starts[mid] <= g) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The runs that start among a warp's kRunRounds x 32 sorted hits from base.
__device__ __forceinline__ int warp_runs(const Sorted& h, int64_t base,
                                         int lane) {
  int c = 0;
  for (int r = 0; r < kRunRounds; ++r)
    c += __popc(h.firsts(base + r * 32 + lane, lane));
  return c;
}

// Each block's runs into block_off; the last block to finish (ticket, zeroed
// by the host) turns them into the runs of the blocks before each one.
__global__ void __launch_bounds__(kThreads)
run_count_kernel(Sorted h, int64_t* __restrict__ block_off,
                 unsigned long long* __restrict__ ticket) {
  __shared__ int sums[33];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kRunTile +
                       warp * 32 * kRunRounds;
  const int c = warp_runs(h, base, lane);
  if (lane == 0) sums[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += sums[w];
    block_off[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  long long carry = 0;
  for (unsigned b0 = 0; b0 < gridDim.x; b0 += kThreads) {
    const unsigned b = b0 + threadIdx.x;
    const int r = b < gridDim.x ? static_cast<int>(__ldcg(block_off + b)) : 0;
    int chunk;
    const int excl = block_exclusive_scan<kThreads>(r, sums, &chunk);
    if (b < gridDim.x) block_off[b] = carry + excl;
    carry += chunk;
  }
}

__global__ void __launch_bounds__(kThreads)
run_write_kernel(Sorted h, const int32_t* __restrict__ tpos,
                 const int64_t* __restrict__ block_off,
                 const int64_t* __restrict__ q_starts, int n_keys,
                 int32_t* __restrict__ m_t, uint16_t* __restrict__ m_d,
                 int64_t* __restrict__ n_runs,
                 int64_t* __restrict__ bounds) {
  __shared__ int wsum[kThreads / 32];
  __shared__ long long woff[kThreads / 32 + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the runs of the blocks before this one, and of this block's warps
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kRunTile +
                       warp * 32 * kRunRounds;
  const int c = warp_runs(h, base, lane);
  if (lane == 0) wsum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long at = block_off[blockIdx.x];
    for (int w = 0; w < kThreads / 32; ++w) {
      woff[w] = at;
      at += wsum[w];
    }
    woff[kThreads / 32] = at;
  }
  __syncthreads();
  int64_t out = woff[warp];
  int kk = -2;   // the query key of the run before: not known yet
  const unsigned below = (1u << lane) - 1;
  for (int r = 0; r < kRunRounds; ++r) {
    const int64_t i = base + r * 32 + lane;
    const unsigned mask = h.firsts(i, lane);
    if (mask == 0) continue;
    if (kk == -2) {   // that of the hit before the warp's first run, if kept
      const int64_t f = base + r * 32 + __ffs(mask) - 1;
      const int64_t k = f > 0 ? __ldcg(h.skey + f - 1) : -1;
      kk = k >= 0 ? key_of(q_starts, n_keys, h.row(f - 1, k), 0) : -1;
    }
    int kc = 0;
    const bool mine = mask >> lane & 1u;
    const int64_t o = out + __popc(mask & below);
    if (mine) {   // the run's first hit: its least position over the run
      const int64_t k = __ldcg(h.skey + i);
      const int32_t s = h.seq(i, k);
      int32_t pos = __ldcg(tpos + __ldcs(h.perm + i));
      for (int64_t j = i + 1; j < h.n && __ldcg(h.skey + j) == k; ++j) {
        if (h.shift < 0 && h.seq(j, k) != s) break;
        pos = min(pos, __ldcg(tpos + __ldcg(h.perm + j)));
      }
      const int64_t g = h.row(i, k);
      kc = key_of(q_starts, n_keys, g, max(kk, 0));
      m_t[o] = s;
      m_d[o] = static_cast<uint16_t>((g - q_starts[kc] - pos) & 0xFFFF);
    }
    // the query keys up to this run's start here (runs are in key order)
    const unsigned earlier = mask & below;
    const int kp = __shfl_sync(0xffffffffu, kc,
                               earlier ? 31 - __clz(earlier) : 0);
    if (mine)
      for (int q = (earlier ? kp : kk) + 1; q <= kc; ++q) bounds[q] = o;
    kk = __shfl_sync(0xffffffffu, kc, 31 - __clz(mask));
    out += __popc(mask);
  }
  if (blockIdx.x != gridDim.x - 1) return;
  // the last block: the count of runs, and the bounds past the last run
  // (kept hits sort last, so the last hit is kept if any is)
  const int64_t runs = woff[kThreads / 32];
  const int64_t k = h.n > 0 ? __ldcg(h.skey + h.n - 1) : -1;
  const int last =
      k >= 0 ? key_of(q_starts, n_keys, h.row(h.n - 1, k), 0) : -1;
  for (int q = last + 1 + threadIdx.x; q <= n_keys; q += kThreads)
    bounds[q] = runs;
  if (threadIdx.x == 0) n_runs[0] = runs;
}

Offs make_offs(const int* offs) {
  Offs o;
  for (int p = 0; p < kNOff; ++p) o.o[p] = offs[p];
  return o;
}

unsigned blocks_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

bool too_many(long long n) {
  return (n + kThreads - 1) / kThreads > 0x7fffffffLL;
}

}  // namespace

extern "C" int prefilter_streams_query_halves() { return kQHalves; }
extern "C" int prefilter_streams_target_halves() { return kTHalves; }
extern "C" int prefilter_streams_run_tile() { return kRunTile; }

// The query halves of the hit rows: present (uint32 [ceil(9261 / 32)],
// zeroed by the host) is their bitmap, slot_of (int32 [9261]) numbers them
// in ascending code (-1 where absent), uniq (int32 [9261]) lists them,
// n_uniq (int32 [1]) counts them. gi int32 [n]; q uint8 [n_rows + span -
// 1]; offs 6 ints.
extern "C" int prefilter_streams_halves_launch(
    const void* gi, long long n, long long n_rows, const void* q,
    const int* offs, void* present, void* slot_of, void* uniq, void* n_uniq,
    void* stream) {
  if (too_many(n)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    mark_halves_kernel<<<blocks_of(n) < kMarkBlocks ? blocks_of(n)
                                                    : kMarkBlocks,
                         kThreads, 0, s>>>(
        static_cast<const int32_t*>(gi), n, n_rows,
        static_cast<const uint8_t*>(q), make_offs(offs),
        static_cast<uint32_t*>(present));
  slots_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const uint32_t*>(present), static_cast<int32_t*>(slot_of),
      static_cast<int32_t*>(uniq), static_cast<int32_t*>(n_uniq));
  return static_cast<int>(cudaGetLastError());
}

// The rank tables (int16 [n_uniq, 8000]) of the listed query halves, from
// the seed matrix (int32 [alpha, alpha], |entries| <= 127).
extern "C" int prefilter_streams_tables_launch(const void* uniq, int n_uniq,
                                               const void* seed, int alpha,
                                               void* tables, void* stream) {
  if (n_uniq <= 0) return 0;
  if (alpha < 21) return static_cast<int>(cudaErrorInvalidValue);
  rank_tables_kernel<<<static_cast<unsigned>(n_uniq), kRankThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(uniq), static_cast<const int32_t*>(seed),
      alpha, static_cast<int16_t*>(tables));
  return static_cast<int>(cudaGetLastError());
}

// Each hit's sort key (int64 [n]), target sequence and position in it (int32
// [n] each); bad (int32 [1], zeroed by the host) counts hits whose k-mer
// holds an X or runs past the target. gj int64 [n]; t uint8 [t_res];
// t_starts int64 [n_seqs + 1].
extern "C" int prefilter_streams_keys_launch(
    const void* gi, const void* gj, long long n, long long n_rows,
    const void* q, const int* offs, const void* t, long long t_res,
    const void* t_starts, int n_seqs, const void* slot_of, const void* tables,
    int seq_bits, int narrow, void* key, void* tseq, void* tpos, void* bad,
    void* stream) {
  if (n <= 0) return 0;
  if (too_many(n)) return static_cast<int>(cudaErrorInvalidConfiguration);
  keys_kernel<<<blocks_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gi), static_cast<const int64_t*>(gj), n,
      n_rows, static_cast<const uint8_t*>(q), make_offs(offs),
      static_cast<const uint8_t*>(t), t_res,
      static_cast<const int64_t*>(t_starts), n_seqs,
      static_cast<const int32_t*>(slot_of),
      static_cast<const int16_t*>(tables), seq_bits, narrow,
      static_cast<int64_t*>(key), static_cast<int32_t*>(tseq),
      static_cast<int32_t*>(tpos), static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// The runs of the sorted hits (skey int64 [n], the sorted keys; perm int64
// [n], the sorted order; seq_bits the keys' packing, key = row_code <<
// seq_bits | t_seq, or -1 when they do not carry t_seq, and then tseq and
// gi are read through perm): m_t int32 and m_d uint16 (each [n], the first
// n_runs written), n_runs (int64 [1]) and each query key's first run,
// bounds int64 [n_keys + 1]. block_off int64 is scratch of nb + 1 entries,
// nb = max(ceil(n / prefilter_streams_run_tile()), 1). Two launches.
extern "C" int prefilter_streams_runs_launch(
    const void* skey, const void* perm, const void* tseq, const void* tpos,
    const void* gi, long long n, int seq_bits, const void* q_starts,
    int n_keys, void* block_off, void* m_t, void* m_d, void* n_runs,
    void* bounds, void* stream) {
  const long long nb = n > 0 ? (n + kRunTile - 1) / kRunTile : 1;
  if (n < 0 || nb > 0x7fffffffLL || n_keys <= 0 || seq_bits > 62)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Sorted h{static_cast<const int64_t*>(skey),
                 static_cast<const int64_t*>(perm),
                 static_cast<const int32_t*>(tseq),
                 static_cast<const int32_t*>(gi), n, seq_bits};
  int64_t* off = static_cast<int64_t*>(block_off);
  const cudaError_t err = cudaMemsetAsync(off + nb, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  run_count_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      h, off, reinterpret_cast<unsigned long long*>(off + nb));
  run_write_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      h, static_cast<const int32_t*>(tpos), off,
      static_cast<const int64_t*>(q_starts), n_keys,
      static_cast<int32_t*>(m_t), static_cast<uint16_t*>(m_d),
      static_cast<int64_t*>(n_runs), static_cast<int64_t*>(bounds));
  return static_cast<int>(cudaGetLastError());
}
