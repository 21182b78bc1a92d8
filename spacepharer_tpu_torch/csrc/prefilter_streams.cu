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
//   mark_halves_kernel  one thread per hit: flags the base-21 codes of its
//                       row's two query halves (X included);
//   slots_kernel        one block: numbers the flagged codes in ascending
//                       order (slot_of[code], uniq[slot], n_uniq);
//   rank_tables_kernel  one warp per flagged half q: rank[q][c] of each of
//                       the 8,000 target half-codes c, where the score of c
//                       is S[q0][c0] + S[q1][c1] + S[q2][c2], by a stable
//                       counting sort over the score range (|S| <= 127, so
//                       scores lie in [-381, 381]): a histogram, its
//                       exclusive scan in descending score, then a walk in
//                       ascending code where __match_any_sync gives each
//                       lane its earlier peers of equal score;
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
//   (the host sorts the keys: torch.sort, CUB's radix sort)
//   run_count_kernel    one thread per sorted hit: the first of each run of
//                       equal (key, t_seq), counted per block;
//   scan_blocks_kernel  one block: the blocks' exclusive offsets and the
//                       number of runs;
//   run_write_kernel    one thread per sorted hit: each run's first thread
//                       takes the least position over its run and writes
//                       m_t = t_seq, m_d = (gi - q_start[key] - pos) & 0xFFFF
//                       and the run's query key at the run's rank;
//   key_bounds_kernel   one thread per run boundary: each query key's first
//                       run (runs are in key order, since gi leads the key).
//
// What bounds them on this card: bytes. Every kernel but rank_tables_kernel
// reads or writes a few dozen bytes per hit (the hit, the key, the sequence,
// the position, the sorted permutation, the outputs) with a few integer
// operations, and rank_tables_kernel writes 16,000 bytes per distinct query
// half after 500 shared-memory steps of one warp. Their gathers (the query
// and target letters, the rank tables, t_starts) are random reads served
// mostly from L2. Nothing here needs the tensor cores.

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
                   int32_t* __restrict__ present) {
  const int64_t h = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (h >= n) return;
  const int64_t row = gi[h];
  if (row < 0 || row >= n_rows) return;
  present[query_half(q, row, offs, 0)] = 1;
  present[query_half(q, row, offs, 1)] = 1;
}

__global__ void __launch_bounds__(kScanThreads)
slots_kernel(const int32_t* __restrict__ present, int32_t* __restrict__ slot_of,
             int32_t* __restrict__ uniq, int32_t* __restrict__ n_uniq) {
  __shared__ int sums[33];
  int carry = 0;
  for (int c0 = 0; c0 < kQHalves; c0 += kScanThreads) {
    const int c = c0 + threadIdx.x;
    const int f = c < kQHalves && present[c] != 0;
    int total;
    const int excl = block_exclusive_scan<kScanThreads>(f, sums, &total);
    if (c < kQHalves) slot_of[c] = f ? carry + excl : -1;
    if (f) uniq[carry + excl] = c;
    carry += total;
  }
  if (threadIdx.x == 0) n_uniq[0] = carry;
}

__global__ void __launch_bounds__(32)
rank_tables_kernel(const int32_t* __restrict__ uniq,
                   const int32_t* __restrict__ seed, int alpha,
                   int16_t* __restrict__ tables) {
  __shared__ int cnt[kBuckets];
  __shared__ int rows[3][20];
  const int lane = threadIdx.x;
  const int code = uniq[blockIdx.x];
  const int q[3] = {code / (kQBase * kQBase), code / kQBase % kQBase,
                    code % kQBase};
  if (lane < 20)
    for (int p = 0; p < 3; ++p) rows[p][lane] = seed[q[p] * alpha + lane];
  for (int b = lane; b < kBuckets; b += 32) cnt[b] = 0;
  __syncwarp();
  // bucket of a code: ascending bucket = descending score
  auto bucket = [&](int c) {
    return kScoreOff - (rows[0][c / 400] + rows[1][c / 20 % 20] +
                        rows[2][c % 20]);
  };
  for (int c0 = 0; c0 < kTHalves; c0 += 32) {  // 8,000 = 250 x 32
    const int b = bucket(c0 + lane);
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (lane == __ffs(peers) - 1) cnt[b] += __popc(peers);
    __syncwarp();
  }
  int carry = 0;
  for (int b0 = 0; b0 < kBuckets; b0 += 32) {
    const int b = b0 + lane;
    const int x = b < kBuckets ? cnt[b] : 0;
    const int incl = warp_inclusive_scan(x);
    if (b < kBuckets) cnt[b] = carry + incl - x;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();
  int16_t* out = tables + static_cast<int64_t>(blockIdx.x) * kTHalves;
  const unsigned below = (1u << lane) - 1;
  for (int c0 = 0; c0 < kTHalves; c0 += 32) {
    const int b = bucket(c0 + lane);
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    out[c0 + lane] = static_cast<int16_t>(cnt[b] + __popc(peers & below));
    __syncwarp();
    if (lane == __ffs(peers) - 1) cnt[b] += __popc(peers);
    __syncwarp();
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

// Whether sorted hit i starts a run: a kept hit whose (key, t_seq) differs
// from the hit before it.
__device__ __forceinline__ bool run_first(const int64_t* __restrict__ perm,
                                          const int64_t* __restrict__ key,
                                          const int32_t* __restrict__ tseq,
                                          int64_t i) {
  const int64_t a = perm[i];
  if (key[a] < 0) return false;
  if (i == 0) return true;
  const int64_t b = perm[i - 1];
  return key[a] != key[b] || tseq[a] != tseq[b];
}

__global__ void __launch_bounds__(kThreads)
run_count_kernel(const int64_t* __restrict__ perm,
                 const int64_t* __restrict__ key,
                 const int32_t* __restrict__ tseq, int64_t n,
                 int32_t* __restrict__ block_counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int c = __syncthreads_count(i < n && run_first(perm, key, tseq, i));
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(kScanThreads)
scan_blocks_kernel(const int32_t* __restrict__ block_counts, int64_t nb,
                   int64_t* __restrict__ block_off,
                   int64_t* __restrict__ n_runs) {
  __shared__ int sums[33];
  int64_t carry = 0;
  for (int64_t b0 = 0; b0 < nb; b0 += kScanThreads) {
    const int64_t b = b0 + threadIdx.x;
    const int x = b < nb ? block_counts[b] : 0;
    int total;
    const int excl = block_exclusive_scan<kScanThreads>(x, sums, &total);
    if (b < nb) block_off[b] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) n_runs[0] = carry;
}

__global__ void __launch_bounds__(kThreads)
run_write_kernel(const int64_t* __restrict__ perm,
                 const int64_t* __restrict__ key,
                 const int32_t* __restrict__ tseq,
                 const int32_t* __restrict__ tpos,
                 const int32_t* __restrict__ gi, int64_t n,
                 const int64_t* __restrict__ block_off,
                 const int64_t* __restrict__ q_starts, int n_keys,
                 int32_t* __restrict__ m_t, uint16_t* __restrict__ m_d,
                 int32_t* __restrict__ run_key) {
  __shared__ int sums[33];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool first = i < n && run_first(perm, key, tseq, i);
  int total;
  const int excl = block_exclusive_scan<kThreads>(first, sums, &total);
  if (!first) return;
  const int64_t a = perm[i];
  const int64_t k = key[a];
  const int32_t s = tseq[a];
  int32_t pos = tpos[a];
  for (int64_t j = i + 1; j < n; ++j) {
    const int64_t b = perm[j];
    if (key[b] != k || tseq[b] != s) break;
    pos = min(pos, tpos[b]);
  }
  const int64_t g = gi[a];
  // the query key holding row g: the last kk with q_starts[kk] <= g
  int lo = 0, hi = n_keys - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (q_starts[mid] <= g) lo = mid; else hi = mid - 1;
  }
  const int64_t out = block_off[blockIdx.x] + excl;
  m_t[out] = s;
  m_d[out] = static_cast<uint16_t>((g - q_starts[lo] - pos) & 0xFFFF);
  run_key[out] = lo;
}

__global__ void __launch_bounds__(kThreads)
key_bounds_kernel(const int32_t* __restrict__ run_key,
                  const int64_t* __restrict__ n_runs, int n_keys,
                  int64_t* __restrict__ bounds) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nr = n_runs[0];
  if (p > nr) return;
  const int kp = p > 0 ? run_key[p - 1] : -1;
  const int kc = p < nr ? run_key[p] : n_keys;
  for (int k = kp + 1; k <= kc; ++k) bounds[k] = p;
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
extern "C" int prefilter_streams_block() { return kThreads; }

// The query halves of the hit rows: present (int32 [9261], zeroed by the
// host) flags them, slot_of (int32 [9261]) numbers them in ascending code
// (-1 where absent), uniq (int32 [9261]) lists them, n_uniq (int32 [1])
// counts them. gi int32 [n]; q uint8 [n_rows + span - 1]; offs 6 ints.
extern "C" int prefilter_streams_halves_launch(
    const void* gi, long long n, long long n_rows, const void* q,
    const int* offs, void* present, void* slot_of, void* uniq, void* n_uniq,
    void* stream) {
  if (too_many(n)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    mark_halves_kernel<<<blocks_of(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(gi), n, n_rows,
        static_cast<const uint8_t*>(q), make_offs(offs),
        static_cast<int32_t*>(present));
  slots_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(present), static_cast<int32_t*>(slot_of),
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
  rank_tables_kernel<<<static_cast<unsigned>(n_uniq), 32, 0,
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

// The runs of the sorted hits (perm int64 [n], the sorted order): m_t int32,
// m_d uint16 and run_key int32 (each [n], the first n_runs written), n_runs
// (int64 [1]) and each query key's first run, bounds int64 [n_keys + 1].
// block_counts int32 and block_off int64 are scratch of
// ceil(n / prefilter_streams_block()) entries each.
extern "C" int prefilter_streams_runs_launch(
    const void* perm, const void* key, const void* tseq, const void* tpos,
    const void* gi, long long n, const void* q_starts, int n_keys,
    void* block_counts, void* block_off, void* m_t, void* m_d, void* run_key,
    void* n_runs, void* bounds, void* stream) {
  if (too_many(n + 1) || n_keys <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + kThreads - 1) / kThreads;
  if (n > 0)
    run_count_kernel<<<blocks_of(n), kThreads, 0, s>>>(
        static_cast<const int64_t*>(perm), static_cast<const int64_t*>(key),
        static_cast<const int32_t*>(tseq), n,
        static_cast<int32_t*>(block_counts));
  scan_blocks_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(block_counts), nb,
      static_cast<int64_t*>(block_off), static_cast<int64_t*>(n_runs));
  if (n > 0)
    run_write_kernel<<<blocks_of(n), kThreads, 0, s>>>(
        static_cast<const int64_t*>(perm), static_cast<const int64_t*>(key),
        static_cast<const int32_t*>(tseq), static_cast<const int32_t*>(tpos),
        static_cast<const int32_t*>(gi), n,
        static_cast<const int64_t*>(block_off),
        static_cast<const int64_t*>(q_starts), n_keys,
        static_cast<int32_t*>(m_t), static_cast<uint16_t*>(m_d),
        static_cast<int32_t*>(run_key));
  key_bounds_kernel<<<blocks_of(n + 1), kThreads, 0, s>>>(
      static_cast<const int32_t*>(run_key),
      static_cast<const int64_t*>(n_runs), n_keys,
      static_cast<int64_t*>(bounds));
  return static_cast<int>(cudaGetLastError());
}
