// Stable LSD digit passes for Hopper (sm_90a): the port of
// tpq/kernels/radix_sort.py _split1_kernel (wrapper _split1), the 1-bit
// split that tpq's lsd_radix_sort_bits repeats once per bit spec.
//
// What it computes. One pass sorts the rows stably by a digit of up to 8
// bit specs: spec i is one bit of one plane and gives digit bit i, so
// later specs are more significant. Consecutive bits of one plane form a
// run, read with one load. Every int32 plane is carried
// along. Rows keep their values during a pass, so this equals the
// group's one-bit splits applied in order; lsd_radix_sort_bits makes
// ceil(specs / 8) passes where tpq makes one split per spec. A 1-bit
// digit is tpq's _split1: bit-0 rows first, each class in order.
//
// The TPU kernel is one sequential grid with two fused pack streams
// (zeros and ones) front-compacted through a shift network and flushed
// by DMA with a cursor in SMEM. CUDA blocks run in parallel and in no
// order, so a pass here is three launches over 4,096-row tiles:
//   1. count: each tile's rows per digit, warp-aggregated (the lanes of
//      a digit found by one ballot per digit bit) into per-warp shared
//      bins, written digit-major (counts[d * ntiles + t]);
//   2. scan: one block per digit scans its row of tile counts in place
//      (exclusive) and writes the digit's total, a multi-block scan with
//      no one-block bottleneck;
//   3. scatter: each tile ranks its rows stably (warp w takes rows
//      [512w, 512w + 512) in 16 rounds; the same ballots give a row's
//      rank among its warp round's equal digits, added to the warp's
//      running count per digit in shared memory; the warps' counts are
//      scanned in warp order per digit), stages each plane's rows in
//      shared memory in digit order and writes each digit's run to
//      consecutive addresses, loading the next plane while it stores
//      this one. A row's place is digit start (scan of the digit totals)
//      + the tile's exclusive count of the digit + its rank: no atomics
//      decide it, and every run writes the same bytes.
// Bound by bytes: every plane read once and written once, the digit
// planes read once more by the count; nothing syncs with the host. The
// planes are read in 16-byte loads; stores are 4 bytes a thread,
// coalesced along a digit's run, since runs start anywhere.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;  // rows per tile: DIGIT_TILE in kernels/radix_sort.py
constexpr int kWarpRows = kTile / kWarps;
constexpr int kRounds = kWarpRows / 32;  // rows per thread in the rank
constexpr int kMaxBits = 8;
constexpr int kMaxBins = 1 << kMaxBits;
constexpr uint32_t kNoDigit = kMaxBins;  // rows past n: a value no digit takes
constexpr int kScanThreads = 1024;
static_assert(kThreads == kMaxBins, "one thread per digit in the per-tile scans");
static_assert(kTile % (kThreads * 4) == 0, "16-byte loads cover the tile");

// A digit as runs of bits: run r puts the mask[r] bits of plane src[r]
// from bit shift[r] up at digit bit pos[r] (consecutive specs of one
// plane are one run, so a row costs one load per run, not per bit). With
// `nonzero`, the one-bit digit of a single run is src[0][k] != 0 (tpq's
// _split1 takes any nonzero bit value as 1).
struct Digit {
  const int32_t* src[kMaxBits];
  int shift[kMaxBits];
  int pos[kMaxBits];
  uint32_t mask[kMaxBits];
  int nruns, nbits, nonzero;
};

struct Planes {
  const int32_t* src[TPQ_MAX_COLS];
  int32_t* dst[TPQ_MAX_COLS];
  int n;
};

__device__ __forceinline__ uint32_t digit_of(const Digit& g, int64_t k) {
  uint32_t d = 0;
#pragma unroll
  for (int r = 0; r < kMaxBits; r++) {
    if (r < g.nruns) {
      const uint32_t v = uint32_t(__ldg(g.src[r] + k));
      d |= (g.nonzero ? uint32_t(v != 0) : (v >> g.shift[r]) & g.mask[r]) << g.pos[r];
    }
  }
  return d;
}

// The lanes of the warp whose row has digit d, by one ballot per digit
// bit; rows past n (valid false) are in no lane's mask.
__device__ __forceinline__ unsigned digit_peers(uint32_t d, bool valid, int nbits) {
  unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
  for (int b = 0; b < kMaxBits; b++) {
    if (b < nbits) {
      const bool bit = (d >> b) & 1u;
      const unsigned m = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? m : ~m;
    }
  }
  return peers;
}

__global__ void __launch_bounds__(kThreads)
    digit_count_kernel(Digit g, int64_t n, int64_t ntiles, int32_t* __restrict__ counts) {
  __shared__ int32_t bins[kWarps][kMaxBins];  // per warp: no atomics
  const int nbins = 1 << g.nbits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x, base = t * kTile + warp * kWarpRows;
  for (int i = threadIdx.x; i < kWarps * kMaxBins; i += kThreads) (&bins[0][0])[i] = 0;
  uint32_t dig[kRounds];
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int64_t k = base + it * 32 + lane;
    dig[it] = k < n ? digit_of(g, k) : kNoDigit;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const bool valid = dig[it] != kNoDigit;
    const unsigned peers = digit_peers(dig[it], valid, g.nbits);
    if (valid && (peers & below) == 0) bins[warp][dig[it]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  if (int(threadIdx.x) < nbins) {
    int32_t c = 0;
    for (int w = 0; w < kWarps; w++) c += bins[w][threadIdx.x];
    counts[int64_t(threadIdx.x) * ntiles + t] = c;
  }
}

// Block d: the exclusive scan of counts[d * ntiles ...] in place, and
// totals[d].
__global__ void __launch_bounds__(kScanThreads)
    digit_scan_kernel(int32_t* __restrict__ counts, int64_t ntiles,
                      int32_t* __restrict__ totals) {
  __shared__ int32_t warp_sums[32];
  int32_t* row = counts + int64_t(blockIdx.x) * ntiles;
  int32_t carry = 0;
  for (int64_t b = 0; b < ntiles; b += kScanThreads) {
    const int64_t k = b + threadIdx.x;
    const int32_t v = k < ntiles ? row[k] : 0;
    int32_t chunk;
    const int32_t ex = block_exclusive_scan(v, warp_sums, &chunk);
    if (k < ntiles) row[k] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

constexpr int kVecs = kTile / (kThreads * 4);  // int4 loads of a plane per thread

// Thread's share of one plane of the tile: rows 4 * (j * kThreads +
// threadIdx.x) + 0..3, in 16-byte loads where the plane allows.
__device__ __forceinline__ void load_plane(const int32_t* __restrict__ src, int len,
                                           int4 (&v)[kVecs]) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll
  for (int j = 0; j < kVecs; j++) {
    const int r = 4 * (j * kThreads + threadIdx.x);
    if (vec && r + 4 <= len) {
      v[j] = *reinterpret_cast<const int4*>(src + r);
    } else {
      v[j].x = r < len ? src[r] : 0;
      v[j].y = r + 1 < len ? src[r + 1] : 0;
      v[j].z = r + 2 < len ? src[r + 2] : 0;
      v[j].w = r + 3 < len ? src[r + 3] : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    digit_scatter_kernel(Digit g, Planes planes, int64_t n, int64_t ntiles,
                         const int32_t* __restrict__ tile_offsets,
                         const int32_t* __restrict__ totals) {
  __shared__ int32_t s_cnt[kWarps][kMaxBins];  // per warp and digit
  __shared__ int32_t s_local[kMaxBins];        // digit's first slot in the tile
  __shared__ int32_t s_base[kMaxBins];         // output row of slot 0, per digit
  __shared__ uint16_t s_pos[kTile];            // rank in its warp, then slot, of row r
  __shared__ uint8_t s_slot_digit[kTile];
  __shared__ __align__(16) int32_t s_stage[kTile];
  __shared__ int32_t warp_sums[32];
  const int nbins = 1 << g.nbits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x, base = t * kTile;
  const int len = int(min(int64_t(kTile), n - base));

  for (int i = threadIdx.x; i < kWarps * kMaxBins; i += kThreads) (&s_cnt[0][0])[i] = 0;
  uint32_t dig[kRounds];
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int r = warp * kWarpRows + it * 32 + lane;
    dig[it] = r < len ? digit_of(g, base + r) : kNoDigit;
  }
  __syncthreads();

  // rank within the warp's rows, in row order
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int r = warp * kWarpRows + it * 32 + lane;
    const uint32_t d = dig[it];
    const bool valid = d != kNoDigit;
    const unsigned peers = digit_peers(d, valid, g.nbits);
    if (valid) s_pos[r] = uint16_t(s_cnt[warp][d] + __popc(peers & below));
    __syncwarp();
    if (valid && (peers & below) == 0) s_cnt[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // per digit (thread d): the warps' counts scanned in warp order, the
  // digit's run in the tile and in the output
  const int d = threadIdx.x;
  int32_t run = 0;
  if (d < nbins) {
    for (int w = 0; w < kWarps; w++) {
      const int32_t c = s_cnt[w][d];
      s_cnt[w][d] = run;
      run += c;
    }
  }
  int32_t sum;
  const int32_t local = block_exclusive_scan(d < nbins ? run : 0, warp_sums, &sum);
  const int32_t start = block_exclusive_scan(d < nbins ? totals[d] : 0, warp_sums, &sum);
  if (d < nbins) {
    s_local[d] = local;
    s_base[d] = start + tile_offsets[int64_t(d) * ntiles + t] - local;
  }
  __syncthreads();

#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int r = warp * kWarpRows + it * 32 + lane;
    if (r < len) {
      const int p = s_local[dig[it]] + s_cnt[warp][dig[it]] + s_pos[r];
      s_pos[r] = uint16_t(p);
      s_slot_digit[p] = uint8_t(dig[it]);
    }
  }
  __syncthreads();

  int32_t dest[kRounds];  // output row of slot it * kThreads + threadIdx.x
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int i = it * kThreads + threadIdx.x;
    dest[it] = i < len ? s_base[s_slot_digit[i]] + i : 0;
  }

  // plane c + 1 is loaded while plane c is stored
  int4 v[kVecs];
  load_plane(planes.src[0] + base, len, v);
  for (int c = 0; c < planes.n; c++) {
#pragma unroll
    for (int j = 0; j < kVecs; j++) {
      const int r = 4 * (j * kThreads + threadIdx.x);
      if (r < len) s_stage[s_pos[r]] = v[j].x;
      if (r + 1 < len) s_stage[s_pos[r + 1]] = v[j].y;
      if (r + 2 < len) s_stage[s_pos[r + 2]] = v[j].z;
      if (r + 3 < len) s_stage[s_pos[r + 3]] = v[j].w;
    }
    __syncthreads();
    if (c + 1 < planes.n) load_plane(planes.src[c + 1] + base, len, v);
    int32_t* __restrict__ dst = planes.dst[c];
#pragma unroll
    for (int it = 0; it < kRounds; it++) {
      const int i = it * kThreads + threadIdx.x;
      if (i < len) dst[dest[it]] = s_stage[i];
    }
    __syncthreads();  // the stage is refilled by the next plane
  }
}

}  // namespace

extern "C" {

// One stable pass by a digit of nbits (1..8) bits given as nruns runs:
// run r is bits [shifts[r], shifts[r] + lens[r]) of run_src[r], at digit
// bits from the sum of the earlier runs' lengths up; with nonzero, one
// run whose digit is run_src[0][k] != 0. scratch holds scratch_words >=
// (ntiles + 1) << nbits ints, ntiles = ceil(n / 4096). n < 2^31.
int tpq_split_digit(const int32_t* const* src, int32_t* const* dst, int nplanes,
                    const int32_t* const* run_src, const int* shifts, const int* lens,
                    int nruns, int nonzero, int64_t n, int32_t* scratch,
                    int64_t scratch_words, cudaStream_t stream) {
  if (nruns < 1 || nruns > kMaxBits || nplanes < 1 || (nonzero && (nruns != 1 || lens[0] != 1)))
    return int(cudaErrorInvalidValue);
  Digit g;
  g.nruns = nruns;
  g.nbits = 0;
  g.nonzero = nonzero;
  for (int r = 0; r < kMaxBits; r++) {
    const bool on = r < nruns;
    if (on && (lens[r] < 1 || lens[r] > kMaxBits || shifts[r] < 0 || shifts[r] + lens[r] > 32))
      return int(cudaErrorInvalidValue);
    g.src[r] = run_src[on ? r : 0];
    g.shift[r] = on ? shifts[r] : 0;
    g.pos[r] = g.nbits;
    g.mask[r] = on ? uint32_t((1ull << lens[r]) - 1) : 0u;
    g.nbits += on ? lens[r] : 0;
  }
  const int nbits = g.nbits;
  if (nbits > kMaxBits) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaGetLastError());
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const int nbins = 1 << nbits;
  if ((ntiles + 1) * nbins > scratch_words) return int(cudaErrorInvalidValue);
  int32_t* counts = scratch;
  int32_t* totals = scratch + ntiles * nbins;
  digit_count_kernel<<<unsigned(ntiles), kThreads, 0, stream>>>(g, n, ntiles, counts);
  digit_scan_kernel<<<nbins, kScanThreads, 0, stream>>>(counts, ntiles, totals);
  for (int c = 0; c < nplanes; c += TPQ_MAX_COLS) {
    Planes p;
    p.n = nplanes - c < TPQ_MAX_COLS ? nplanes - c : TPQ_MAX_COLS;
    for (int i = 0; i < p.n; i++) {
      p.src[i] = src[c + i];
      p.dst[i] = dst[c + i];
    }
    digit_scatter_kernel<<<unsigned(ntiles), kThreads, 0, stream>>>(g, p, n, ntiles, counts,
                                                                     totals);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
