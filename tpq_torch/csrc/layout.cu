// The lane join's probe layout for Hopper (sm_90a): the stable partition
// of tpq_torch.kernels.lane_table._probe_layout, whose plain version
// (probe_layout_ref) is tpq's sequence: a hash, a stable sort of the
// partition ids and its int64 perm, a rank of each row in its group, the
// key and payload gathers by the perm, PAD into [npart * probe_cap] and a
// second hash of every padded key for its lane (tpq/kernels/lane_table.py
// _probe_layout, :232; it is not a Pallas kernel, PAD is).
//
// What it computes, for a plan of npart = 2^pbits partitions of
// probe_cap slots: live row k (k < num_rows and keep[k], where keep is
// given) has h = hash(key[k], pbits + 7 bits, salt), partition p = h >> 7
// and lane h & 127. Partition p's live rows, in row order, fill slots
// p * probe_cap + rank for rank < probe_cap: key, payloads, lane, qocc 1.
// Rows ranked at or past probe_cap are dropped and `overflow` is set.
// Every other slot of p is what PAD and the second hash leave there: key
// and payloads 0, qocc 0, lane hash(0) & 127.
//
// Bound by bytes: the key, the payloads and keep read once (the key
// twice), every slot of every output written once. Three launches over
// tiles of kTile rows, the count / scan / scatter of csrc/radix_sort.cu
// generalised to partitions; no atomic decides a position, and every run
// writes the same bytes:
//   1. count: each tile hashes its keys (16-byte loads) and counts its
//      live rows per partition in shared bins (shared atomics: a count
//      does not depend on their order), written partition-major,
//      counts[p * ntiles + t];
//   2. scan: block p scans its partition's tile counts in place
//      (exclusive) and writes its total, then writes the partition's dead
//      slots [min(total, probe_cap), probe_cap), each once, in 16-byte
//      stores;
//   3. scatter: each tile ranks its live rows stably within their
//      partition (warp w takes rows [512w, 512w + 512) in 16 rounds;
//      __match_any_sync finds a round's lanes of one partition, their
//      rank added to the warp's running count in shared memory; the
//      warps' counts are scanned in warp order per partition), stages the
//      key and then each payload in shared memory in partition order, and
//      writes each partition's run to consecutive slots: slot p *
//      probe_cap + the tile's exclusive count of p + the rank. Block 0
//      also sets `overflow` from the totals.
// The per-tile bins, 24 bytes a partition, cap the partitions a plan may
// have at kMaxParts: beside the 32 KB stage a block then takes at most
// 56 KB of shared memory (44 KB at 512 partitions, the plans of configs
// 1, 3 and 4). Plans past it (config 5's shards, 16,384 partitions) keep
// the sort path, where the count matrix alone would be (ntiles + 1) *
// npart ints, about 0.5 GB a call. The scatter's 128 registers a thread
// leave two blocks an SM; on an H100 at config 4 a form held to 64
// registers and four blocks, reloading each key to stage it and its
// payloads in two halves, was slower (4.6 against 3.7 ms), and so was the
// fill as a launch of its own over 2,048 blocks (2.7 against the scan's
// 2.2 ms with it; PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;  // rows per tile: LAYOUT_TILE in kernels/lane_table.py
constexpr int kWarpRows = kTile / kWarps;
constexpr int kRounds = kWarpRows / 32;  // rows per thread in the rank
constexpr int kSlots = kTile / kThreads;  // staged slots per thread in the writes
constexpr int kMaxParts = 1024;  // LAYOUT_MAX_PARTS in kernels/lane_table.py
constexpr int kScanThreads = 1024;
constexpr int kSmemDefault = 48 * 1024;  // above it only after raising the limit
static_assert(kTile % (2 * kThreads) == 0, "the count's 16-byte loads cover the tile");
static_assert(kTile <= 65536, "16-bit per-warp counts");

struct Layout {
  const long long* key;  // [n], 16-byte aligned
  const long long* pay[TPQ_MAX_COLS];
  int npay;
  const uint8_t* keep;  // [n] bool, or null: every row below num_rows
  const void* num_rows;
  int nr_size;  // 4 or 8 bytes
  int64_t n;
  int npart, shift;  // shift = 32 - (pbits + 7)
  uint32_t salt;
  int64_t probe_cap;
  long long* qk;  // [npart * probe_cap] each
  long long* qpay[TPQ_MAX_COLS];
  int32_t* lane;
  int32_t* qocc;
  bool* overflow;
};

__device__ __forceinline__ int64_t live_rows(const Layout& a) {
  const int64_t nr = a.nr_size == 8 ? *static_cast<const int64_t*>(a.num_rows)
                                    : int64_t(*static_cast<const int32_t*>(a.num_rows));
  return min(nr, a.n);
}

__device__ __forceinline__ bool is_live(const Layout& a, int64_t row, int64_t nr) {
  return row < nr && (a.keep == nullptr || a.keep[row]);
}

__device__ __forceinline__ int partition_of(const Layout& a, long long key) {
  return int(uint32_t(hash_one(key, a.salt, a.shift)) >> 7);
}

__global__ void __launch_bounds__(kThreads)
    layout_count_kernel(Layout a, int64_t ntiles, int32_t* __restrict__ counts) {
  extern __shared__ int32_t s_bin[];  // npart
  for (int p = threadIdx.x; p < a.npart; p += kThreads) s_bin[p] = 0;
  __syncthreads();
  const int64_t t = blockIdx.x, base = t * kTile;
  const int len = int(min(int64_t(kTile), a.n - base));
  const int64_t nr = live_rows(a);
  const longlong2* kv = reinterpret_cast<const longlong2*>(a.key + base);
  auto count = [&](int r, long long key) {
    if (is_live(a, base + r, nr)) atomicAdd(&s_bin[partition_of(a, key)], 1);
  };
  for (int j = threadIdx.x; 2 * j < len; j += kThreads) {
    if (2 * j + 1 < len) {
      const longlong2 v = __ldg(kv + j);
      count(2 * j, v.x);
      count(2 * j + 1, v.y);
    } else {
      count(2 * j, a.key[base + 2 * j]);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < a.npart; p += kThreads) counts[int64_t(p) * ntiles + t] = s_bin[p];
}

// Block-strided fill of d[from, to) with v, 16-byte stores in the aligned
// middle (d itself 16-byte aligned).
template <typename T>
__device__ __forceinline__ void fill_block(T* d, int64_t from, int64_t to, T v) {
  using Vec = typename Vec16<T>::type;
  constexpr int V = 16 / sizeof(T);
  const int64_t a = min(to, (from + V - 1) / V * V);
  const int64_t b = max(a, to / V * V);
  for (int64_t i = from + threadIdx.x; i < a; i += blockDim.x) d[i] = v;
  for (int64_t i = b + threadIdx.x; i < to; i += blockDim.x) d[i] = v;
  Vec w;
  T* lanes = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int k = 0; k < V; k++) lanes[k] = v;
  Vec* dv = reinterpret_cast<Vec*>(d);
  for (int64_t i = a / V + threadIdx.x; i < b / V; i += blockDim.x) dv[i] = w;
}

// Block p: the exclusive scan of counts[p * ntiles ...] in place,
// totals[p], and partition p's dead slots.
__global__ void __launch_bounds__(kScanThreads)
    layout_scan_kernel(Layout a, int32_t* __restrict__ counts, int64_t ntiles,
                       int32_t* __restrict__ totals) {
  __shared__ int32_t warp_sums[32];
  const int p = blockIdx.x;
  int32_t* row = counts + int64_t(p) * ntiles;
  int32_t carry = 0;
  for (int64_t b = 0; b < ntiles; b += kScanThreads) {
    const int64_t k = b + threadIdx.x;
    const int32_t v = k < ntiles ? row[k] : 0;
    int32_t chunk;
    const int32_t ex = block_exclusive_scan(v, warp_sums, &chunk);
    if (k < ntiles) row[k] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) totals[p] = carry;
  const int64_t from = int64_t(p) * a.probe_cap + min(int64_t(carry), a.probe_cap);
  const int64_t to = int64_t(p + 1) * a.probe_cap;
  fill_block<int64_t>(reinterpret_cast<int64_t*>(a.qk), from, to, 0);
  for (int c = 0; c < a.npay; c++)
    fill_block<int64_t>(reinterpret_cast<int64_t*>(a.qpay[c]), from, to, 0);
  fill_block<int32_t>(a.lane, from, to, hash_one(0, a.salt, a.shift) & 127);
  fill_block<int32_t>(a.qocc, from, to, 0);
}

// Bytes of the scatter's dynamic shared memory at npart partitions.
constexpr int scatter_smem(int npart) { return kTile * 8 + npart * (4 + 4 + 2 * kWarps); }

__global__ void __launch_bounds__(kThreads)
    layout_scatter_kernel(Layout a, int64_t ntiles, const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ totals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npart = a.npart;
  long long* s_stage = reinterpret_cast<long long*>(smem);  // kTile, partition order
  int32_t* s_first = reinterpret_cast<int32_t*>(s_stage + kTile);  // p's first slot
  int32_t* s_off = s_first + npart;  // output rank of slot i of p: s_off[p] + i
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(s_off + npart);  // [warp][p]
  __shared__ int32_t warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x, base = t * kTile;
  const int len = int(min(int64_t(kTile), a.n - base));
  const int64_t nr = live_rows(a);
  const int64_t cap = a.probe_cap;

  if (t == 0) {  // the scan has finished: every total is there
    int over = 0;
    for (int p = threadIdx.x; p < npart; p += kThreads) over |= totals[p] > cap;
    over = __syncthreads_or(over);
    if (threadIdx.x == 0) *a.overflow = over != 0;
  }
  for (int i = threadIdx.x; i < kWarps * npart; i += kThreads) s_cnt[i] = 0;

  // this thread's rows: warp * kWarpRows + it * 32 + lane, all loads first
  long long key[kRounds];
  bool live[kRounds];
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int r = warp * kWarpRows + it * 32 + lane;
    live[it] = r < len && is_live(a, base + r, nr);
    key[it] = r < len ? __ldg(a.key + base + r) : 0;
  }
  __syncthreads();

  // rank within the warp's rows of the same partition, in row order
  int32_t slot[kRounds];  // the rank, then the staged slot; -1 for a dead row
  int32_t part[kRounds];
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int p = live[it] ? partition_of(a, key[it]) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const int c = warp * npart + max(p, 0);
    slot[it] = live[it] ? int32_t(s_cnt[c]) + __popc(peers & below) : -1;
    __syncwarp();
    if (live[it] && (peers & below) == 0) s_cnt[c] += uint16_t(__popc(peers));
    __syncwarp();
    part[it] = p;
  }
  __syncthreads();

  // per partition (thread j takes partitions [j * per, j * per + per)):
  // the warps' counts scanned in warp order, the partitions' runs in the
  // stage, and the output rank of the run's first row
  const int per = (npart + kThreads - 1) / kThreads;
  const int q0 = min(npart, int(threadIdx.x) * per), q1 = min(npart, q0 + per);
  int32_t mine = 0;
  for (int q = q0; q < q1; q++) {
    int32_t run = 0;
    for (int w = 0; w < kWarps; w++) {
      const int32_t c = s_cnt[w * npart + q];
      s_cnt[w * npart + q] = uint16_t(run);
      run += c;
    }
    s_first[q] = run;
    mine += run;
  }
  int32_t nlive;
  int32_t first = block_exclusive_scan(mine, warp_sums, &nlive);
  for (int q = q0; q < q1; q++) {
    const int32_t run = s_first[q];
    s_first[q] = first;
    s_off[q] = offsets[int64_t(q) * ntiles + t] - first;
    first += run;
  }
  __syncthreads();

#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    if (slot[it] >= 0) {
      slot[it] += s_first[part[it]] + s_cnt[warp * npart + part[it]];
      s_stage[slot[it]] = key[it];
    }
  }
  __syncthreads();

  // key, lane and qocc of each staged slot kept below probe_cap; the
  // destination kept for the payloads (-1: not written)
  int32_t dest[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; j++) {
    const int i = j * kThreads + threadIdx.x;
    dest[j] = -1;
    if (i < nlive) {
      const long long k = s_stage[i];
      const uint32_t h = uint32_t(hash_one(k, a.salt, a.shift));
      const int p = int(h >> 7);
      const int64_t g = int64_t(s_off[p]) + i;
      if (g < cap) {
        const int64_t d = int64_t(p) * cap + g;
        dest[j] = int32_t(d);
        a.qk[d] = k;
        a.lane[d] = int32_t(h & 127u);
        a.qocc[d] = 1;
      }
    }
  }

  for (int c = 0; c < a.npay; c++) {
    const long long* __restrict__ src = a.pay[c];
    long long v[kRounds];
#pragma unroll
    for (int it = 0; it < kRounds; it++)
      v[it] = slot[it] >= 0 ? __ldg(src + base + warp * kWarpRows + it * 32 + lane) : 0;
    __syncthreads();  // the stage's last column has been written out
#pragma unroll
    for (int it = 0; it < kRounds; it++)
      if (slot[it] >= 0) s_stage[slot[it]] = v[it];
    __syncthreads();
    long long* __restrict__ dst = a.qpay[c];
#pragma unroll
    for (int j = 0; j < kSlots; j++)
      if (dest[j] >= 0) dst[dest[j]] = s_stage[j * kThreads + threadIdx.x];
  }
}

// Raises the scatter's shared-memory limit once per device where a plan
// needs more than the default.
bool scatter_smem_ready(int smem) {
  static bool raised[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem <= kSmemDefault || (dev < 64 && raised[dev])) return true;
  if (cudaFuncSetAttribute(layout_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           scatter_smem(kMaxParts)) != cudaSuccess)
    return false;
  if (dev < 64) raised[dev] = true;
  return true;
}

}  // namespace

extern "C" {

// The probe layout of n rows (key 16-byte aligned, npay int64 payloads,
// keep null or n bools, num_rows a 4- or 8-byte int on the device) into
// npart = 2^pbits partitions of probe_cap slots: qk, qpays, lane, qocc of
// npart * probe_cap slots (16-byte aligned), overflow one bool. scratch
// holds scratch_words >= (ntiles + 1) * npart ints, ntiles = max(1,
// ceil(n / 4096)). npart <= 1024, n and npart * probe_cap < 2^31.
int tpq_probe_layout(const int64_t* key, const int64_t* const* pays, int npay,
                     const uint8_t* keep, const void* num_rows, int nr_size, int64_t n,
                     int pbits, int64_t probe_cap, uint32_t salt, int64_t* qk,
                     int64_t* const* qpays, int32_t* lane, int32_t* qocc, bool* overflow,
                     int32_t* scratch, int64_t scratch_words, cudaStream_t stream) {
  if (npay < 0 || npay > TPQ_MAX_COLS || pbits < 0 || (1 << pbits) > kMaxParts ||
      probe_cap < 1 || n < 0 || n >= (int64_t(1) << 31) ||
      (int64_t(probe_cap) << pbits) >= (int64_t(1) << 31) || (nr_size != 4 && nr_size != 8) ||
      (reinterpret_cast<uintptr_t>(key) & 15))
    return int(cudaErrorInvalidValue);
  Layout a;
  a.key = reinterpret_cast<const long long*>(key);
  a.npay = npay;
  for (int c = 0; c < TPQ_MAX_COLS; c++) {
    a.pay[c] = c < npay ? reinterpret_cast<const long long*>(pays[c]) : nullptr;
    a.qpay[c] = c < npay ? reinterpret_cast<long long*>(qpays[c]) : nullptr;
  }
  a.keep = keep;
  a.num_rows = num_rows;
  a.nr_size = nr_size;
  a.n = n;
  a.npart = 1 << pbits;
  a.shift = 32 - (pbits + 7);
  a.salt = salt;
  a.probe_cap = probe_cap;
  a.qk = reinterpret_cast<long long*>(qk);
  a.lane = lane;
  a.qocc = qocc;
  a.overflow = overflow;
  const int64_t ntiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  if ((ntiles + 1) * a.npart > scratch_words) return int(cudaErrorInvalidValue);
  int32_t* counts = scratch;
  int32_t* totals = scratch + ntiles * a.npart;
  const int smem = scatter_smem(a.npart);
  if (!scatter_smem_ready(smem)) return int(cudaGetLastError());
  layout_count_kernel<<<unsigned(ntiles), kThreads, a.npart * 4, stream>>>(a, ntiles, counts);
  layout_scan_kernel<<<unsigned(a.npart), kScanThreads, 0, stream>>>(a, counts, ntiles, totals);
  layout_scatter_kernel<<<unsigned(ntiles), kThreads, smem, stream>>>(a, ntiles, counts, totals);
  return int(cudaGetLastError());
}

}  // extern "C"
