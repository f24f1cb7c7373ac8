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
// 1, 3 and 4). Past it the count matrix alone would be (ntiles + 1) *
// npart ints, about 1 GB at config 2's 8,192 partitions over 2^27 rows:
// plans of up to kMaxParts2 partitions (config 2's, config 5's shards'
// 16,384) take the two-level partition below, larger ones the sort
// path. The scatter's 128 registers a thread
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

// ---------------------------------------------------------------------------
// The two-level layout: plans of kMaxParts + 1 to kMaxParts2 partitions,
// with the contract of the kernels above, byte for byte over all u slots.
// The pbits partition bits split into c = pbits / 2 high bits, the group
// g, and f = pbits - c low bits, the fine id j: p = g << f | j, so that a
// group's slots are one contiguous range (64 x 128 at config 2's 8,192
// partitions, 128 x 128 at config 5's shards' 16,384). A pass bins a tile
// by at most kMaxBins ids, so its per-tile bins fit a block's shared
// memory as above and its count matrix is 2^c x ntiles or 2^f x (ntiles +
// 2^c) ints (8 and 17 MB at config 2, where one pass would take 1 GB):
//   1. coarse: a stable partition of the live rows by g into a compact
//      intermediate of n rows (the key and the payloads; no padding, so
//      no row is dropped there): count (layout2_coarse_count_kernel), a
//      scan of each group's tile counts (layout2_group_scan_kernel), the
//      groups' first rows and first fine tiles (layout2_groups_kernel,
//      which also clears `overflow`), scatter
//      (layout2_coarse_scatter_kernel), each tile's rows of a group
//      written as one run (about 4,096 / 2^c rows);
//   2. fine: each group's run partitioned stably by j into its padded
//      slots, over tiles of at most kTile rows that lie inside one group
//      (fine tile T of group g: gtile[g] <= T < gtile[g + 1]; the grid is
//      ntiles + 2^c, which bounds their number, and its surplus blocks
//      exit): count (layout2_fine_count_kernel), a scan of each
//      partition's tile counts that writes its dead slots and sets
//      `overflow` (layout2_part_scan_kernel), scatter
//      (layout2_fine_scatter_kernel), which drops the ranks at or past
//      probe_cap.
// Both passes rank a tile's rows as the scatter above does, in row order
// within a bin, so a partition's rows come out in row order: the sort
// path's order. Bound by bytes: the key read twice and the payloads once,
// the live rows written to the intermediate and read back (the key
// twice), every slot written once; about 24 GB at config 2, a 7.2-ms
// bound, against 15 GB for the least a layout moves.

constexpr int kMaxParts2 = 1 << 20;  // LAYOUT2_MAX_PARTS in kernels/lane_table.py
constexpr int kMaxBins = 1024;       // the groups or fine ids of a pass, at most
static_assert(kMaxBins <= kScanThreads, "layout2_groups_kernel takes a group a thread");

struct Layout2 {
  Layout a;        // the inputs, the plan and the outputs
  int fbits;       // f: p = g << fbits | j
  int ngroups;     // 2^c
  int64_t ntiles;  // the coarse pass's tiles of the n rows
  int64_t ftiles;  // the fine pass's grid: ntiles + ngroups
  long long* mk;   // [n]: the live rows by group, in row order within one
  long long* mpay[TPQ_MAX_COLS];
  int32_t* ccounts;  // [ngroups * ntiles]: group-major, then scanned
  int32_t* gtotal;   // [ngroups]: live rows of group g
  int32_t* gbase;    // [ngroups + 1]: group g's first intermediate row
  int32_t* gtile;    // [ngroups + 1]: group g's first fine tile
  int32_t* fcounts;  // [2^fbits * ftiles]: fine-id-major, then scanned
};

template <bool kFine>
__device__ __forceinline__ int bin_of(const Layout2& L, long long key) {
  const int p = partition_of(L.a, key);
  return kFine ? p & ((1 << L.fbits) - 1) : p >> L.fbits;
}

// The block's tile: in the coarse pass tile blockIdx.x of the input rows;
// in the fine pass tile blockIdx.x of the intermediate, inside group *g,
// or false for a surplus block. Every thread of the block gets the same.
template <bool kFine>
__device__ __forceinline__ bool tile_of(const Layout2& L, int* g, int64_t* base, int* len) {
  const int64_t t = blockIdx.x;
  if (!kFine) {
    *g = 0;
    *base = t * kTile;
    *len = int(min(int64_t(kTile), L.a.n - *base));
    return true;
  }
  __shared__ int s_g;
  if (threadIdx.x == 0) {
    int lo = 0, hi = L.ngroups - 1;  // the last group whose first tile is at or before t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (L.gtile[mid] <= t)
        lo = mid;
      else
        hi = mid - 1;
    }
    s_g = t < L.gtile[L.ngroups] ? lo : -1;
  }
  __syncthreads();
  *g = s_g;
  if (*g < 0) return false;
  *base = L.gbase[*g] + (t - L.gtile[*g]) * kTile;
  *len = int(min(int64_t(kTile), int64_t(L.gbase[*g + 1]) - *base));
  return true;
}

// Counts of the tile's live rows by bin, written bin-major.
template <bool kFine>
__device__ __forceinline__ void count_tile(const Layout2& L) {
  constexpr int kRows = kTile / kThreads;
  __shared__ int32_t s_bin[kMaxBins];
  int g, len;
  int64_t base;
  if (!tile_of<kFine>(L, &g, &base, &len)) return;
  const int nbins = kFine ? 1 << L.fbits : L.ngroups;
  for (int b = threadIdx.x; b < nbins; b += kThreads) s_bin[b] = 0;
  const long long* src = kFine ? L.mk : L.a.key;
  const int64_t nr = kFine ? 0 : live_rows(L.a);
  long long key[kRows];
  bool live[kRows];
#pragma unroll
  for (int it = 0; it < kRows; it++) {
    const int r = it * kThreads + threadIdx.x;
    live[it] = r < len && (kFine || is_live(L.a, base + r, nr));
    key[it] = live[it] ? __ldg(src + base + r) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kRows; it++)
    if (live[it]) atomicAdd(&s_bin[bin_of<kFine>(L, key[it])], 1);
  __syncthreads();
  int32_t* counts = kFine ? L.fcounts : L.ccounts;
  const int64_t stride = kFine ? L.ftiles : L.ntiles;
  for (int b = threadIdx.x; b < nbins; b += kThreads)
    counts[int64_t(b) * stride + blockIdx.x] = s_bin[b];
}

// Block g: the exclusive scan of group g's tile counts in place, and its
// total.
__global__ void __launch_bounds__(kScanThreads) layout2_group_scan_kernel(Layout2 L) {
  __shared__ int32_t warp_sums[32];
  const int g = blockIdx.x;
  int32_t* row = L.ccounts + int64_t(g) * L.ntiles;
  int32_t carry = 0;
  for (int64_t b = 0; b < L.ntiles; b += kScanThreads) {
    const int64_t k = b + threadIdx.x;
    const int32_t v = k < L.ntiles ? row[k] : 0;
    int32_t chunk;
    const int32_t ex = block_exclusive_scan(v, warp_sums, &chunk);
    if (k < L.ntiles) row[k] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) L.gtotal[g] = carry;
}

// One block, a thread a group: the groups' first rows and first fine
// tiles; `overflow` cleared for the partition scan to set.
__global__ void __launch_bounds__(kScanThreads) layout2_groups_kernel(Layout2 L) {
  __shared__ int32_t warp_sums[32];
  const int g = threadIdx.x;
  const int32_t rows = g < L.ngroups ? L.gtotal[g] : 0;
  int32_t nrows, ntiles;
  const int32_t first_row = block_exclusive_scan(rows, warp_sums, &nrows);
  const int32_t tiles = rows / kTile + (rows % kTile != 0);
  const int32_t first_tile = block_exclusive_scan(tiles, warp_sums, &ntiles);
  if (g < L.ngroups) {
    L.gbase[g] = first_row;
    L.gtile[g] = first_tile;
  }
  if (g == 0) {
    L.gbase[L.ngroups] = nrows;
    L.gtile[L.ngroups] = ntiles;
    *L.a.overflow = false;
  }
}

// Block p: the exclusive scan in place of partition p's counts over its
// group's fine tiles, `overflow` set where its total passes probe_cap,
// and its dead slots, as layout_scan_kernel writes them.
__global__ void __launch_bounds__(kScanThreads) layout2_part_scan_kernel(Layout2 L) {
  __shared__ int32_t warp_sums[32];
  const Layout& a = L.a;
  const int p = blockIdx.x, g = p >> L.fbits, j = p & ((1 << L.fbits) - 1);
  const int64_t t0 = L.gtile[g], t1 = L.gtile[g + 1];
  int32_t* row = L.fcounts + int64_t(j) * L.ftiles;
  int32_t carry = 0;
  for (int64_t b = t0; b < t1; b += kScanThreads) {
    const int64_t k = b + threadIdx.x;
    const int32_t v = k < t1 ? row[k] : 0;
    int32_t chunk;
    const int32_t ex = block_exclusive_scan(v, warp_sums, &chunk);
    if (k < t1) row[k] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0 && carry > a.probe_cap) *a.overflow = true;
  const int64_t from = int64_t(p) * a.probe_cap + min(int64_t(carry), a.probe_cap);
  const int64_t to = int64_t(p + 1) * a.probe_cap;
  fill_block<int64_t>(reinterpret_cast<int64_t*>(a.qk), from, to, 0);
  for (int c = 0; c < a.npay; c++)
    fill_block<int64_t>(reinterpret_cast<int64_t*>(a.qpay[c]), from, to, 0);
  fill_block<int32_t>(a.lane, from, to, hash_one(0, a.salt, a.shift) & 127);
  fill_block<int32_t>(a.qocc, from, to, 0);
}

// The scatter of layout_scatter_kernel over bins: the tile's live rows
// ranked stably within their bin, staged in bin order, and each bin's run
// written to consecutive rows: of the intermediate from the group's first
// row (coarse), of the partition's slots below probe_cap (fine, with the
// lane and qocc).
template <bool kFine>
__device__ __forceinline__ void scatter_tile(const Layout2& L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t warp_sums[32];
  const Layout& a = L.a;
  int g, len;
  int64_t base;
  if (!tile_of<kFine>(L, &g, &base, &len)) return;
  const int nbins = kFine ? 1 << L.fbits : L.ngroups;
  long long* s_stage = reinterpret_cast<long long*>(smem);  // kTile, bin order
  int32_t* s_first = reinterpret_cast<int32_t*>(s_stage + kTile);  // the bin's first slot
  int32_t* s_off = s_first + nbins;  // destination of slot i of bin b: s_off[b] + i
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(s_off + nbins);  // [warp][bin]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t nr = kFine ? 0 : live_rows(a);
  const long long* src = kFine ? L.mk : a.key;
  for (int i = threadIdx.x; i < kWarps * nbins; i += kThreads) s_cnt[i] = 0;

  long long key[kRounds];
  bool live[kRounds];
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int r = warp * kWarpRows + it * 32 + lane;
    live[it] = r < len && (kFine || is_live(a, base + r, nr));
    key[it] = live[it] ? __ldg(src + base + r) : 0;
  }
  __syncthreads();

  int32_t slot[kRounds];  // the rank, then the staged slot; -1 for a dead row
  int32_t bin[kRounds];
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    const int b = live[it] ? bin_of<kFine>(L, key[it]) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int c = warp * nbins + max(b, 0);
    slot[it] = live[it] ? int32_t(s_cnt[c]) + __popc(peers & below) : -1;
    __syncwarp();
    if (live[it] && (peers & below) == 0) s_cnt[c] += uint16_t(__popc(peers));
    __syncwarp();
    bin[it] = b;
  }
  __syncthreads();

  const int per = (nbins + kThreads - 1) / kThreads;
  const int q0 = min(nbins, int(threadIdx.x) * per), q1 = min(nbins, q0 + per);
  int32_t mine = 0;
  for (int q = q0; q < q1; q++) {
    int32_t run = 0;
    for (int w = 0; w < kWarps; w++) {
      const int32_t c = s_cnt[w * nbins + q];
      s_cnt[w * nbins + q] = uint16_t(run);
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
    const int32_t at = kFine ? L.fcounts[int64_t(q) * L.ftiles + t]
                             : L.gbase[q] + L.ccounts[int64_t(q) * L.ntiles + t];
    s_off[q] = at - first;
    first += run;
  }
  __syncthreads();

#pragma unroll
  for (int it = 0; it < kRounds; it++) {
    if (slot[it] >= 0) {
      slot[it] += s_first[bin[it]] + s_cnt[warp * nbins + bin[it]];
      s_stage[slot[it]] = key[it];
    }
  }
  __syncthreads();

  // each staged slot's key (and in the fine pass its lane and qocc)
  // written; the destination kept for the payloads (-1: not written)
  int32_t dest[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; j++) {
    const int i = j * kThreads + threadIdx.x;
    dest[j] = -1;
    if (i < nlive) {
      const long long k = s_stage[i];
      const uint32_t h = uint32_t(hash_one(k, a.salt, a.shift));
      const int b = kFine ? int(h >> 7) & ((1 << L.fbits) - 1) : int(h >> 7) >> L.fbits;
      const int64_t r = int64_t(s_off[b]) + i;
      if (!kFine) {
        dest[j] = int32_t(r);
        L.mk[r] = k;
      } else if (r < a.probe_cap) {
        const int64_t d = int64_t((g << L.fbits) | b) * a.probe_cap + r;
        dest[j] = int32_t(d);
        a.qk[d] = k;
        a.lane[d] = int32_t(h & 127u);
        a.qocc[d] = 1;
      }
    }
  }

  for (int c = 0; c < a.npay; c++) {
    const long long* __restrict__ psrc = kFine ? L.mpay[c] : a.pay[c];
    long long v[kRounds];
#pragma unroll
    for (int it = 0; it < kRounds; it++)
      v[it] = slot[it] >= 0 ? __ldg(psrc + base + warp * kWarpRows + it * 32 + lane) : 0;
    __syncthreads();  // the stage's last column has been written out
#pragma unroll
    for (int it = 0; it < kRounds; it++)
      if (slot[it] >= 0) s_stage[slot[it]] = v[it];
    __syncthreads();
    long long* __restrict__ pdst = kFine ? a.qpay[c] : L.mpay[c];
#pragma unroll
    for (int j = 0; j < kSlots; j++)
      if (dest[j] >= 0) pdst[dest[j]] = s_stage[j * kThreads + threadIdx.x];
  }
}

// The passes' kernels, one name each, so that a trace tells them apart.
__global__ void __launch_bounds__(kThreads) layout2_coarse_count_kernel(Layout2 L) {
  count_tile<false>(L);
}

__global__ void __launch_bounds__(kThreads) layout2_coarse_scatter_kernel(Layout2 L) {
  scatter_tile<false>(L);
}

__global__ void __launch_bounds__(kThreads) layout2_fine_count_kernel(Layout2 L) {
  count_tile<true>(L);
}

__global__ void __launch_bounds__(kThreads) layout2_fine_scatter_kernel(Layout2 L) {
  scatter_tile<true>(L);
}

// Raises a two-level scatter's shared-memory limit once per device where
// a plan needs more than the default.
template <bool kFine>
bool scatter2_smem_ready(int smem) {
  static bool raised[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem <= kSmemDefault || (dev < 64 && raised[dev])) return true;
  if (cudaFuncSetAttribute(kFine ? layout2_fine_scatter_kernel : layout2_coarse_scatter_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           scatter_smem(kMaxBins)) != cudaSuccess)
    return false;
  if (dev < 64) raised[dev] = true;
  return true;
}

// The int32 words of the two-level layout's scratch: both count matrices
// and the group tables; under 2^31 for n < 2^31 and pbits <= 20.
int64_t layout2_scratch_words(int64_t n, int pbits) {
  const int64_t ntiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  const int64_t ngroups = int64_t(1) << (pbits / 2), nfine = int64_t(1) << (pbits - pbits / 2);
  return ngroups * ntiles + ngroups + 2 * (ngroups + 1) + nfine * (ntiles + ngroups);
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

int tpq_probe_layout2_scratch(int64_t n, int pbits) {
  return int(layout2_scratch_words(n, pbits));
}

// The probe layout of tpq_probe_layout by the two-level partition, for
// plans of up to 2^20 partitions: the same arguments (key with no
// alignment asked), and mid, mid_words >= (1 + npay) * n int64 for the
// intermediate, scratch of scratch_words >= tpq_probe_layout2_scratch(n,
// pbits) ints. n and npart * probe_cap < 2^31.
int tpq_probe_layout2(const int64_t* key, const int64_t* const* pays, int npay,
                      const uint8_t* keep, const void* num_rows, int nr_size, int64_t n,
                      int pbits, int64_t probe_cap, uint32_t salt, int64_t* qk,
                      int64_t* const* qpays, int32_t* lane, int32_t* qocc, bool* overflow,
                      int64_t* mid, int64_t mid_words, int32_t* scratch,
                      int64_t scratch_words, cudaStream_t stream) {
  if (npay < 0 || npay > TPQ_MAX_COLS || pbits < 0 || (int64_t(1) << pbits) > kMaxParts2 ||
      probe_cap < 1 || n < 0 || n >= (int64_t(1) << 31) ||
      (int64_t(probe_cap) << pbits) >= (int64_t(1) << 31) || (nr_size != 4 && nr_size != 8) ||
      mid_words < (1 + npay) * n || scratch_words < layout2_scratch_words(n, pbits))
    return int(cudaErrorInvalidValue);
  Layout2 L;
  Layout& a = L.a;
  a.key = reinterpret_cast<const long long*>(key);
  a.npay = npay;
  for (int c = 0; c < TPQ_MAX_COLS; c++) {
    a.pay[c] = c < npay ? reinterpret_cast<const long long*>(pays[c]) : nullptr;
    a.qpay[c] = c < npay ? reinterpret_cast<long long*>(qpays[c]) : nullptr;
    L.mpay[c] = c < npay ? reinterpret_cast<long long*>(mid + (c + 1) * n) : nullptr;
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
  L.fbits = pbits - pbits / 2;
  L.ngroups = 1 << (pbits / 2);
  L.ntiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  L.ftiles = L.ntiles + L.ngroups;
  L.mk = reinterpret_cast<long long*>(mid);
  L.ccounts = scratch;
  L.gtotal = L.ccounts + L.ngroups * L.ntiles;
  L.gbase = L.gtotal + L.ngroups;
  L.gtile = L.gbase + L.ngroups + 1;
  L.fcounts = L.gtile + L.ngroups + 1;
  const int coarse_smem = scatter_smem(L.ngroups), fine_smem = scatter_smem(1 << L.fbits);
  if (!scatter2_smem_ready<false>(coarse_smem) || !scatter2_smem_ready<true>(fine_smem))
    return int(cudaGetLastError());
  layout2_coarse_count_kernel<<<unsigned(L.ntiles), kThreads, 0, stream>>>(L);
  layout2_group_scan_kernel<<<unsigned(L.ngroups), kScanThreads, 0, stream>>>(L);
  layout2_groups_kernel<<<1, kScanThreads, 0, stream>>>(L);
  layout2_coarse_scatter_kernel<<<unsigned(L.ntiles), kThreads, coarse_smem, stream>>>(L);
  layout2_fine_count_kernel<<<unsigned(L.ftiles), kThreads, 0, stream>>>(L);
  layout2_part_scan_kernel<<<unsigned(a.npart), kScanThreads, 0, stream>>>(L);
  layout2_fine_scatter_kernel<<<unsigned(L.ftiles), kThreads, fine_smem, stream>>>(L);
  return int(cudaGetLastError());
}

}  // extern "C"
