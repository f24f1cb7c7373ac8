// The hash aggregate's group table for Hopper (sm_90a): one pass that
// finds or inserts every live row's key in an open-addressed table in
// device memory and adds its count and values into the key's slot
// (`group_insert_kernel`), then, once the slots are ordered by key, one
// pass that writes the groups into outputs the wrapper made zero
// (`group_write_kernel`).
//
// Replaces no TPU kernel: tpq groups by sorting the whole capacity
// (tpq/ops/hash_aggregate.py:40-110, XLA's sort, scans and one PACK
// call), which the port keeps as the fallback (ops/hash_aggregate.py
// `sort_aggregate`: a stable torch sort of every row, a gather of every
// value column, then csrc/aggregate.cu). Here only the table's slots are
// sorted (a torch sort of at most 2^21 + 1 keys), and no pass over the
// capacity remains but the outputs' memset.
//
// Contract (wrapper tpq_torch/kernels/group_table.py):
//   insert: `key` int32 or int64 [n], live = clamp(num_rows, 0, n) read
//   on the device, 0 to kGtMaxVals value columns (int32 or int64 [n]).
//   The table: keys[slots + 1] (int64), payload[(slots + 1) * width]
//   (count, then a wrapping sum a value column), `inserted` (the
//   distinct keys inserted), made anew by the wrapper at every call (in
//   a graph, by its fill nodes: no clearing pass after the call, so a
//   discarded attempt or the fallback leaves nothing behind) with every
//   key INT64_MAX and every payload word and the counter 0. A hash slot
//   (1..slots) whose key is INT64_MAX is empty; a real INT64_MAX key has
//   slot 0 of its own, so that it is no empty marker, and sorts after
//   every other key and before the empty slots (the stable sort keeps
//   slot 0 first among the INT64_MAX words). The launch adds a row's
//   count at payload word 0 of its key's slot and its value c at word
//   1 + c (width = 1 + nvals words a slot). Overflow is distinct keys > limit (half the
//   slots), counted by `inserted`: the count of successful first inserts,
//   so a deterministic function of the input (the plain twin computes
//   the same). Past the limit a block stops at its next tile and a long
//   probe gives up, since the table's output is then thrown away.
//   write: `sorted` and `perm`, the stable sort of keys[] and its slots;
//   G = min(inserted, slots + 1, n). Row g < G of the outputs is the
//   g-th slot in key order: its key (the key's dtype), count and sums;
//   rows [G, n) stay 0, as tpq's PACK leaves them; `groups` = G.
//
// Bound: device-memory bytes. The live rows of the key and values read
// once, every output slot written once: at config 4's aggregate (2^27
// rows, 49,975,306 live, 3 int64 values, 331,291 groups) 1.599 GB read
// (0.477 ms, the insert's share) and 5.369 GB written (1.603 ms, the
// write's), 2.080 ms at 3.35 TB/s. The table adds the slots it touches
// (about 21 MB there, L2-resident) and the slot sort. On an H100 the
// insert's first form, 64-bit atomics into the device's table for every
// group of a warp, took 2.09 ms; with no sum atomics 1.36 ms (the count's
// alone): the atomics set its pace, not the reads, which a plain kernel
// streams in 0.50 ms. What the design does about it:
//   - a warp takes 32 consecutive rows at a time, a lane a row, its key
//     and values in coalesced loads. `__match_any_sync` groups the lanes
//     of one key; their counts and sums are combined in the warp (a
//     shuffle tree, log2 of the group's size rounds) and only the group's
//     first lane goes on, so a hot key costs one atomic a warp and not
//     32 on one slot. At config 4 a warp's 32 rows hold 20.3 keys on
//     average: the lane join writes its output partition by partition,
//     and a probe row's matches follow each other (runs of 1.58 rows);
//   - a block takes 4,096 rows at a time and sums their groups in a
//     table of its own in shared memory (1,024 slots), then adds each of
//     them to the device's table once. At config 4 a tile holds 648 keys
//     on average (median 638, at most 1,171), so the device's table gets
//     about 6 times fewer adds and probes than the rows' warps would
//     make. Shared 64-bit atomic adds were slow (a first form with them
//     took 2.27 ms), so a sum there is two 32-bit words added with
//     32-bit atomics, the low word's carry passed on. Past 768 keys
//     in a tile, or 16 probe steps, a group goes to the device's table
//     directly (a tile of distinct keys wastes no probes);
//   - a probe of the device's table is linear over its key array (4 keys
//     a 32-byte sector): a relaxed load and compare, a compare-and-swap
//     only on an empty slot. A slot's payload row (count and sums, 32
//     bytes at 3 values) lies in one sector apart from the keys and takes
//     64-bit atomic adds (uint64: the sums wrap as the oracle's, and
//     integer adds give the same bytes in any order: two runs give the
//     same bytes);
//   - the table holds 2^21 slots at most (MAX_SLOTS in group_table.py):
//     at the 2^20-group limit the touched keys (16 MB) and payload rows
//     (32 MB at 3 values) are about the card's 50 MB of L2, so every
//     atomic stays in L2; more slots would spill it;
//   - write: the outputs are made zero by a memset (config 4's 5.37 GB
//     in 1.64 ms, 3.27 TB/s), and the kernel gathers the G groups'
//     payload rows over them; with the zeros written by the kernel's own
//     16-byte stores the write took 2.28 ms against 2.01, the slot sort
//     (0.34 ms) included in both.
//
// Every entry point returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGtThreads = 256;
constexpr int kGtTile = kGtThreads * 16;         // rows a block takes at a time
constexpr int kGtMaxVals = 4;                    // MAX_VALUES in group_table.py
constexpr int kTileSlots = 1024;  // slots of a block's own table, in shared memory
constexpr int kTileProbe = 16;    // probe steps there before a row goes to the device's
constexpr int kTileFull = kTileSlots * 3 / 4;  // its keys past which rows go there at once
constexpr long long kEmpty = 0x7fffffffffffffffll;  // an empty hash slot's key
constexpr int kProbeCheck = 32;  // probe steps between two looks at the counter

struct InsertArgs {
  const void* key;
  const void* vals[kGtMaxVals];
  int vesz[kGtMaxVals];
  int nvals, key_esz;
  const void* num_rows;
  int num_rows_esz;
  int64_t n;
  unsigned long long* keys;
  unsigned long long* payload;
  int width;
  unsigned long long* inserted;
  int64_t slots, limit;
};

struct WriteArgs {
  const long long* sorted;
  const long long* perm;
  const unsigned long long* payload;
  int width;
  void* key_out;
  int key_esz;
  int64_t* count;
  int64_t* sums[kGtMaxVals];
  int nvals;
  const unsigned long long* inserted;
  int64_t entries, n;
  int32_t* groups;
};

static __device__ __forceinline__ unsigned long long ld_relaxed_u64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// murmur3's 64-bit finalizer: every key bit reaches the low bits that
// pick the slot.
__device__ __forceinline__ uint64_t mix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return k;
}

// The sum of x over the lanes of `peers` (which holds this lane), in the
// group's lowest lane; the other lanes' results are of no use. Each round
// a lane adds the value of the next remaining peer above it and every
// second one drops out (Westphal's "voting and shuffling" reduction): a
// group of m lanes takes ceil(log2 m) rounds, a warp of distinct keys
// none. Every lane of the warp must call it.
__device__ __forceinline__ uint64_t reduce_peers(unsigned peers, uint64_t x) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1));
  unsigned rest = peers & ~((2u << lane) - 1u);  // the peers above this lane
  while (__any_sync(0xffffffffu, rest != 0)) {
    const int next = __ffs(rest);
    const uint64_t y = __shfl_sync(0xffffffffu, x, (next - 1) & 31);
    if (next) x += y;
    rest &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
  return x;
}

// The slot of key k (not kEmpty): found, or inserted into the first empty
// slot of its probe sequence (`inserted` counts it). -1 when the table
// has passed its limit before the key was placed (its output is thrown
// away).
__device__ int64_t find_or_insert(const InsertArgs& a, long long k) {
  const uint64_t mask = uint64_t(a.slots) - 1;
  uint64_t i = mix64(uint64_t(k)) & mask;
  for (int64_t step = 1;; step++) {
    unsigned long long* p = a.keys + 1 + i;
    unsigned long long cur = ld_relaxed_u64(p);
    if (cur == (unsigned long long)kEmpty) {
      cur = atomicCAS(p, (unsigned long long)kEmpty, (unsigned long long)k);
      if (cur == (unsigned long long)kEmpty) {
        atomicAdd(a.inserted, 1ull);
        return int64_t(1 + i);
      }
    }
    if (cur == (unsigned long long)k) return int64_t(1 + i);
    // a long probe looks at the counter: past the limit, give up (and a
    // sequence as long as the table means the table is full, so past it)
    if (step % kProbeCheck == 0 &&
        (step >= a.slots || int64_t(ld_relaxed_u64(a.inserted)) > a.limit))
      return -1;
    i = (i + 1) & mask;
  }
}

// A block's own table, in shared memory: a tile's groups are summed there
// and added to the device's table once the tile is done. A sum is two
// 32-bit words added with 32-bit atomics, the low word's carry passed to
// the high one (64-bit shared atomic adds were slower, the note above).
struct Tile {
  unsigned long long keys[kTileSlots];   // kEmpty: an empty slot
  unsigned count[kTileSlots];
  unsigned sum[kGtMaxVals][2][kTileSlots];  // low, high word
  int used;                              // keys inserted since the last flush
  int stop;
};

__device__ __forceinline__ void tile_add(unsigned* lo, unsigned* hi, uint64_t x) {
  const unsigned xl = unsigned(x), old = atomicAdd(lo, xl);
  const unsigned xh = unsigned(x >> 32) + (old + xl < old ? 1u : 0u);
  if (xh) atomicAdd(hi, xh);
}

// The slot of key k (not kEmpty) in the block's table, found or inserted
// within kTileProbe steps; -1 past them.
__device__ __forceinline__ int tile_find_or_insert(Tile& t, long long k) {
  unsigned i = unsigned(mix64(uint64_t(k)) >> 40) & (kTileSlots - 1);
  for (int step = 0; step < kTileProbe; step++) {
    unsigned long long cur = reinterpret_cast<volatile unsigned long long*>(t.keys)[i];
    if (cur == (unsigned long long)kEmpty) {
      cur = atomicCAS(t.keys + i, (unsigned long long)kEmpty, (unsigned long long)k);
      if (cur == (unsigned long long)kEmpty) {
        atomicAdd(&t.used, 1);
        return int(i);
      }
    }
    if (cur == (unsigned long long)k) return int(i);
    i = (i + 1) & (kTileSlots - 1);
  }
  return -1;
}

template <typename K>
__device__ __forceinline__ void insert_body(const InsertArgs& a, Tile& t) {
  const int lane = threadIdx.x & 31;
  const K* __restrict__ key = static_cast<const K*>(a.key);
  int64_t live = a.num_rows_esz == 8 ? *static_cast<const int64_t*>(a.num_rows)
                                     : *static_cast<const int32_t*>(a.num_rows);
  live = max(int64_t(0), min(live, a.n));
  const int64_t ntiles = (live + kGtTile - 1) / kGtTile;
  for (int s = threadIdx.x; s < kTileSlots; s += kGtThreads) {
    t.keys[s] = kEmpty;
    t.count[s] = 0;
    for (int c = 0; c < kGtMaxVals; c++) t.sum[c][0][s] = t.sum[c][1][s] = 0;
  }
  if (threadIdx.x == 0) t.used = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the block's table is empty; every thread has read `stop`
    if (threadIdx.x == 0) t.stop = int64_t(ld_relaxed_u64(a.inserted)) > a.limit;
    __syncthreads();
    if (t.stop) break;
    for (int j = 0; j < kGtTile; j += kGtThreads) {
      const int64_t r = tile * kGtTile + j + threadIdx.x;
      const bool valid = r < live;
      const long long k = valid ? (long long)key[r] : 0;
      uint64_t v[kGtMaxVals];
#pragma unroll
      for (int c = 0; c < kGtMaxVals; c++)
        v[c] = !valid || c >= a.nvals ? 0
               : a.vesz[c] == 8 ? uint64_t(static_cast<const int64_t*>(a.vals[c])[r])
                                : uint64_t(int64_t(static_cast<const int32_t*>(a.vals[c])[r]));
      const unsigned live_lanes = __ballot_sync(0xffffffffu, valid);
      unsigned peers = __match_any_sync(0xffffffffu, (unsigned long long)k) & live_lanes;
      if (!valid) peers = 1u << lane;  // a dead lane is a group of its own, adds 0
      int ts = -1;        // the key's slot in the block's table, else
      int64_t slot = -1;  // its slot in the device's
      if (valid && __ffs(peers) - 1 == lane) {
        const unsigned cnt = __popc(peers);
        if (k == kEmpty) {
          slot = 0;  // the INT64_MAX key's own slot: first seen where its count was 0
          if (atomicAdd(a.payload, (unsigned long long)cnt) == 0ull)
            atomicAdd(a.inserted, 1ull);
        } else {
          if (*reinterpret_cast<volatile int*>(&t.used) < kTileFull)
            ts = tile_find_or_insert(t, k);
          if (ts >= 0) {
            atomicAdd(t.count + ts, cnt);
          } else {
            slot = find_or_insert(a, k);
            if (slot >= 0) atomicAdd(a.payload + slot * a.width, (unsigned long long)cnt);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kGtMaxVals; c++) {
        if (c < a.nvals) {
          const uint64_t s = reduce_peers(peers, v[c]);
          if (ts >= 0)
            tile_add(t.sum[c][0] + ts, t.sum[c][1] + ts, s);
          else if (slot >= 0)
            atomicAdd(a.payload + slot * a.width + 1 + c, s);
        }
      }
    }
    __syncthreads();
    // the tile's groups into the device's table, and the block's emptied
    for (int s = threadIdx.x; s < kTileSlots; s += kGtThreads) {
      const unsigned long long k = t.keys[s];
      if (k == (unsigned long long)kEmpty) continue;
      const int64_t slot = find_or_insert(a, (long long)k);
      if (slot >= 0) {
        unsigned long long* to = a.payload + slot * a.width;
        atomicAdd(to, (unsigned long long)t.count[s]);
        for (int c = 0; c < a.nvals; c++)
          atomicAdd(to + 1 + c, (unsigned long long)t.sum[c][1][s] << 32 | t.sum[c][0][s]);
      }
      t.keys[s] = kEmpty;
      t.count[s] = 0;
      for (int c = 0; c < a.nvals; c++) t.sum[c][0][s] = t.sum[c][1][s] = 0;
    }
    if (threadIdx.x == 0) t.used = 0;  // read again only past the next barrier
  }
}

__global__ void __launch_bounds__(kGtThreads) group_insert_kernel(InsertArgs a) {
  __shared__ Tile t;
  if (a.key_esz == 8)
    insert_body<int64_t>(a, t);
  else
    insert_body<int32_t>(a, t);
}

template <typename K>
__device__ __forceinline__ void write_body(const WriteArgs& a) {
  const int64_t g = min(min(int64_t(*a.inserted), a.entries), a.n);
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  K* __restrict__ ko = static_cast<K*>(a.key_out);
  for (int64_t i = tid; i < g; i += stride) {
    const unsigned long long* row = a.payload + a.perm[i] * a.width;
    ko[i] = K(a.sorted[i]);
    a.count[i] = int64_t(row[0]);
#pragma unroll
    for (int c = 0; c < kGtMaxVals; c++)
      if (c < a.nvals) a.sums[c][i] = int64_t(row[1 + c]);
  }
  if (tid == 0) *a.groups = int32_t(g);
}

__global__ void __launch_bounds__(kGtThreads) group_write_kernel(WriteArgs a) {
  if (a.key_esz == 8)
    write_body<int64_t>(a);
  else
    write_body<int32_t>(a);
}

// Blocks of `kernel` that fit on the current card at once (kept a card).
template <typename F>
int64_t resident_blocks(F kernel) {
  static int64_t cap[64];
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cap[dev] > 0) return cap[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGtThreads, 0);
  const int64_t c = sms * per_sm > 0 ? int64_t(sms) * per_sm : 1;
  if (dev < 64) cap[dev] = c;
  return c;
}

int64_t grid_for(int64_t work, int64_t per_block, int64_t cap) {
  const int64_t want = (work + per_block - 1) / per_block;
  return want < 1 ? 1 : want < cap ? want : cap;
}

}  // namespace

extern "C" {

// key: key_esz (4 or 8) bytes a row; vals: nvals (0..kGtMaxVals) columns
// of vesz bytes a row; num_rows: one int32 or int64 value (num_rows_esz
// bytes) on the device; n rows. The table (see the contract above):
// keys [slots + 1], payload [(slots + 1) * (1 + nvals)], inserted;
// slots a power of two, limit = slots / 2 (the wrapper's).
int tpq_group_insert(const void* key, int key_esz, const void* const* vals, const int* vesz,
                     int nvals, const void* num_rows, int num_rows_esz, int64_t n,
                     unsigned long long* keys, unsigned long long* payload,
                     unsigned long long* inserted, int64_t slots, int64_t limit,
                     cudaStream_t stream) {
  if (nvals < 0 || nvals > kGtMaxVals || (key_esz != 4 && key_esz != 8) ||
      (num_rows_esz != 4 && num_rows_esz != 8) || slots < 1 || (slots & (slots - 1)))
    return int(cudaErrorInvalidValue);
  InsertArgs a;
  a.key = key;
  a.key_esz = key_esz;
  a.nvals = nvals;
  for (int c = 0; c < nvals; c++) {
    if (vesz[c] != 4 && vesz[c] != 8) return int(cudaErrorInvalidValue);
    a.vals[c] = vals[c];
    a.vesz[c] = vesz[c];
  }
  a.num_rows = num_rows;
  a.num_rows_esz = num_rows_esz;
  a.n = n;
  a.keys = keys;
  a.payload = payload;
  a.width = 1 + nvals;
  a.inserted = inserted;
  a.slots = slots;
  a.limit = limit;
  const int64_t grid = grid_for(n, kGtTile, resident_blocks(group_insert_kernel));
  group_insert_kernel<<<unsigned(grid), kGtThreads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

// sorted, perm: int64 [entries] (entries = slots + 1); payload and
// inserted as for tpq_group_insert; outputs key_out (key_esz bytes a
// row), count and nvals sums (int64), all [n]; groups: int32.
int tpq_group_write(const long long* sorted, const long long* perm,
                    const unsigned long long* payload, void* key_out, int key_esz,
                    int64_t* count, int64_t* const* sums, int nvals,
                    const unsigned long long* inserted, int64_t entries, int64_t n,
                    int32_t* groups, cudaStream_t stream) {
  if (nvals < 0 || nvals > kGtMaxVals || (key_esz != 4 && key_esz != 8))
    return int(cudaErrorInvalidValue);
  WriteArgs a;
  a.sorted = sorted;
  a.perm = perm;
  a.payload = payload;
  a.width = 1 + nvals;
  a.key_out = key_out;
  a.key_esz = key_esz;
  a.count = count;
  for (int c = 0; c < nvals; c++) a.sums[c] = sums[c];
  a.nvals = nvals;
  a.inserted = inserted;
  a.entries = entries;
  a.n = n;
  a.groups = groups;
  const int64_t grid = grid_for(n, kGtThreads * 8, resident_blocks(group_write_kernel));
  group_write_kernel<<<unsigned(grid), kGtThreads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
