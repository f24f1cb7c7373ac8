// The hash aggregate's run-end pass for Hopper (sm_90a): one launch that
// turns a key-sorted table into its groups.
//
// Replaces tpq/ops/hash_aggregate.py:59-110, which is no TPU kernel: XLA
// fuses its scans (run starts, a cummax of run starts, u64 cumsums as
// u32 plane pairs and their fill-forward) and then calls PACK
// (tpq/kernels/move.py `pack`, :242, called at :103) to compact the
// run-end rows. The port ran that chain as some twenty full-capacity
// torch passes around its own PACK call. Here it is one pass.
//
// Contract (wrapper tpq_torch/kernels/aggregate.py `aggregate_runs`):
// `key` int32 or int64 [n], ascending over the valid prefix [0, live),
// live = clamp(num_rows, 0, n) read on the device; 0 to kAggMaxVals
// value columns, int32 or int64 [n]. Row i < live ends a run when
// i == live - 1 or key[i + 1] != key[i]. For the g-th run end (g < G):
// key_out[g] its key, count[g] its rows, sums[c][g] the wrapping int64
// sum of column c over its rows (an int32 value widened first). Rows
// [G, n) of every output are 0, as tpq's PACK leaves them; `groups` = G.
//
// Bound: device-memory bytes. The valid rows of the key and values read
// once (one key past a tile's end besides), every output slot written
// once: at config 4's aggregate (2^27 rows, 49,975,306 valid, 3 int64
// values) 1.599 GB read and 5.369 GB written, 2.080 ms at 3.35 TB/s; the
// zero-fill past G is 77 % of the bytes. What the design does about it:
//   - a persistent grid takes 4,096-row tiles in order through an
//     atomic ticket (common.cuh draw_ticket), and only the tiles that
//     hold valid rows: no pass over the capacity but the zero-fill;
//   - a thread owns 16 consecutive rows, read in 16-byte loads; run ends
//     come from neighbour compares (the tile's last thread reads one key
//     past it), validity from the row index against live: no mask, no
//     arange and no cumsum is materialized;
//   - a tile's groups are the run ends it holds. Their keys, counts and
//     sums are staged in shared memory and stored contiguously at the
//     tile's first group. A count is the distance between two run-end
//     rows; a sum the difference of the tile's inclusive prefix sums at
//     two run ends (one block scan a value column, added in uint64:
//     signed overflow is undefined, and the oracle wraps);
//   - the one thing a tile needs from its predecessors is the number of
//     run ends before it and the count and sums of the run it begins
//     in: a decoupled look-back (Merrill & Garland, 2016) in the
//     reduce-by-key form. A tile's aggregate is (run ends, the count and
//     sums of its trailing open run), combined as (a.ends + b.ends,
//     b.ends > 0 ? b.open : a.open + b.open). Its record is a 64-bit
//     flag word (launch epoch << 32 | inclusive << 31 | run ends) and
//     two payloads, the aggregate's open run and the inclusive one's:
//     one thread writes a payload, then the flag under st.release, and a
//     reader takes the flag with ld.acquire before its payload. The
//     inclusive publish never rewrites what a reader of the aggregate
//     may be reading. No atomics on values: two runs give the same
//     bytes;
//   - once the last valid tile's inclusive prefix is out, every block
//     zeroes its share of [G, n) in 16-byte stores.
// The state buffer (epoch and ticket word, wrap count, then the tiles'
// records) has the layout of PACK's (common.cuh) but is a buffer of its
// own, kept per device, stream and value-column count (owner
// tpq_torch/kernels/aggregate.py `state_owner`): a record's payloads may
// hold any 64 bits, so no launch that reads a word as a status may share
// it, and a record's flag word sits at the same place in every launch.
//
// Every entry point returns cudaGetLastError() (0 on success).

#include "common.cuh"

namespace {

constexpr int kAggThreads = 256;
constexpr int kAggWarps = kAggThreads / 32;
constexpr int kAggRows = 16;                           // rows a thread owns
constexpr int kAggTile = kAggThreads * kAggRows;       // AGG_TILE in aggregate.py
constexpr int kAggMaxVals = TPQ_MAX_COLS - 2;          // MAX_VALUES in aggregate.py

struct AggArgs {
  const void* key;
  const void* vals[kAggMaxVals];
  int vesz[kAggMaxVals];
  void* key_out;
  int64_t* count;
  int64_t* sums[kAggMaxVals];
  int nvals, key_esz;
  const void* num_rows;
  int num_rows_esz;
  int64_t n;
  uint64_t* state;
  int64_t state_words;
  int32_t* groups;
};

// The shared memory of a block, for either key type.
struct AggShared {
  uint64_t stage[kAggTile];  // a tile's run-end keys, then its prefix sums at run ends
  uint64_t wsum[kAggWarps][kAggMaxVals];
  uint64_t scan[32];
  uint64_t open[kAggMaxVals + 1];  // the tile's trailing open run: count, sums
  uint64_t pre[kAggMaxVals + 1];   // the open run before the tile: count, sums
  int32_t warp_sums[32];
  int64_t ticket, last_end, prefix_ends, groups;
  uint32_t epoch;
};

static __device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exclusive scan of one uint64 per thread across the block, in thread
// order (wrapping). Every thread of the block must call it.
__device__ __forceinline__ uint64_t block_exclusive_scan_u64(uint64_t v, uint64_t* scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint64_t w = lane < kAggWarps ? scan[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kAggWarps) scan[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const uint64_t excl = x - v + (warp > 0 ? scan[warp - 1] : 0);
  __syncthreads();  // scan is reused by the next call
  return excl;
}

// Rows [r0, r0 + kAggRows) of a column as O, the rows outside [from, to)
// as 0: 16-byte loads when the thread's rows all lie inside and the
// column is 16-byte aligned, else one guarded load a row.
template <typename T, typename O>
__device__ __forceinline__ void load_rows(const T* __restrict__ p, int64_t r0, int64_t from,
                                          int64_t to, O (&v)[kAggRows]) {
  const bool vec = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  if (vec && from <= r0 && r0 + kAggRows <= to) {
    if constexpr (sizeof(T) == 8) {
      const longlong2* q = reinterpret_cast<const longlong2*>(p + r0);
#pragma unroll
      for (int i = 0; i < kAggRows / 2; i++) {
        const longlong2 x = q[i];
        v[2 * i] = O(x.x), v[2 * i + 1] = O(x.y);
      }
    } else {
      const int4* q = reinterpret_cast<const int4*>(p + r0);
#pragma unroll
      for (int i = 0; i < kAggRows / 4; i++) {
        const int4 x = q[i];
        v[4 * i] = O(x.x), v[4 * i + 1] = O(x.y), v[4 * i + 2] = O(x.z), v[4 * i + 3] = O(x.w);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kAggRows; j++) {
      const int64_t r = r0 + j;
      v[j] = r >= from && r < to ? O(p[r]) : O(0);
    }
  }
}

// Value column c's rows as uint64 (an int32 value sign-extended, as
// .to(int64) widens it).
__device__ __forceinline__ void load_values(const AggArgs& a, int c, int64_t r0, int64_t from,
                                            int64_t to, uint64_t (&v)[kAggRows]) {
  if (a.vesz[c] == 8)
    load_rows(static_cast<const int64_t*>(a.vals[c]), r0, from, to, v);
  else
    load_rows(static_cast<const int32_t*>(a.vals[c]), r0, from, to, v);
}

// Writes a tile's n groups of one int64 column at [pe, pe + n): group i
// is s[i] - s[i - 1], group 0 s[0] + carry (the open run before the
// tile). s holds an inclusive prefix from the tile's first row, sampled
// at its run ends.
__device__ __forceinline__ void write_groups(int64_t* __restrict__ out, int64_t pe, int n,
                                             const uint64_t* s, uint64_t carry) {
  for (int i = threadIdx.x; i < n; i += kAggThreads)
    out[pe + i] = int64_t(s[i] - (i > 0 ? s[i - 1] : uint64_t(0) - carry));
}

// Warp 0 of a block, all lanes. Publishes tile t's aggregate (its run
// ends and open run, open[0, nv1)), looks back over its predecessors 32
// at a time and publishes its inclusive prefix. Returns the run ends
// before the tile and leaves the open run before it in pre[0, nv1).
// Record t is status[t * w, t * w + w): the flag word, the aggregate's
// open run, the inclusive prefix's open run.
__device__ int64_t agg_look_back(uint64_t* status, int64_t t, int w, int nv1, uint32_t ends,
                                 const uint64_t* open, uint64_t* pre, uint64_t tag) {
  const int lane = threadIdx.x & 31;
  uint64_t* mine = status + t * w;
  if (lane < nv1) pre[lane] = 0;
  __syncwarp();
  if (t == 0) {
    if (lane == 0) {
      for (int k = 0; k < nv1; k++) mine[1 + nv1 + k] = open[k];
      st_release(mine, tag | kInclusive | ends);
    }
    return 0;
  }
  if (lane == 0) {
    for (int k = 0; k < nv1; k++) mine[1 + k] = open[k];
    st_release(mine, tag | ends);
  }
  int64_t prefix = 0;
  bool open_done = false;  // the predecessors read so far hold a run end
  for (int64_t top = t - 1;; top -= 32) {
    const int64_t i = top - lane;  // lane 0 is the nearest predecessor
    uint64_t f;
    bool ready;
    do {
      f = i >= 0 ? ld_acquire(status + i * w) : (tag | kInclusive);
      ready = (f & kTagMask) == tag;
    } while (!__all_sync(0xffffffffu, ready));
    const bool inc = (f & kInclusive) != 0;
    const unsigned incl = __ballot_sync(0xffffffffu, inc);
    const int last = incl ? __ffs(incl) - 1 : 31;  // nearest inclusive lane
    const uint64_t e = f & kCountMask;
    prefix += int64_t(warp_sum(lane <= last ? e : 0));
    if (!open_done) {
      // the open run reaches back to the nearest record with a run end
      // or an inclusive prefix, that one's open run included
      const unsigned stop = __ballot_sync(0xffffffffu, lane <= last && (e > 0 || inc));
      const int upto = stop ? __ffs(stop) - 1 : 31;
      const bool take = lane <= upto && i >= 0;
      const uint64_t* rec = status + (take ? i * w + 1 + (inc ? nv1 : 0) : 0);
      for (int k = 0; k < nv1; k++) {
        const uint64_t v = warp_sum(take ? ld_relaxed(rec + k) : 0);
        if (lane == 0) pre[k] += v;
      }
      open_done = stop != 0;
    }
    if (incl) break;
  }
  if (lane == 0) {
    for (int k = 0; k < nv1; k++) mine[1 + nv1 + k] = ends > 0 ? open[k] : pre[k] + open[k];
    st_release(mine, tag | kInclusive | uint64_t(prefix + ends));
  }
  return prefix;
}

template <typename K>
__device__ __forceinline__ void agg_body(const AggArgs& a, AggShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = a.nvals, nv1 = nv + 1, w = 1 + 2 * nv1;
  uint64_t* status = a.state + kStateHeader;
  const K* __restrict__ key = static_cast<const K*>(a.key);
  int64_t live = a.num_rows_esz == 8 ? *static_cast<const int64_t*>(a.num_rows)
                                     : *static_cast<const int32_t*>(a.num_rows);
  live = max(int64_t(0), min(live, a.n));
  const int64_t ntiles = (live + kAggTile - 1) / kAggTile;  // the tiles with valid rows

  for (;;) {
    if (threadIdx.x == 0) {
      const uint64_t t = draw_ticket(a.state, &sh.epoch);
      // the launch's last ticket: every block has drawn its final one
      if (t == uint64_t(ntiles) + gridDim.x - 1) finish_tickets(a.state, sh.epoch);
      sh.ticket = int64_t(t);
    }
    __syncthreads();
    const int64_t t = sh.ticket;
    if (t >= ntiles) break;
    const uint64_t tag = uint64_t(sh.epoch) << 32;
    const int64_t base = t * kAggTile;
    const int64_t lim = min(base + kAggTile, live);
    const int64_t r0 = base + int64_t(threadIdx.x) * kAggRows;

    // run ends among the thread's rows, then their places in the tile
    uint32_t endm = 0;
    int epos;
    int tile_ends;
    {
      K k[kAggRows];
      load_rows(key, r0, r0, lim, k);
      const K next = r0 + kAggRows < live ? key[r0 + kAggRows] : K(0);
#pragma unroll
      for (int j = 0; j < kAggRows; j++) {
        const int64_t r = r0 + j;
        const K nk = j + 1 < kAggRows ? k[j + 1] : next;
        if (r < lim && (r + 1 >= live || nk != k[j])) endm |= 1u << j;
      }
      int32_t total;
      epos = block_exclusive_scan(__popc(endm), sh.warp_sums, &total);
      tile_ends = total;
      K* ks = reinterpret_cast<K*>(sh.stage);  // the run-end keys, staged
      int p = epos;
#pragma unroll
      for (int j = 0; j < kAggRows; j++)
        if ((endm >> j) & 1) ks[p++] = k[j];
      if (endm && epos + __popc(endm) == tile_ends) sh.last_end = r0 + 31 - __clz(endm);
      if (threadIdx.x == 0 && tile_ends == 0) sh.last_end = base - 1;
    }
    __syncthreads();
    const int64_t le = sh.last_end;

    // the tile's open run: its rows after the last run end
    for (int c = 0; c < nv; c++) {
      uint64_t v[kAggRows];
      load_values(a, c, r0, le + 1, lim, v);
      uint64_t s = 0;
#pragma unroll
      for (int j = 0; j < kAggRows; j++) s += v[j];
      s = warp_sum(s);
      if (lane == 0) sh.wsum[warp][c] = s;
    }
    __syncthreads();
    if (threadIdx.x < nv) {
      uint64_t s = 0;
      for (int i = 0; i < kAggWarps; i++) s += sh.wsum[i][threadIdx.x];
      sh.open[1 + threadIdx.x] = s;
    }
    if (threadIdx.x == 0) sh.open[0] = uint64_t(lim - le - 1);
    __syncthreads();

    if (warp == 0) {
      const int64_t p =
          agg_look_back(status, t, w, nv1, uint32_t(tile_ends), sh.open, sh.pre, tag);
      if (lane == 0) {
        sh.prefix_ends = p;
        if (t == ntiles - 1) *a.groups = int32_t(p + tile_ends);
      }
    }
    __syncthreads();
    if (tile_ends == 0) continue;  // the next ticket is drawn after a barrier
    const int64_t pe = sh.prefix_ends;

    {
      K* __restrict__ ko = static_cast<K*>(a.key_out);
      const K* ks = reinterpret_cast<const K*>(sh.stage);
      for (int i = threadIdx.x; i < tile_ends; i += kAggThreads) ko[pe + i] = ks[i];
    }
    __syncthreads();
    // count: the rows from the tile's start through each run end
    {
      int p = epos;
#pragma unroll
      for (int j = 0; j < kAggRows; j++)
        if ((endm >> j) & 1) sh.stage[p++] = uint64_t(r0 + j - base + 1);
    }
    __syncthreads();
    write_groups(a.count, pe, tile_ends, sh.stage, sh.pre[0]);
    __syncthreads();
    for (int c = 0; c < nv; c++) {
      uint64_t v[kAggRows];
      load_values(a, c, r0, r0, le + 1, v);
      uint64_t s = 0;
#pragma unroll
      for (int j = 0; j < kAggRows; j++) s += v[j];
      s = block_exclusive_scan_u64(s, sh.scan);
      int p = epos;
#pragma unroll
      for (int j = 0; j < kAggRows; j++) {
        s += v[j];
        if ((endm >> j) & 1) sh.stage[p++] = s;
      }
      __syncthreads();
      write_groups(a.sums[c], pe, tile_ends, sh.stage, sh.pre[1 + c]);
      __syncthreads();
    }
  }

  // every valid tile is taken; zeros from G on, once the last valid
  // tile's inclusive prefix is out (its holder is running: no deadlock)
  if (threadIdx.x == 0) {
    const uint64_t tag = uint64_t(sh.epoch) << 32;
    int64_t g = 0;
    if (ntiles > 0) {
      uint64_t f;
      while (((f = ld_acquire(status + (ntiles - 1) * w)) & (kTagMask | kInclusive)) !=
             (tag | kInclusive))
        __nanosleep(64);
      g = int64_t(f & kCountMask);
    } else {
      *a.groups = 0;  // no valid row: every block writes the same 0
    }
    sh.groups = g;
    finish_block(a.state, a.state_words, sh.epoch);
  }
  __syncthreads();
  const int64_t g = sh.groups;
  zero_range<K>(a.key_out, g, a.n);
  zero_range<int64_t>(a.count, g, a.n);
  for (int c = 0; c < nv; c++) zero_range<int64_t>(a.sums[c], g, a.n);
}

__global__ void __launch_bounds__(kAggThreads) agg_runs_kernel(AggArgs a) {
  __shared__ __align__(16) AggShared sh;
  if (a.key_esz == 8)
    agg_body<int64_t>(a, sh);
  else
    agg_body<int32_t>(a, sh);
}

// Blocks of agg_runs_kernel that fit on the current card at once.
int agg_grid_cap() {
  static int cap[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cap[dev] > 0) return cap[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, agg_runs_kernel, kAggThreads, 0);
  const int c = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < 64) cap[dev] = c;
  return c;
}

// The words of state a call needs beyond the header: one record of
// 1 + 2 * (nvals + 1) words a 4,096-row tile (state_words in
// aggregate.py).
int64_t agg_state_words(int64_t n, int nvals) {
  return (n + kAggTile - 1) / kAggTile * (1 + 2 * (nvals + 1));
}

}  // namespace

extern "C" {

// key: key_esz (4 or 8) bytes a row; vals: nvals (0..kAggMaxVals)
// columns of vesz bytes a row; num_rows: one int32 or int64 value
// (num_rows_esz bytes) on the device. Outputs: key_out (key_esz bytes a
// row), count and sums (int64), all [n], and groups (int32). state:
// state_words >= kStateHeader + agg_state_words(n, nvals)
// words, zero before the first call on the stream and left for the next
// one (layout in common.cuh).
int tpq_aggregate_runs(const void* key, int key_esz, const void* const* vals,
                       const int* vesz, int nvals, const void* num_rows, int num_rows_esz,
                       int64_t n, void* key_out, int64_t* count, int64_t* const* sums,
                       uint64_t* state, int64_t state_words, int32_t* groups,
                       cudaStream_t stream) {
  if (nvals < 0 || nvals > kAggMaxVals || (key_esz != 4 && key_esz != 8) ||
      (num_rows_esz != 4 && num_rows_esz != 8))
    return int(cudaErrorInvalidValue);
  if (kStateHeader + agg_state_words(n, nvals) > state_words)
    return int(cudaErrorInvalidValue);
  AggArgs a;
  a.key = key;
  a.key_esz = key_esz;
  a.nvals = nvals;
  for (int c = 0; c < nvals; c++) {
    if (vesz[c] != 4 && vesz[c] != 8) return int(cudaErrorInvalidValue);
    a.vals[c] = vals[c];
    a.vesz[c] = vesz[c];
    a.sums[c] = sums[c];
  }
  a.key_out = key_out;
  a.count = count;
  a.num_rows = num_rows;
  a.num_rows_esz = num_rows_esz;
  a.n = n;
  a.state = state;
  a.state_words = state_words;
  a.groups = groups;
  const int64_t ntiles = (n + kAggTile - 1) / kAggTile;
  const int64_t cap = agg_grid_cap();
  const int64_t grid = ntiles < 1 ? 1 : ntiles < cap ? ntiles : cap;
  agg_runs_kernel<<<unsigned(grid), kAggThreads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
