// PAD and PACK for Hopper (sm_90a): the port of tpq/kernels/move.py.
// One launch per call each, no cudaMemsetAsync, every output byte
// written once.
//
// PAD (pad_kernel) replaces move._pad_kernel (wrapper move.pad,
// tpq/kernels/move.py:117). Bound by device-memory bytes: dest of the
// live prefix read once, each landing row of each column read once, each
// output slot of each column and of occ written once. Like the TPU
// kernel, it is driven by output tiles: block b owns the slots
// [b*T, b*T + T) and
//   1. finds where its source rows start with one warp: a 33-way search
//      over the live prefix (n_live read on the device), which narrows
//      only on rows that land in [0, out_len). Those are strictly
//      increasing; a live row that overflows carries a sentinel >=
//      out_len anywhere in the prefix (lane_table's build and probe
//      layout put it there), so a probe on it decides nothing. The
//      start never passes the last landing row below the tile;
//   2. reads dest forward from there, 2,048 rows a round, and stages in
//      shared memory the source row of each of its slots (-1 for none)
//      until it has passed a landing row at or past the tile's end, or
//      the live prefix ends: runs of sentinels cannot cut its window;
//   3. writes every slot of the tile once, 16-byte stores, one column
//      per pass typed for 4 or 8 bytes, then occ.
// The first version zeroed the outputs with a memset per column and one
// for occ, then scattered one thread per source row: ncols + 2 device
// operations a call, every output byte written twice, and an
// element-size branch per column of every row.
//
// PACK (pack_kernel) replaces move._pack_kernel (wrapper move.pack,
// tpq/kernels/move.py:242). Bound by bytes: occ read once, the live rows
// of each column read once, every output slot written once (live rows
// in front, zeros from `total` on, as tpq zeroes them at :280-284), and
// `total`. The TPU kernel is one sequential grid carrying a row cursor;
// here that cursor is a single-pass scan with decoupled look-back
// (Merrill & Garland, 2016):
//   - a persistent grid (at most what fits on the card at once) takes
//     4,096-row tiles in order through an atomic ticket, never by
//     blockIdx, so a tile's predecessors are always held by running
//     blocks and waiting on them cannot deadlock;
//   - a thread reads its 16 occ values of a tile as four int4 loads and
//     keeps them as bits; rows are ranked within a warp by ballot and
//     popc and across the 32 (round, warp) groups of the tile by one
//     warp scan;
//   - warp 0 publishes the tile's count, then looks back over its
//     predecessors 32 at a time, adding counts until it meets an
//     inclusive prefix, and publishes its own (look_back in
//     common.cuh; a status is one 64-bit word, launch epoch << 32 |
//     inclusive flag << 31 | count);
//   - each column of the tile is read in 16-byte loads (a sector holds
//     four rows, so a dead neighbour costs no extra DRAM traffic),
//     compacted in shared memory and stored coalesced at the tile's
//     scanned offset; once the last tile's inclusive prefix is out,
//     every block zeroes its share of [total, N); the last tile writes
//     `total`.
// Output order comes from the scan alone: two calls give the same bytes.
// The status words need no reset: each launch takes a new epoch from
// the state buffer the wrapper keeps per device and stream (its layout
// in common.cuh), and the block that draws the launch's last ticket
// rearms the ticket counter and stores the epoch, so a CUDA graph that
// replays the launch takes a new epoch each time. The first version
// made ncols + 1 memsets and three dependent launches (count,
// one-block scan, scatter), read occ twice, made 16 block scans a tile
// and wrote each output twice.
//
// Every entry point returns cudaGetLastError() (0 on success).

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// PAD
// ---------------------------------------------------------------------------

constexpr int kPadThreads = 256;
constexpr int kPadTile = 4096;  // output slots per block
constexpr int kPadRounds = 8;   // dest rows a thread reads per round
constexpr int kPadScan = kPadThreads * kPadRounds;

// Warp 0 of a PAD block: the first source row to read for the tile at
// s0. Rows that land (0 <= dest < out_len) are strictly increasing; the
// result is at most one past the last landing row with dest < s0, and
// every landing row of the tile lies at or after it.
__device__ int64_t pad_find_start(const int32_t* __restrict__ dest, int64_t live,
                                  int64_t out_len, int64_t s0) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = live;
  while (hi - lo > kPadScan) {
    const int64_t p = lo + (hi - lo) * (lane + 1) / 33;
    const int64_t d = dest[p];
    const bool lands = d >= 0 && d < out_len;
    const unsigned below = __ballot_sync(0xffffffffu, lands && d < s0);
    const unsigned above = __ballot_sync(0xffffffffu, lands && d >= s0);
    int64_t nlo = lo, nhi = hi;
    if (below) nlo = __shfl_sync(0xffffffffu, p, 31 - __clz(below)) + 1;
    if (above) nhi = __shfl_sync(0xffffffffu, p, __ffs(above) - 1);
    if (nlo == lo && nhi == hi) break;  // every probe on a non-landing row
    lo = nlo;
    hi = nhi;
  }
  return lo;
}

__device__ __forceinline__ int4 as_vec16(const int32_t (&e)[4]) {
  return make_int4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ longlong2 as_vec16(const int64_t (&e)[2]) {
  return make_longlong2(e[0], e[1]);
}

// Writes slots [s0, s0 + len) of dst, value(idx[j]) at slot s0 + j, in
// 16-byte stores; every value of the thread is loaded before the first
// store. idx holds kPadTile entries, -1 past len.
template <typename T, typename F>
__device__ __forceinline__ void pad_write(T* __restrict__ dst, int64_t s0, int len,
                                          const int32_t* idx, F value) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kIters = kPadTile / (kPadThreads * V);
  T e[kIters][V];
#pragma unroll
  for (int it = 0; it < kIters; it++) {
    const int j = (it * kPadThreads + threadIdx.x) * V;
#pragma unroll
    for (int i = 0; i < V; i++) e[it][i] = value(idx[j + i]);
  }
#pragma unroll
  for (int it = 0; it < kIters; it++) {
    const int j = (it * kPadThreads + threadIdx.x) * V;
    if (j + V <= len) {
      *reinterpret_cast<typename Vec16<T>::type*>(dst + s0 + j) = as_vec16(e[it]);
    } else {
#pragma unroll
      for (int i = 0; i < V; i++)
        if (j + i < len) dst[s0 + j + i] = e[it][i];
    }
  }
}

template <typename T>
__device__ __forceinline__ void pad_column(const void* src, void* dst, int64_t s0,
                                           int len, const int32_t* idx) {
  const T* __restrict__ s = static_cast<const T*>(src);
  pad_write(static_cast<T*>(dst), s0, len, idx,
            [s](int32_t k) { return k >= 0 ? s[k] : T(0); });
}

__global__ void __launch_bounds__(kPadThreads)
    pad_kernel(ColList cols, const int32_t* __restrict__ dest, const void* n_live,
               int n_live_esz, int64_t n, int64_t out_len, int32_t* __restrict__ occ) {
  __shared__ int32_t idx[kPadTile];
  __shared__ int64_t start;
  const int64_t s0 = int64_t(blockIdx.x) * kPadTile;
  if (s0 >= out_len) return;  // out_len == 0: the grid is one empty block
  const int len = int(min(int64_t(kPadTile), out_len - s0));
  const int64_t end = s0 + len;
  int64_t live = n_live_esz == 8 ? *static_cast<const int64_t*>(n_live)
                                 : *static_cast<const int32_t*>(n_live);
  live = max(int64_t(0), min(live, n));

  for (int j = threadIdx.x; j < kPadTile; j += kPadThreads) idx[j] = -1;
  if (threadIdx.x < 32) {
    const int64_t lo = pad_find_start(dest, live, out_len, s0);
    if (threadIdx.x == 0) start = lo;
  }
  __syncthreads();

  for (int64_t k0 = start;; k0 += kPadScan) {
    bool past = false;
#pragma unroll
    for (int r = 0; r < kPadRounds; r++) {
      const int64_t k = k0 + r * kPadThreads + threadIdx.x;
      if (k < live) {
        const int64_t d = dest[k];
        if (d >= 0 && d < out_len) {
          if (d >= end)
            past = true;
          else if (d >= s0)
            idx[d - s0] = int32_t(k);
        }
      }
    }
    if (__syncthreads_or(past || k0 + kPadScan >= live)) break;
  }

  for (int c = 0; c < cols.n; c++) {
    if (cols.esz[c] == 8)
      pad_column<int64_t>(cols.src[c], cols.dst[c], s0, len, idx);
    else
      pad_column<int32_t>(cols.src[c], cols.dst[c], s0, len, idx);
  }
  pad_write(occ, s0, len, idx, [](int32_t k) { return int32_t(k >= 0); });
}

// ---------------------------------------------------------------------------
// PACK
// ---------------------------------------------------------------------------

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackRounds = 4;  // int4 loads of occ per thread per tile
constexpr int kPackRound = kPackThreads * 4;
constexpr int64_t kPackTile = int64_t(kPackRound) * kPackRounds;  // PACK_TILE in move.py
static_assert(kPackRounds * kPackWarps == 32, "one warp scans a tile's groups");

__device__ __forceinline__ void load4(const int32_t* p, int32_t (&v)[4]) {
  const int4 a = *reinterpret_cast<const int4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const int64_t* p, int64_t (&v)[4]) {
  const longlong2 a = reinterpret_cast<const longlong2*>(p)[0];
  const longlong2 b = reinterpret_cast<const longlong2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// Moves the live rows of one column of a tile: the thread's rows of round
// r are base + r * kPackRound + 4 * threadIdx.x + j, live where bit j of
// bits[r] is set, the first at tile position pos[r]. They are read in
// 16-byte loads where the column allows, compacted in shared memory and
// written to [out0, out0 + count) in coalesced stores.
template <typename T>
__device__ __forceinline__ void pack_column(const void* src, void* dst, int64_t base,
                                            int64_t n, const uint32_t* bits,
                                            const int* pos, int64_t out0, int count,
                                            T* stage) {
  const T* __restrict__ s = static_cast<const T*>(src);
  T* __restrict__ d = static_cast<T*>(dst);
  const bool vec = (reinterpret_cast<uintptr_t>(s) & 15) == 0;
#pragma unroll
  for (int r = 0; r < kPackRounds; r++) {
    if (bits[r] == 0) continue;
    const int64_t k = base + r * kPackRound + 4 * threadIdx.x;
    T v[4];
    if (vec && k + 4 <= n) {
      load4(s + k, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; j++) v[j] = (bits[r] >> j) & 1 ? s[k + j] : T(0);
    }
    int p = pos[r];
#pragma unroll
    for (int j = 0; j < 4; j++)
      if ((bits[r] >> j) & 1) stage[p++] = v[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kPackThreads) d[out0 + i] = stage[i];
  __syncthreads();  // the stage is refilled by the next column
}

// The state buffer's layout is in common.cuh: the epoch and ticket word,
// the wrap count, and tile t's status at state[kStateHeader + t].
__global__ void __launch_bounds__(kPackThreads)
    pack_kernel(ColList cols, const int32_t* __restrict__ occ, int64_t n,
                int64_t ntiles, uint64_t* __restrict__ state, int64_t state_words,
                int32_t* __restrict__ total) {
  __shared__ int64_t ticket, out0, live_total;
  __shared__ int32_t group_off[kPackRounds * kPackWarps], tile_count;
  __shared__ uint32_t epoch;
  __shared__ __align__(16) int64_t stage[kPackTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* status = state + kStateHeader;

  for (;;) {
    if (threadIdx.x == 0) {
      const uint64_t t = draw_ticket(state, &epoch);
      // the launch's last ticket: every block has drawn its final one
      if (t == uint64_t(ntiles) + gridDim.x - 1) finish_tickets(state, epoch);
      ticket = int64_t(t);
    }
    __syncthreads();
    const int64_t t = ticket;
    if (t >= ntiles) break;
    const uint64_t tag = uint64_t(epoch) << 32;
    const int64_t base = t * kPackTile;

    int4 v[kPackRounds];
#pragma unroll
    for (int r = 0; r < kPackRounds; r++) {
      const int64_t k = base + r * kPackRound + 4 * threadIdx.x;
      if (k + 4 <= n) {
        v[r] = *reinterpret_cast<const int4*>(occ + k);
      } else {
        v[r].x = k < n ? occ[k] : 0;
        v[r].y = k + 1 < n ? occ[k + 1] : 0;
        v[r].z = k + 2 < n ? occ[k + 2] : 0;
        v[r].w = 0;
      }
    }
    uint32_t bits[kPackRounds];
    int pos[kPackRounds];
    const unsigned below = (1u << lane) - 1;
#pragma unroll
    for (int r = 0; r < kPackRounds; r++) {
      bits[r] = uint32_t(v[r].x != 0) | uint32_t(v[r].y != 0) << 1 |
                uint32_t(v[r].z != 0) << 2 | uint32_t(v[r].w != 0) << 3;
      int rank = 0, count = 0;
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const unsigned m = __ballot_sync(0xffffffffu, (bits[r] >> j) & 1);
        rank += __popc(m & below);
        count += __popc(m);
      }
      pos[r] = rank;
      if (lane == 0) group_off[r * kPackWarps + warp] = count;
    }
    __syncthreads();
    if (warp == 0) {
      const int c = group_off[lane];
      int x = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      group_off[lane] = x - c;
      const uint32_t agg = uint32_t(__shfl_sync(0xffffffffu, x, 31));
      const int64_t prefix = look_back(status, t, agg, tag);
      if (lane == 0) {
        out0 = prefix;
        tile_count = int(agg);
        if (t == ntiles - 1) *total = int32_t(prefix + agg);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPackRounds; r++) pos[r] += group_off[r * kPackWarps + warp];
    for (int c = 0; c < cols.n; c++) {
      if (cols.esz[c] == 8)
        pack_column<int64_t>(cols.src[c], cols.dst[c], base, n, bits, pos, out0,
                             tile_count, stage);
      else
        pack_column<int32_t>(cols.src[c], cols.dst[c], base, n, bits, pos, out0,
                             tile_count, reinterpret_cast<int32_t*>(stage));
    }
    // ticket, out0, tile_count and group_off are rewritten next tile (the
    // last column's pass ends in a barrier)
  }

  // every tile is taken; zeros from the total on, once the last tile's
  // inclusive prefix is out (its holder is running: no deadlock)
  if (threadIdx.x == 0) {
    const uint64_t tag = uint64_t(epoch) << 32;
    int64_t tot = 0;
    if (ntiles > 0) {
      uint64_t w;
      while (((w = ld_acquire(&status[ntiles - 1])) & (kTagMask | kInclusive)) !=
             (tag | kInclusive))
        __nanosleep(64);
      tot = int64_t(w & kCountMask);
    } else {
      *total = 0;  // n == 0: one block
    }
    live_total = tot;
    finish_block(state, state_words, epoch);
  }
  __syncthreads();
  for (int c = 0; c < cols.n; c++) {
    if (cols.esz[c] == 8)
      zero_range<int64_t>(cols.dst[c], live_total, n);
    else
      zero_range<int32_t>(cols.dst[c], live_total, n);
  }
}

// Blocks of pack_kernel that fit on the current card at once.
int pack_grid_cap() {
  static int cap[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cap[dev] > 0) return cap[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_kernel, kPackThreads, 0);
  const int c = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < 64) cap[dev] = c;
  return c;
}

}  // namespace

extern "C" {

// n_live: one int32 or int64 value (n_live_esz bytes) on the device.
int tpq_pad(const void* const* src, void* const* dst, const int* esz, int ncols,
            const int32_t* dest, const void* n_live, int n_live_esz, int64_t n,
            int64_t out_len, int32_t* occ, cudaStream_t stream) {
  const ColList cols = make_cols(src, dst, esz, ncols);
  const int64_t blocks = out_len > 0 ? (out_len + kPadTile - 1) / kPadTile : 1;
  pad_kernel<<<unsigned(blocks), kPadThreads, 0, stream>>>(
      cols, dest, n_live, n_live_esz, n, out_len, occ);
  return int(cudaGetLastError());
}

// state: state_words >= ceil(n / kPackTile) + kStateHeader words, zero
// before the first call on the stream and left for the next one (layout
// in common.cuh). occ must be 16-byte aligned.
int tpq_pack(const void* const* src, void* const* dst, const int* esz, int ncols,
             const int32_t* occ, int64_t n, uint64_t* state, int64_t state_words,
             int32_t* total, cudaStream_t stream) {
  const ColList cols = make_cols(src, dst, esz, ncols);
  const int64_t ntiles = (n + kPackTile - 1) / kPackTile;
  if (ntiles + kStateHeader > state_words) return int(cudaErrorInvalidValue);
  const int64_t cap = pack_grid_cap();
  const int64_t grid = ntiles < 1 ? 1 : ntiles < cap ? ntiles : cap;
  pack_kernel<<<unsigned(grid), kPackThreads, 0, stream>>>(cols, occ, n, ntiles, state,
                                                           state_words, total);
  return int(cudaGetLastError());
}

const char* tpq_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

}  // extern "C"
