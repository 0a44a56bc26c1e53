// Row fetch from a small table and its deterministic backward, for Hopper
// (sm_90a): K5.
//
// Replaces rgk_tpu/ops/vecmath.py:take_rows on its small-table route
// (at most MATMUL_GATHER_MAX_ROWS = 1024 rows), where the reference fetches
// rows as a one-hot contraction and so differentiates the table through the
// contraction's transpose, onehot^T . g.  Not a Pallas kernel there; on the
// card it is a pair:
//   forward   out[r, :] = table[idx[r], :]     (a zero row where idx[r] is
//                                              outside [0, m), as the
//                                              one-hot product gives)
//   backward  grad[j, :] = sum over r with idx[r] = j of g[r, :]
// The forward copies 4-byte words (16-byte units of them where it can), so
// one entry point serves float32 and int32 tables and its rows are the
// table's bit for bit.
//
// What bounds it on this card: bytes.  The forward moves R*4 + R*K*4 +
// M*K*4 bytes, the backward R*K*4 + R*4 plus its per-block partials, a few
// flops a word.  (PyTorch's own backward of `table[idx]`,
// index_put_(accumulate=True), sorts the lanes by row and adds each row's
// run serially: 1M lanes on a table of a handful of rows leave a few
// threads a million additions each.)
//
// Design (the shapes the gradient step fetches decide it: 1,048,576 ids
// into tables of 1-5 rows and 8-24 columns):
// * forward: a warp fetches 32 lanes a tile.  Lane l loads id base + l
//   (one coalesced load, the next tile's loaded before this one is
//   copied), and the warp writes the tile's 32 output rows, which lie
//   back to back, in units of 16 bytes where K % 4 == 0 and both
//   pointers are 16-byte aligned (else of 4 bytes); unit u of the tile
//   belongs to row u / (units a row), whose id comes by shuffle.  The
//   widths the renderer passes (4, 8, 15, 20, 24: triangle meta, point
//   pack, areal rows, material pack, shading rows) are compile-time
//   constants, so that division is a multiply; other widths read K at
//   run time.  A table of at most kFwdStageBytes is staged in shared
//   memory, a larger one read through the read-only cache.  The grid is
//   sized from the card's SM count (kFwdBlocksPerSm blocks an SM at most)
//   and strides over the tiles.
// * backward, small tables (M <= kSmallRows, every table the gradient
//   step fetches): the R*K words of g are read as one flat stream in
//   units of 16 bytes (g 16-byte aligned; else 4 bytes).  Thread gt of
//   the grid's N threads takes units gt, gt + N, ..., kUnroll loads in
//   flight; the grid is sized so that N * (unit words) is a multiple of
//   K, so a thread's slots always hold the same columns and each slot's
//   lane advances by a constant a unit (no division in the loop).  A
//   thread keeps M x (unit words) register sums and adds each word into
//   its row's sum with predicated adds (no dynamic register index), in
//   unit order.  The block's sums go to shared memory, and the block's
//   partial entry (m, c) is summed over the threads and slots that hold
//   column c in a fixed order (four interleaved chains, then in order);
//   the grid's last words, fewer than a unit, are added by block 0.  A
//   call with too few lanes for the grid that K's column period needs
//   (fewer than K x 256) takes the grouped route instead.
// * backward, larger tables, stage 1 (the grouped route): the lanes
//   are cut into tiles of kTile lanes, and
//   block b takes tiles [b*tpb, (b+1)*tpb), a partition that depends on R
//   alone, never on the card or the scheduler.  A tile of g is staged in
//   shared memory (row stride padded to an odd word count against bank
//   conflicts), each thread keeping kBatch loads in flight.  For 32 lanes
//   at a time, __match_any_sync groups the lanes that share a row, and
//   each group's sum is a binary tree over its members' ranks (rank =
//   members below it in lane order), the tree fixed by the ids alone;
//   the grouping is computed once a tile and kept in shared memory.  Warp
//   w owns the columns c = w (mod warps) of the block's [M, K]
//   accumulator in shared memory and is its only writer: for each 32
//   lanes it sums each column by the tree (five shuffles) and the group's
//   lowest lane adds the sum into the accumulator.  Then the block
//   writes its accumulator as partial b.
// * backward, stage 2 (both routes): grad[e] = the partials' sum over b,
//   in a fixed order: each of a block's warps sums an interleaved share
//   of b serially for 32 consecutive entries, and one warp adds the
//   shares in warp order.
// Every partition depends on R, M, K and g's 16-byte alignment alone, never
// on the card or the scheduler, and no float atomics are used, so two runs
// agree bit for bit.
// Limits (the backward raises beyond them, from the wrapper): M <= 1024 and
// (M*K + kTile*(K|1) + 2*kTile) * 4 bytes of shared memory within the card's
// opt-in ceiling (227 KB on an H100: K <= 45 at M = 1024).
//
// Plain CUDA rather than Triton: the warp match and per-lane shuffle
// sources of the grouped reduction have no Triton counterpart.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxRows = 1024;       // MATMUL_GATHER_MAX_ROWS
constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// Forward.
constexpr int kFwdThreads = 256;     // 8 warps, a tile of 32 lanes each
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdBlocksPerSm = 8;
constexpr int kFwdStageBytes = 4096;
// Backward, grouped route.
constexpr int kBwdThreads = 256;     // 8 warps
constexpr int kWarps = kBwdThreads / 32;
constexpr int kTile = 256;           // lanes staged per tile of the backward
constexpr int kBatch = 8;            // loads a thread keeps in flight
constexpr int kMaxPartials = 528;    // stage 1 blocks at most
constexpr int kSumThreads = 1024;    // stage 2: 32 warps a block
// Backward, small tables.
constexpr int kSmallRows = 8;
constexpr int kSmallThreads = 256;

std::atomic<int> g_optin_set[kMaxDevices];
std::atomic<int> g_sm_count[kMaxDevices];

template <int kK, int kV, bool kStaged>
__global__ void __launch_bounds__(kFwdThreads)
gather_rows(const uint32_t* __restrict__ table, int m, int k_rt,
            const int* __restrict__ idx, int r, uint32_t* __restrict__ out) {
  using Unit = typename std::conditional<kV == 4, uint4, uint32_t>::type;
  extern __shared__ __align__(16) uint32_t s_table[];
  const int k = kK > 0 ? kK : k_rt;
  if (kStaged) {
    for (int i = threadIdx.x; i < m * k; i += kFwdThreads)
      s_table[i] = table[i];
    __syncthreads();
  }
  const Unit* src = reinterpret_cast<const Unit*>(kStaged ? s_table : table);
  Unit* dst = reinterpret_cast<Unit*>(out);
  const int upr = k / kV;                       // units a row
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kFwdWarps;
  const int tiles = (r + 31) / 32;
  int t = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  int id = t < tiles && t * 32 + lane < r ? __ldg(idx + t * 32 + lane) : -1;
  for (; t < tiles; t += stride) {              // uniform over the warp
    const int nt = t + stride;
    const int id_next =
        nt < tiles && nt * 32 + lane < r ? __ldg(idx + nt * 32 + lane) : -1;
    const int units = min(32, r - t * 32) * upr;
    Unit* tile = dst + static_cast<size_t>(t) * 32 * upr;
#pragma unroll 4
    for (int u0 = 0; u0 < units; u0 += 32) {    // every lane, every step
      const int u = u0 + lane;
      const int row = u / upr;
      const int rid = __shfl_sync(kFull, id, row & 31);
      if (u < units) {
        Unit v;
        if (rid >= 0 && rid < m) {
          const int at = rid * upr + (u - row * upr);
          if constexpr (kStaged)
            v = src[at];
          else
            v = __ldg(src + at);
        } else {
          v = Unit{};
        }
        tile[u] = v;
      }
    }
    id = id_next;
  }
}

__device__ __forceinline__ float word(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float word(float v, int) { return v; }

// Small tables: kM rows, units of kV words, kUnroll units in flight.
template <int kM, int kV>
__global__ void __launch_bounds__(kSmallThreads, 4)
scatter_small(const float* __restrict__ g, const int* __restrict__ idx,
              int r, int k, long long units, float* __restrict__ partials) {
  constexpr int kUnroll = kM <= 5 ? 4 : 2;
  using Unit = typename std::conditional<kV == 4, float4, float>::type;
  extern __shared__ float s_sum[];              // [kM * kV][kSmallThreads]
  const int tid = threadIdx.x;
  const long long n = static_cast<long long>(gridDim.x) * kSmallThreads;
  const long long gt = static_cast<long long>(blockIdx.x) * kSmallThreads
                       + tid;
  const long long w0 = gt * kV;
  const int col0 = static_cast<int>(w0 % k);
  const long long lane_step = n * kV / k;       // exact: n * kV % k == 0
  // Slot j's lane is the unit's first lane plus dl[j]; with k >= kV a
  // unit spans at most two lanes, so two id loads serve its slots.
  int dl[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) dl[j] = (col0 + j) / k;
  const bool two = k >= kV;
  const bool straddles = dl[kV - 1] > 0;
  float acc[kM][kV];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kV; ++j) acc[i][j] = 0.f;
  const Unit* src = reinterpret_cast<const Unit*>(g);
  long long lane = w0 / k;
  for (long long u = gt; u < units; u += n * kUnroll) {
    Unit v[kUnroll];
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const long long us = u + s * n;
      v[s] = us < units ? src[us] : Unit{};
    }
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      if (u + s * n < units) {
        const long long ls = lane + s * lane_step;
        const int id0 = __ldg(idx + ls);
        const int id1 = two && straddles ? __ldg(idx + ls + 1) : id0;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const int row = two ? (dl[j] ? id1 : id0) : __ldg(idx + ls + dl[j]);
#pragma unroll
          for (int i = 0; i < kM; ++i)
            acc[i][j] += row == i ? word(v[s], j) : 0.f;
        }
      }
    }
    lane += kUnroll * lane_step;
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kV; ++j)
      s_sum[(i * kV + j) * kSmallThreads + tid] = acc[i][j];
  __syncthreads();
  // Thread t's slot j holds column (kV * (b*T + t) + j) % k.  For column c
  // and slot j, with d = (c - j) mod k and q = gcd(kV, k), k' = k / q: the
  // threads are those with (kV/q) * (b*T + t) = d/q (mod k'), none unless q
  // divides d: t = t0, t0 + k', ... with t0 = (d/q) * inv(kV/q) - b*T
  // (mod k').
  const int q = (kV == 4 && k % 4 == 0) ? 4 : (kV == 4 && k % 2 == 0) ? 2 : 1;
  const int kq = k / q;
  const int a = kV / q;
  int inv = 0;
  for (int x = 0; x < kq; ++x)
    if ((a * x) % kq == 1 % kq) { inv = x; break; }
  const long long bt = static_cast<long long>(blockIdx.x) * kSmallThreads;
  const long long tail0 = units * kV, words = static_cast<long long>(r) * k;
  float* dst = partials + static_cast<size_t>(blockIdx.x) * kM * k;
  for (int e = tid; e < kM * k; e += kSmallThreads) {
    const int i = e / k, c = e - i * k;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int d = ((c - j) % k + k) % k;
      if (d % q != 0) continue;
      const long long t0l =
          ((static_cast<long long>(d / q) * inv - bt) % kq + kq) % kq;
      const float* col = s_sum + (i * kV + j) * kSmallThreads;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      int t = static_cast<int>(t0l);
      for (; t + 3 * kq < kSmallThreads; t += 4 * kq) {
        part[0] += col[t];
        part[1] += col[t + kq];
        part[2] += col[t + 2 * kq];
        part[3] += col[t + 3 * kq];
      }
      // At most three left, one to each chain (no dynamic register index).
      if (t < kSmallThreads) part[0] += col[t];
      if (t + kq < kSmallThreads) part[1] += col[t + kq];
      if (t + 2 * kq < kSmallThreads) part[2] += col[t + 2 * kq];
      sum += (part[0] + part[1]) + (part[2] + part[3]);
    }
    if (blockIdx.x == 0)
      for (long long w = tail0; w < words; ++w)
        if (w % k == c && __ldg(idx + w / k) == i) sum += g[w];
    dst[e] = sum;
  }
}

// Position of the (n+1)-th set bit of `mask`, n < popc(mask).
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int low = __popc(mask & ((1u << w) - 1u));
    if (n >= low) {
      n -= low;
      mask >>= w;
      pos += w;
    }
  }
  return pos;
}

__global__ void __launch_bounds__(kBwdThreads)
scatter_partials(const float* __restrict__ g, const int* __restrict__ idx,
                 int r, int m, int k, int tiles_per_block,
                 float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int kp = k | 1;                         // odd row stride
  float* s_acc = smem;                          // [m * k]
  float* s_g = s_acc + m * k;                   // [kTile * kp]
  int* s_idx = reinterpret_cast<int*>(s_g + kTile * kp);       // [kTile]
  unsigned* s_info = reinterpret_cast<unsigned*>(s_idx + kTile);  // [kTile]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < m * k; i += kBwdThreads) s_acc[i] = 0.f;
  const unsigned below = (1u << lane) - 1u;
  // A thread stages the words tid, tid + kBwdThreads, ... of a tile; their
  // (lane, column) advance by (kBwdThreads / k, kBwdThreads % k), so the
  // thread divides once.
  const unsigned uk = static_cast<unsigned>(k);
  const unsigned step_rows = kBwdThreads / uk, step_cols = kBwdThreads % uk;
  const unsigned row0 = tid / uk, col0 = tid % uk;
  const long long first =
      static_cast<long long>(blockIdx.x) * tiles_per_block * kTile;
  for (int t = 0; t < tiles_per_block; ++t) {
    const long long base = first + static_cast<long long>(t) * kTile;
    if (base >= r) break;                       // uniform over the block
    const int rows = static_cast<int>(min(static_cast<long long>(kTile),
                                          r - base));
    __syncthreads();                            // the last tile is consumed
    const float* src = g + base * k;
    const unsigned words = static_cast<unsigned>(rows * k);
    // kBatch loads issued before their stores, so that a thread waits on
    // memory once a batch rather than once a word.
    unsigned lr = row0, c = col0;
    for (unsigned j0 = tid; j0 < words; j0 += kBwdThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned j = j0 + u * kBwdThreads;
        v[u] = j < words ? src[j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u * kBwdThreads < words) s_g[lr * kp + c] = v[u];
        c += step_cols;
        lr += step_rows;
        if (c >= uk) {
          c -= uk;
          ++lr;
        }
      }
    }
    for (int j = tid; j < rows; j += kBwdThreads) s_idx[j] = idx[base + j];
    __syncthreads();
    // The grouping of each 32 lanes, once a tile (warp w takes the lanes
    // from 32 w on, kWarps * 32 apart): the tree's partner lane at each
    // level d = 2^l, fixed by the ids alone (a member of rank % 2d == 0
    // adds the partial of rank + d), packed as 5 bits a level (bits
    // 0-24), whether it adds (bits 25-29), and whether the lane is its
    // group's lowest in range (bit 30), which adds the group's sum.
    for (int s = warp * 32; s < rows; s += kWarps * 32) {
      const int l0 = s + lane;
      const int row = l0 < rows ? s_idx[l0] : -1;
      const bool ok = row >= 0 && row < m;
      const unsigned peers = __match_any_sync(kFull, ok ? row : -1);
      const int rank = __popc(peers & below);
      const int size = __popc(peers);
      unsigned info = (ok && rank == 0) ? 1u << 30 : 0u;
#pragma unroll
      for (int l = 0; l < 5; ++l) {
        const int d = 1 << l;
        const bool take = (rank & (2 * d - 1)) == 0 && rank + d < size;
        const int src_lane = take ? nth_set_bit(peers, rank + d) : lane;
        info |= static_cast<unsigned>(src_lane) << (5 * l);
        if (take) info |= 1u << (25 + l);
      }
      s_info[l0] = info;
    }
    __syncthreads();
    if (warp >= k) continue;                    // owns no column
    for (int s = 0; s < rows; s += 32) {
      const int l0 = s + lane;
      const unsigned info = s_info[l0];
      const bool leader = (info >> 30) & 1u;
      const int row = leader ? s_idx[l0] : 0;
      for (int col = warp; col < k; col += kWarps) {
        float v = l0 < rows ? s_g[l0 * kp + col] : 0.f;
#pragma unroll
        for (int l = 0; l < 5; ++l) {
          const float o = __shfl_sync(kFull, v, (info >> (5 * l)) & 31u);
          if ((info >> (25 + l)) & 1u) v += o;
        }
        if (leader) s_acc[row * k + col] += v;
        __syncwarp();
      }
    }
  }
  __syncthreads();
  float* dst = partials + static_cast<size_t>(blockIdx.x) * m * k;
  for (int i = tid; i < m * k; i += kBwdThreads) dst[i] = s_acc[i];
}

// Block of stage 2: 32 consecutive entries e; warp w sums partials
// b = w, w + 32, ... serially, then warp 0 adds the 32 shares in order
// (32 warps, so that each chain of dependent adds is ~16 long at the
// 512 partials of 1M lanes).
__global__ void __launch_bounds__(kSumThreads)
sum_partials(const float* __restrict__ partials, int n_partials, int mk,
             float* __restrict__ out) {
  __shared__ float s_share[kSumThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (e < mk)
#pragma unroll 8
    for (int b = warp; b < n_partials; b += kSumThreads / 32)
      v += partials[static_cast<size_t>(b) * mk + e];
  s_share[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && e < mk) {
    float sum = s_share[0][lane];
    for (int w = 1; w < kSumThreads / 32; ++w) sum += s_share[w][lane];
    out[e] = sum;
  }
}

int partial_count(int r, int* tiles_per_block) {
  const int tiles = (r + kTile - 1) / kTile;
  const int tpb = (tiles + kMaxPartials - 1) / kMaxPartials;
  *tiles_per_block = tpb;
  return (tiles + tpb - 1) / tpb;
}

size_t backward_smem(int m, int k) {
  return (static_cast<size_t>(m) * k + static_cast<size_t>(kTile) * (k | 1)
          + 2 * kTile) * 4;
}

// Opts the stage 1 kernel in to the device's whole shared memory, once per
// device (racing first launches set the same value).
cudaError_t opt_in() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_optin_set[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  int bytes = 0;
  err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scatter_partials,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess) g_optin_set[dev].store(1, std::memory_order_relaxed);
  return err;
}

// The current device's SM count, read once per device.
cudaError_t sm_count(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = g_sm_count[dev].load(std::memory_order_relaxed);
  if (n <= 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sm_count[dev].store(n, std::memory_order_relaxed);
  }
  *out = n;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The forward for a width fixed at compile time (kK > 0) or read at run
// time (kK == 0): 16-byte units where `vec`, else words.
template <int kK>
void launch_gather(bool vec, bool staged, int blocks, size_t smem,
                   cudaStream_t s, const uint32_t* t, int m, int k,
                   const int* idx, int r, uint32_t* o) {
  if constexpr (kK % 4 == 0) {
    if (vec) {
      if (staged)
        gather_rows<kK, 4, true><<<blocks, kFwdThreads, smem, s>>>(
            t, m, k, idx, r, o);
      else
        gather_rows<kK, 4, false><<<blocks, kFwdThreads, 0, s>>>(
            t, m, k, idx, r, o);
      return;
    }
  }
  if (staged)
    gather_rows<kK, 1, true><<<blocks, kFwdThreads, smem, s>>>(t, m, k, idx,
                                                                r, o);
  else
    gather_rows<kK, 1, false><<<blocks, kFwdThreads, 0, s>>>(t, m, k, idx,
                                                              r, o);
}

template <int kM>
void launch_small(bool vec, int blocks, cudaStream_t s, const float* g,
                  const int* idx, int r, int k, long long units,
                  float* partials) {
  if (vec)
    scatter_small<kM, 4><<<blocks, kSmallThreads,
                           kM * 4 * kSmallThreads * sizeof(float), s>>>(
        g, idx, r, k, units, partials);
  else
    scatter_small<kM, 1><<<blocks, kSmallThreads,
                           kM * kSmallThreads * sizeof(float), s>>>(
        g, idx, r, k, units, partials);
}

// The small-table route's stage 1 on at most `n_alloc` blocks; returns
// the blocks launched, 0 when the route cannot take the call (fewer
// blocks than the column period allows: a handful of lanes).
int small_route(const float* g, const int* idx, int r, int m, int k,
                int n_alloc, float* partials, cudaStream_t s) {
  if (m > kSmallRows) return 0;
  const bool vec = aligned16(g);
  const int v = vec ? 4 : 1;
  const long long units = static_cast<long long>(r) * k / v;
  // N = blocks * kSmallThreads threads; N * v must be a multiple of k.
  const int qb = k / gcd(k, v * kSmallThreads);
  const int cap = n_alloc / qb * qb;
  if (cap == 0) return 0;
  long long want = (units + kSmallThreads - 1) / kSmallThreads;
  want = want < qb ? qb : (want + qb - 1) / qb * qb;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  switch (m) {
    case 1: launch_small<1>(vec, blocks, s, g, idx, r, k, units, partials);
            break;
    case 2: launch_small<2>(vec, blocks, s, g, idx, r, k, units, partials);
            break;
    case 3: launch_small<3>(vec, blocks, s, g, idx, r, k, units, partials);
            break;
    case 4: launch_small<4>(vec, blocks, s, g, idx, r, k, units, partials);
            break;
    case 5: launch_small<5>(vec, blocks, s, g, idx, r, k, units, partials);
            break;
    case 6: launch_small<6>(vec, blocks, s, g, idx, r, k, units, partials);
            break;
    case 7: launch_small<7>(vec, blocks, s, g, idx, r, k, units, partials);
            break;
    default: launch_small<8>(vec, blocks, s, g, idx, r, k, units, partials);
  }
  return blocks;
}

}  // namespace

// Launches the row fetch on `stream`; returns cudaGetLastError() as an int
// (0 = launched).  Device pointers to contiguous arrays: table [m, k] of
// 4-byte words, idx [r] i32, out [r, k].
extern "C" int rgk_take_rows(const void* table, int m, int k, const int* idx,
                             int r, void* out, void* stream) {
  if (r <= 0 || k <= 0) return 0;
  if (m <= 0 || m > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (r + 31) / 32;
  const int want = (tiles + kFwdWarps - 1) / kFwdWarps;
  const int blocks = want < sms * kFwdBlocksPerSm ? want
                                                  : sms * kFwdBlocksPerSm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  uint32_t* o = static_cast<uint32_t*>(out);
  const size_t bytes = static_cast<size_t>(m) * k * 4;
  const bool staged = bytes <= kFwdStageBytes;
  const bool vec = k % 4 == 0 && aligned16(out) && (staged || aligned16(table));
  switch (k) {
    case 4: launch_gather<4>(vec, staged, blocks, bytes, s, t, m, k, idx, r,
                             o); break;
    case 8: launch_gather<8>(vec, staged, blocks, bytes, s, t, m, k, idx, r,
                             o); break;
    case 15: launch_gather<15>(vec, staged, blocks, bytes, s, t, m, k, idx,
                               r, o); break;
    case 20: launch_gather<20>(vec, staged, blocks, bytes, s, t, m, k, idx,
                               r, o); break;
    case 24: launch_gather<24>(vec, staged, blocks, bytes, s, t, m, k, idx,
                               r, o); break;
    default: launch_gather<0>(vec, staged, blocks, bytes, s, t, m, k, idx, r,
                              o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The number of partial tables the backward of `r` lanes writes (the
// wrapper allocates them, [n, m, k] f32).
extern "C" int rgk_take_rows_partials(int r) {
  int tpb = 0;
  return r > 0 ? partial_count(r, &tpb) : 0;
}

// The shared memory in bytes a backward block needs for an [m, k] table.
extern "C" long long rgk_take_rows_backward_smem(int m, int k) {
  return static_cast<long long>(backward_smem(m, k));
}

// Launches the backward's two kernels on `stream`; returns the first CUDA
// error as an int (0 = launched).  g [r, k] f32, idx [r] i32, partials
// [rgk_take_rows_partials(r), m, k] f32 scratch, out [m, k] f32.
extern "C" int rgk_take_rows_backward(const float* g, const int* idx, int r,
                                      int m, int k, float* partials,
                                      float* out, void* stream) {
  if (r <= 0 || k <= 0) return 0;
  if (m <= 0 || m > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = backward_smem(m, k);
  if (bytes > kDefaultSmemBytes) {
    const cudaError_t err = opt_in();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int tpb = 0;
  int n = partial_count(r, &tpb);
  const int small = small_route(g, idx, r, m, k, n, partials, s);
  if (small > 0)
    n = small;
  else
    scatter_partials<<<n, kBwdThreads, bytes, s>>>(g, idx, r, m, k, tpb,
                                                    partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mk = m * k;
  sum_partials<<<(mk + 31) / 32, kSumThreads, 0, s>>>(partials, n, mk, out);
  return static_cast<int>(cudaGetLastError());
}
