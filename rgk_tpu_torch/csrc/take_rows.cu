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
// The forward copies 4-byte words, so one entry point serves float32 and
// int32 tables and its rows are the table's bit for bit.
//
// What bounds it on this card: bytes.  The forward moves R*4 + R*K*4 +
// M*K*4 bytes, the backward R*K*4 + R*4 plus its per-block partials, a few
// flops a word.  (PyTorch's own backward of `table[idx]`,
// index_put_(accumulate=True), sorts the lanes by row and adds each row's
// run serially: 1M lanes on a table of a handful of rows leave a few
// threads a million additions each.)
//
// Design:
// * forward: a grid-strided loop over tiles of kFwdRows rows; a thread
//   writes consecutive words of the output, so the stores coalesce; the
//   table is staged in shared memory when it fits in the 48 KB a block
//   has without opting in (read through the read-only cache otherwise).
// * backward, stage 1: the lanes are cut into tiles of kTile lanes, and
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
// * backward, stage 2: grad[e] = the partials' sum over b, in a fixed
//   order: each of a block's warps sums an interleaved share of b serially
//   for 32 consecutive entries, and one warp adds the shares in warp order.
// No float atomics anywhere, so two runs agree bit for bit.
// Limits (the backward raises beyond them, from the wrapper): M <= 1024 and
// (M*K + kTile*(K|1) + 2*kTile) * 4 bytes of shared memory within the card's
// opt-in ceiling (227 KB on an H100: K <= 45 at M = 1024).
//
// Plain CUDA rather than Triton: the warp match and per-lane shuffle
// sources of the grouped reduction have no Triton counterpart.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxRows = 1024;       // MATMUL_GATHER_MAX_ROWS
constexpr int kFwdThreads = 256;
constexpr int kFwdRows = 128;        // rows per tile of the forward
constexpr int kFwdMaxBlocks = 2048;
constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr int kBwdThreads = 256;     // 8 warps
constexpr int kWarps = kBwdThreads / 32;
constexpr int kTile = 256;           // lanes staged per tile of the backward
constexpr int kBatch = 8;            // loads a thread keeps in flight
constexpr int kMaxPartials = 528;    // stage 1 blocks at most
constexpr int kSumThreads = 256;     // stage 2: 8 warps a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

std::atomic<int> g_optin_set[kMaxDevices];

template <bool kStaged>
__global__ void __launch_bounds__(kFwdThreads)
gather_rows(const uint32_t* __restrict__ table, int m, int k,
            const int* __restrict__ idx, int r, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t s_table[];
  if (kStaged) {
    for (int i = threadIdx.x; i < m * k; i += blockDim.x)
      s_table[i] = table[i];
    __syncthreads();
  }
  const int tiles = (r + kFwdRows - 1) / kFwdRows;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int base = t * kFwdRows;
    const int rows = min(kFwdRows, r - base);
    const unsigned words = static_cast<unsigned>(rows * k);
    uint32_t* dst = out + static_cast<size_t>(base) * k;
#pragma unroll 4
    for (unsigned j = threadIdx.x; j < words; j += blockDim.x) {
      const unsigned lr = j / static_cast<unsigned>(k);
      const int c = static_cast<int>(j - lr * static_cast<unsigned>(k));
      const int row = __ldg(idx + base + lr);
      uint32_t v = 0u;
      if (row >= 0 && row < m)
        v = kStaged ? s_table[row * k + c] : __ldg(table + row * k + c);
      dst[j] = v;
    }
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
// b = w, w + 8, ... serially, then warp 0 adds the 8 shares in order.
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

}  // namespace

// Launches the row fetch on `stream`; returns cudaGetLastError() as an int
// (0 = launched).  Device pointers to contiguous arrays: table [m, k] of
// 4-byte words, idx [r] i32, out [r, k].
extern "C" int rgk_take_rows(const void* table, int m, int k, const int* idx,
                             int r, void* out, void* stream) {
  if (r <= 0 || k <= 0) return 0;
  if (m <= 0 || m > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (r + kFwdRows - 1) / kFwdRows;
  const dim3 grid(tiles < kFwdMaxBlocks ? tiles : kFwdMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  uint32_t* o = static_cast<uint32_t*>(out);
  const size_t bytes = static_cast<size_t>(m) * k * 4;
  if (bytes <= kDefaultSmemBytes)
    gather_rows<true><<<grid, kFwdThreads, bytes, s>>>(t, m, k, idx, r, o);
  else
    gather_rows<false><<<grid, kFwdThreads, 0, s>>>(t, m, k, idx, r, o);
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
  const int n = partial_count(r, &tpb);
  scatter_partials<<<n, kBwdThreads, bytes, s>>>(g, idx, r, m, k, tpb,
                                                  partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mk = m * k;
  sum_partials<<<(mk + 31) / 32, kSumThreads, 0, s>>>(partials, n, mk, out);
  return static_cast<int>(cudaGetLastError());
}
