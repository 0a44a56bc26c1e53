// Hopper probes P1 and P2: the reference's two kernel probe tools,
// answered for this card (sm_90a).
//
// P1 replaces tools/prof_smem_probe.py (probe_smem, probe_bitcast,
// probe_octant_dma): the largest dynamic shared memory one block can
// launch with; the u16 fixed-point unpack of an i32 word, (x - hi) * lo;
// and a dynamic-offset copy of one row of an i32 [8, n] table into shared
// memory with cp.async (does one octant's link page fit?).
//
// P2 replaces tools/prof_sync.py:main: the per-iteration cost of a loop
// over the [8, 128] values (one block of 1024 threads, one value each)
// whose reduction is consumed that iteration (b), one iteration late (c),
// or not at all (a); with one (d) or eight (e) table reads; a slab test
// and vote (f, and f_warp with a warp vote instead of the block's); a
// slab test whose per-row votes are packed into power-of-two bits (g); f
// inside a nested loop; one Badouel sweep of a [16, 128] tile (read as a
// one-tile cluster pack, with cluster_common.cuh's row test), ungated and
// behind 8 branches; and [16, 128] f32 tile fetches with 1, 2, 4 or 8
// cp.async copies in flight.  The TPU's vector->scalar reduction becomes
// a block vote (__syncthreads_or) or a warp vote (__any_sync).  Every
// variant returns the reference's carry `s` per thread, so its plain
// version (rgk_tpu_torch/tools/prof_sync.py) can check it.
//
// What bounds them: a probe measures one thing; barrier latency for the
// votes, the issue rate of the loop body, and copy latency for the
// fetches.  Nothing here is on a render path.

#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_common.cuh"

namespace {

constexpr int kThreads = 1024;  // the [8, 128] values, one a thread
constexpr int kTable = 128;     // the reference's scalar table
constexpr int kTileFloats = 16 * 128;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- P1

// Thread 0 stores x[0] (as an int) in the last word of the dynamic shared
// memory; every thread adds it to its x.
__global__ void __launch_bounds__(kThreads)
smem_probe(const float* __restrict__ x, float* __restrict__ out, int n) {
  extern __shared__ int words[];
  const int t = threadIdx.x;
  if (t == 0) words[n - 1] = static_cast<int>(x[0]);
  __syncthreads();
  out[t] = x[t] + static_cast<float>(words[n - 1]);
}

__global__ void __launch_bounds__(kThreads)
unpack_probe(const int* __restrict__ w, const float* __restrict__ x,
             float* __restrict__ out) {
  const uint32_t word = static_cast<uint32_t>(w[0]);
  const float hi = static_cast<float>((word >> 16) & 0xFFFFu);
  const float lo = static_cast<float>(word & 0xFFFFu);
  out[threadIdx.x] = (x[threadIdx.x] - hi) * lo;
}

// Row `row` of the [8, n] table into shared memory with 4-byte cp.async
// (a row starts at any word, so 16-byte copies would not be aligned);
// every thread then reads the row's last word.
__global__ void __launch_bounds__(kThreads)
row_copy_probe(const int* __restrict__ table, int n, int row,
               int* __restrict__ out) {
  extern __shared__ int page[];
  const int* src = table + static_cast<long long>(row) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(page + i, src + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  out[threadIdx.x] = page[n - 1];
}

// ---------------------------------------------------------------- P2

enum Variant {
  kA = 0, kB, kC, kD, kE, kF, kFWarp, kG, kNested, kSweep, kSweep8
};

// The block vote: 1 if the predicate holds on any thread of the block, else
// 0 (__syncthreads_or promises only "non-zero").
__device__ __forceinline__ int vote(bool pred) {
  return __syncthreads_or(pred) != 0 ? 1 : 0;
}

// The reference's slab-like body: six table scalars against the value.
__device__ __forceinline__ bool slab_probe(float v, const float* tab,
                                           int n) {
  const float t0x = (tab[n] - v) * v, t1x = (tab[n + 1] - v) * v;
  const float t0y = (tab[n + 2] - v) * v, t1y = (tab[n + 3] - v) * v;
  const float t0z = (tab[n + 4] - v) * v, t1z = (tab[n + 5] - v) * v;
  const float tn =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tf >= tn && tf >= 0.f;
}

// One Badouel sweep of the tile's 128 triangles against this lane's ray
// in (0, *st), keeping the least t.
__device__ __forceinline__ void sweep_tile(const float* tile,
                                           const rgk::Ray& ray, float* st) {
  float best = *st;
  int best_i = -1;
  for (int m = 0; m < 128; ++m) {
    float t;
    int pid;
    if (rgk::row_hit(tile, m, ray, 0.f, *st, -1, &t, &pid))
      rgk::keep_min(t, pid, &best, &best_i);
  }
  *st = best;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
sync_probe(const float* __restrict__ x, const float* __restrict__ table,
           int iters, float thresh, int* __restrict__ s_out,
           float* __restrict__ st_out) {
  __shared__ float tab[kTable];
  __shared__ int bits[3];
  const int t = threadIdx.x, row = t >> 7, lane = t & 127;
  if (V != kSweep && V != kSweep8 && t < kTable) tab[t] = table[t];
  if (t < 3) bits[t] = 0;
  __syncthreads();
  int s = 0;

  if (V == kSweep || V == kSweep8) {
    // x is the [16, 128] tile: lane l's ray is column l of rows 0..5.
    const rgk::Ray ray{x[lane], x[128 + lane], x[256 + lane],
                       x[384 + lane], x[512 + lane], x[640 + lane]};
    float st = 1e30f;
    for (int i = 0; i < iters / 10; ++i) {
      if (V == kSweep) {
        if (row == 0) sweep_tile(x, ray, &st);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (((i + j) & 7) == 0 && row == j) sweep_tile(x, ray, &st);
        }
      }
    }
    st_out[t] = st;
    s_out[t] = s;
    return;
  }

  const float v = x[t];
  if (V == kNested) {
    for (int i = 0; i < iters / 4; ++i) {
      for (int k = i * 4; k % 4 != 3; ++k)
        s += vote(slab_probe(v, tab, k & 63));
    }
    s_out[t] = s;
    return;
  }

  int pending = 0;
  for (int i = 0; i < iters; ++i) {
    if (V == kA) {
      const float w = v + static_cast<float>(i);
      asm volatile("" ::"f"(w));  // the work is done, its result unused
    } else if (V == kB) {
      s += vote(v + static_cast<float>(i) > thresh);
    } else if (V == kC) {
      s += pending;
      pending = vote(v + static_cast<float>(i) > thresh);
    } else if (V == kD) {
      s += vote(v + tab[i & 63] > thresh);
    } else if (V == kE) {
      float w = v;
#pragma unroll
      for (int k = 0; k < 8; ++k) w = w + tab[(i + k) & 63];
      s += vote(w > thresh);
    } else if (V == kF) {
      s += vote(slab_probe(v, tab, i & 63));
    } else if (V == kFWarp) {
      s += __any_sync(0xFFFFFFFFu, slab_probe(v, tab, i & 63)) ? 1 : 0;
    } else if (V == kG) {
      // A row's 128 values are four warps: each warp votes, and its first
      // lane sets the row's bit in a shared word.  Three words in turn,
      // so one barrier an iteration suffices: the word cleared here was
      // read before this barrier and is written after the next.
      const bool any = __any_sync(0xFFFFFFFFu, slab_probe(v, tab, i & 63));
      if ((t & 31) == 0 && any) atomicOr(&bits[i % 3], 1 << row);
      __syncthreads();
      s += bits[i % 3];
      if (t == 0) bits[(i + 2) % 3] = 0;
    }
  }
  s_out[t] = s;
}

// [16, 128] f32 tiles of `hbm` (tile i % n_tiles at iteration i) into a
// ring of D shared-memory slots, D copies in flight: iteration i waits for
// copy i - D, reads its first word, then issues copy i into its slot.
template <int D>
__global__ void __launch_bounds__(kThreads)
fetch_probe(const float* __restrict__ hbm, int n_tiles, int iters,
            float thresh, int* __restrict__ s_out) {
  extern __shared__ float4 ring[];
  constexpr int kVec = kTileFloats / 4;  // 16-byte pieces of a tile
  const int t = threadIdx.x;
  const float4* src = reinterpret_cast<const float4*>(hbm);
  int s = 0;
  for (int i = 0; i < iters; ++i) {
    if (i >= D) {
      cp_async_wait<D - 1>();
      __syncthreads();
      const float w = reinterpret_cast<const float*>(ring)[(i % D) * kTileFloats];
      s += w > thresh;
      __syncthreads();
    }
    if (t < kVec)
      cp_async16(ring + (i % D) * kVec + t,
                 src + static_cast<long long>(i % n_tiles) * kVec + t);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  s_out[t] = s;
}

template <typename Kernel>
int launch_with_smem(Kernel kernel, size_t bytes) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) cudaGetLastError();  // reported after the launch
  return static_cast<int>(attr);
}

}  // namespace

// Every rgk_probe_* entry point launches one block of 1024 threads on
// `stream` and returns a cudaError_t as an int (0 = launched).

// The message of a cudaError_t, for the wrappers' exceptions (all kernels).
extern "C" const char* rgk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// P1: the opt-in ceiling of dynamic shared memory per block on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin) in bytes, or -cudaError.
extern "C" int rgk_device_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// P1: x, out [1024] f32; n_words of dynamic shared memory.  The opt-in is
// requested first; a size the card refuses comes back as the launch's
// error (or the opt-in's), never as a fault.
extern "C" int rgk_probe_smem(const float* x, float* out, int n_words,
                              void* stream) {
  if (n_words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(n_words) * 4;
  const int attr = launch_with_smem(smem_probe, bytes);
  smem_probe<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, out, n_words);
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : attr;
}

// P1: w [1] i32; x, out [1024] f32.
extern "C" int rgk_probe_unpack(const int* w, const float* x, float* out,
                                void* stream) {
  unpack_probe<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(w, x,
                                                                       out);
  return static_cast<int>(cudaGetLastError());
}

// P1: table [8, n] i32; out [1024] i32 = table[row, n - 1].
extern "C" int rgk_probe_row_copy(const int* table, int n, int row, int* out,
                                  void* stream) {
  if (n <= 0 || row < 0 || row >= 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(n) * 4;
  const int attr = launch_with_smem(row_copy_probe, bytes);
  row_copy_probe<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      table, n, row, out);
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : attr;
}

// P2: variant 0..10 = a, b, c, d, e, f, f_warp, g, nested, sweep, sweep8.
// x [1024] f32 (the [16, 128] tile, 2048 f32, for the sweeps); table [128]
// f32 (unused by the sweeps); s_out [1024] i32; st_out [1024] f32 (the
// sweeps' per-lane least t; may be null otherwise).
extern "C" int rgk_probe_sync(int variant, const float* x, const float* table,
                              int iters, float thresh, int* s_out,
                              float* st_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RGK_SYNC_CASE(V)                                               \
  case V:                                                              \
    sync_probe<V><<<1, kThreads, 0, s>>>(x, table, iters, thresh, s_out, \
                                         st_out);                      \
    break;
  switch (variant) {
    RGK_SYNC_CASE(kA)
    RGK_SYNC_CASE(kB)
    RGK_SYNC_CASE(kC)
    RGK_SYNC_CASE(kD)
    RGK_SYNC_CASE(kE)
    RGK_SYNC_CASE(kF)
    RGK_SYNC_CASE(kFWarp)
    RGK_SYNC_CASE(kG)
    RGK_SYNC_CASE(kNested)
    RGK_SYNC_CASE(kSweep)
    RGK_SYNC_CASE(kSweep8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RGK_SYNC_CASE
  return static_cast<int>(cudaGetLastError());
}

// P2: hbm [n_tiles * 16 * 128] f32, 16-byte aligned; depth 1, 2, 4 or 8;
// s_out [1024] i32.
extern "C" int rgk_probe_fetch(const float* hbm, int n_tiles, int depth,
                               int iters, float thresh, int* s_out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(depth) * kTileFloats * 4;
  int attr = 0;
  switch (depth) {
    case 1:
      fetch_probe<1><<<1, kThreads, bytes, s>>>(hbm, n_tiles, iters, thresh,
                                                s_out);
      break;
    case 2:
      fetch_probe<2><<<1, kThreads, bytes, s>>>(hbm, n_tiles, iters, thresh,
                                                s_out);
      break;
    case 4:
      fetch_probe<4><<<1, kThreads, bytes, s>>>(hbm, n_tiles, iters, thresh,
                                                s_out);
      break;
    case 8:
      attr = launch_with_smem(fetch_probe<8>, bytes);
      fetch_probe<8><<<1, kThreads, bytes, s>>>(hbm, n_tiles, iters, thresh,
                                                s_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : attr;
}
