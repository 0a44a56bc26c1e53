// Dense chunk sweeps of (chunk, ray) pairs for Hopper (sm_90a): kernel K4
// of the binned pipeline.
//
// Replaces the TPU kernel rgk_tpu/ops/pallas_binned.py:_make_sweep_kernel
// (K4).  The front end (ops/binned_intersect.py) turns K3's per-ray chunk
// lists into P pairs sorted by chunk id (a stable sort; invalid pairs carry
// a sentinel key that sorts last).  For pair p this kernel returns the
// closest hit (min t, then min id) of ray ray_of[p] among the
// 64*chunk_halves triangles of chunk cid[p], inside (t_min, t_max) of that
// ray and honouring its `exclude`; t = 3.4e38, id = -1 when there is none.
// Both leaf layouts are one loop over slots s = chunk*csz + j of the
// coefficient-major pack, with cluster_common.cuh's row test, so t is
// bit-equal to K2's for the same ray and triangle.
//
// It computes K4's function, not its block schedule.  The TPU kernel runs
// [8, 128] pair blocks in order, steps a scalar loop from one same-chunk
// run to the next (run ends precomputed by the glue) and re-uses the DMA'd,
// transposed tile while the chunk repeats.  Here one thread owns one
// sorted pair and reads its ray through ray_of.  A pair whose key is not a
// chunk id (the sentinel, or anything outside [0, n_chunks)), or whose ray
// is outside [0, r), exits at once, and threads past P do nothing: no pair
// is dropped and no padding is needed.
//
// What bounds it on this card: 13 pack loads and ~40 FP32 operations per
// triangle tested.  Pairs are sorted by chunk, so the threads of a warp
// mostly sweep one chunk: their pack loads are one address (a broadcast)
// and the chunk stays in L1.  Later work: stage a chunk's tile in shared
// memory with TMA for a whole same-chunk run.

#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_common.cuh"

namespace {

using rgk::kBig;

constexpr int kBlock = 128;  // pairs per block, one per thread

__global__ void __launch_bounds__(kBlock)
binned_sweep(const int* __restrict__ cid, const int* __restrict__ ray_of,
             long long p_count, int n_chunks, const float* __restrict__ pack,
             int csz, int r, const float* __restrict__ ro,
             const float* __restrict__ rd, const float* __restrict__ t_min,
             const float* __restrict__ t_max,
             const int* __restrict__ exclude, float* __restrict__ t_out,
             int* __restrict__ tri_out) {
  const long long p = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (p >= p_count) return;
  const int c = cid[p];
  const int ray = ray_of[p];
  float best_t = kBig;
  int best_i = -1;
  if (c >= 0 && c < n_chunks && ray >= 0 && ray < r) {
    const rgk::Ray rr = rgk::load_ray(ro, rd, ray);
    const float tmin = t_min[ray], tmax = t_max[ray];
    const int excl = exclude[ray];
    const long long s0 = static_cast<long long>(c) * csz;
    for (long long s = s0; s < s0 + csz; ++s) {
      float t;
      int pid;
      if (rgk::row_hit(pack, s, rr, tmin, tmax, excl, &t, &pid)) {
        rgk::keep_min(t, pid, &best_t, &best_i);
      }
    }
  }
  t_out[p] = best_t;
  tri_out[p] = best_i;
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Device pointers to contiguous arrays: cid, ray_of [P]
// i32; pack [T*16*128] f32 in n_chunks whole chunks of csz slots; ro, rd
// [r, 3] f32; t_min, t_max [r] f32; exclude [r] i32; outputs t [P] f32 and
// tri [P] i32.
extern "C" int rgk_binned_sweep(const int* cid, const int* ray_of,
                                long long p_count, int n_chunks,
                                const float* pack, int csz, int r,
                                const float* ro, const float* rd,
                                const float* t_min,
                                const float* t_max, const int* exclude,
                                float* t_out, int* tri_out, void* stream) {
  if (p_count <= 0) return 0;
  const long long blocks = (p_count + kBlock - 1) / kBlock;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  binned_sweep<<<static_cast<unsigned>(blocks), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      cid, ray_of, p_count, n_chunks, pack, csz, r, ro, rd, t_min, t_max,
      exclude, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}
