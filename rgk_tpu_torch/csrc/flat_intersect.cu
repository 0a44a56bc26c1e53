// Flat-sweep ray-triangle intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel rgk_tpu/ops/pallas_intersect.py:_kernel (K1):
// the closest hit, or any hit, of each ray against every triangle's
// Badouel row of a flat scene (at most 4096 triangles).  It computes
// exactly K1's function:
//   t     = -(ro.n + d) / (rd.n)                 rejected if |rd.n| <= 1e-9
//   beta  = b0 + ro.bv + t * (rd.bv)             (same expression order)
//   gamma = g0 + ro.gv + t * (rd.gv)
//   accept: beta >= 0, gamma >= 0, beta + gamma <= 1, t_min < t < t_max,
//           not thin glass (col 12 <= 0.5), id != exclude
//   closest: min t, then min id;   any: K1's witness (tri 0 / -1, bary 0)
//
// What bounds it on this card: FP32 ray-triangle tests, about 40 flops
// each, R * M of them per query.  One thread owns one ray and keeps it in
// registers; a block of 128 rays stages the [M, 13] tri_pack through
// shared memory 256 rows (13 KB) at a time, so every row read from device
// memory serves the whole block and the inner loop reads shared memory
// by broadcast.  The any-hit variant stops a ray at its first accepted
// hit, and the block leaves the tile loop once all its rays are done.
// nvcc contracts multiply-adds to FMA, so t and the barycentrics may
// differ from an unfused evaluation in the last bits.
//
// Later work, not here: tensor-core (wgmma) formulations of the dot
// products, TMA staging of the tiles, and a BVH for larger scenes (K2).
// Plain CUDA rather than Triton: this is a compute-bound sweep with a
// per-ray early exit and a block vote, not an elementwise pass.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;      // rays per block, one per thread
constexpr int kTile = 256;       // triangle rows staged per tile
constexpr int kCols = 13;        // Badouel row + thin-glass flag
constexpr float kBig = 3.4e38f;  // "no hit" t, as in K1
constexpr float kParallelEps = 1e-9f;

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
flat_sweep(const float* __restrict__ pack, int m,
           const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const int* __restrict__ exclude, int r,
           float* __restrict__ t_out, int* __restrict__ tri_out,
           float* __restrict__ bb_out, float* __restrict__ bc_out) {
  __shared__ float tile[kTile * kCols];

  const int ray = blockIdx.x * kBlock + threadIdx.x;
  const bool live = ray < r;  // the ragged tail still helps stage tiles
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = 0.f;
  int excl = -1;
  if (live) {
    ox = ro[3 * ray + 0];
    oy = ro[3 * ray + 1];
    oz = ro[3 * ray + 2];
    dx = rd[3 * ray + 0];
    dy = rd[3 * ray + 1];
    dz = rd[3 * ray + 2];
    tmin = t_min[ray];
    tmax = t_max[ray];
    excl = exclude[ray];
  }

  float best_t = kBig, best_b = 0.f, best_c = 0.f;
  int best_i = -1;
  bool done = !live;

  for (int base = 0; base < m; base += kTile) {
    const int rows = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    const float* src = pack + static_cast<long long>(base) * kCols;
    for (int k = threadIdx.x; k < rows * kCols; k += kBlock) tile[k] = src[k];
    __syncthreads();

    if (!done) {
      for (int j = 0; j < rows; ++j) {
        const float* q = tile + j * kCols;
        const float rddn = dx * q[0] + dy * q[1] + dz * q[2];
        const float rodn = ox * q[0] + oy * q[1] + oz * q[2] + q[3];
        const bool safe = fabsf(rddn) > kParallelEps;
        const float t = -rodn / (safe ? rddn : 1.f);
        const float beta = q[4] + ox * q[5] + oy * q[6] + oz * q[7] +
                           t * (dx * q[5] + dy * q[6] + dz * q[7]);
        const float gamma = q[8] + ox * q[9] + oy * q[10] + oz * q[11] +
                            t * (dx * q[9] + dy * q[10] + dz * q[11]);
        const int id = base + j;
        const bool ok = safe && beta >= 0.f && gamma >= 0.f &&
                        beta + gamma <= 1.f && t > tmin && t < tmax &&
                        !(q[12] > 0.5f) && id != excl;
        if (kAnyHit) {
          if (ok) {
            best_t = t;
            done = true;
            break;
          }
        } else if (ok && t < best_t) {
          // Ids ascend, so a strict < keeps the lowest id on t ties.
          best_t = t;
          best_i = id;
          best_b = beta;
          best_c = gamma;
        }
      }
    }
    if (kAnyHit && __syncthreads_and(done)) break;
  }

  if (!live) return;
  t_out[ray] = best_t;
  if (kAnyHit) {
    tri_out[ray] = done ? 0 : -1;
    bb_out[ray] = 0.f;
    bc_out[ray] = 0.f;
  } else {
    tri_out[ray] = best_i;
    bb_out[ray] = best_i >= 0 ? best_b : 0.f;
    bc_out[ray] = best_i >= 0 ? best_c : 0.f;
  }
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  All pointers are device pointers to contiguous arrays:
// pack [m, 13] f32; ro, rd [r, 3] f32; t_min, t_max [r] f32; exclude [r]
// i32; outputs t [r] f32, tri [r] i32, bary_b, bary_c [r] f32.
extern "C" int rgk_flat_intersect(const float* pack, int m, const float* ro,
                                  const float* rd, const float* t_min,
                                  const float* t_max, const int* exclude,
                                  int r, float* t_out, int* tri_out,
                                  float* bb_out, float* bc_out, int any_hit,
                                  void* stream) {
  if (r <= 0) return 0;
  const dim3 grid((r + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    flat_sweep<true><<<grid, kBlock, 0, s>>>(pack, m, ro, rd, t_min, t_max,
                                             exclude, r, t_out, tri_out,
                                             bb_out, bc_out);
  } else {
    flat_sweep<false><<<grid, kBlock, 0, s>>>(pack, m, ro, rd, t_min, t_max,
                                              exclude, r, t_out, tri_out,
                                              bb_out, bc_out);
  }
  return static_cast<int>(cudaGetLastError());
}
