// Device code shared by the chunk-tree kernels K2 (cluster_intersect.cu),
// K3 (binned_walk.cu), K4 (binned_sweep.cu) and the sweep probe of
// probes.cu.
//
// Node decisions and in-kernel t must be the same instructions in every
// kernel: the binned pipeline (K3 + K4, then K2 over the window K3 could
// not cover) reports the same winner as K2 alone only if all of them slab-
// test a node and intersect a triangle exactly alike.  So the slab test
// and the shared-hit-point Badouel row test live here, once.
//
// Layouts (rgk_tpu_torch/scene/clusters.py):
//   boxes   u16 fixed-point node AABBs, 3 words a node:
//           w0 = qmin_x<<16 | qmin_y, w1 = qmin_z<<16 | qmax_x,
//           w2 = qmax_y<<16 | qmax_z; world = q * step + lo
//   pack    coefficient-major [T*16, 128] f32: slot s, coefficient j at
//           pack[((s>>7)*16 + j)*128 + (s&127)]; j = 0..11 Badouel
//           (n.xyz, d, b0, bv.xyz, g0, gv.xyz), 13 = the triangle id as an
//           int32 bit pattern (-1 pad); thin-glass and padding rows are
//           folded to n = 0, d = 1, so t = -inf fails t > t_min.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rgk {

constexpr float kBig = 3.4e38f;  // "no hit" t

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The ray in the quantized frame of the node boxes: t = (q - rq) * iv.
struct SlabFrame {
  float rqx, rqy, rqz, ivx, ivy, ivz;
};

__device__ __forceinline__ float inv_dir(float c) {
  const float tiny = c >= 0.f ? 1e-20f : -1e-20f;
  return 1.f / (fabsf(c) > 1e-20f ? c : tiny);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ro,
                                        const float* __restrict__ rd,
                                        long long i) {
  return Ray{ro[3 * i + 0], ro[3 * i + 1], ro[3 * i + 2],
             rd[3 * i + 0], rd[3 * i + 1], rd[3 * i + 2]};
}

// The reference's quantized-frame slab terms (zero direction components
// replaced by +-1e-20).
__device__ __forceinline__ SlabFrame slab_frame(const Ray& r,
                                                const float* __restrict__ lo,
                                                const float* __restrict__ step) {
  const float stx = step[0], sty = step[1], stz = step[2];
  return SlabFrame{(r.ox - lo[0]) / stx, (r.oy - lo[1]) / sty,
                   (r.oz - lo[2]) / stz, stx * inv_dir(r.dx),
                   sty * inv_dir(r.dy), stz * inv_dir(r.dz)};
}

// Direction octant: bit a set = negative along axis a.
__device__ __forceinline__ int octant(const Ray& r) {
  return (r.dx < 0.f) | ((r.dy < 0.f) << 1) | ((r.dz < 0.f) << 2);
}

// Entry and exit t of node n's dequantized box.  Subtract-then-multiply
// cannot be contracted to FMA, so tn and tf are bit-equal to the plain
// versions' and every kernel takes the same node decisions.
__device__ __forceinline__ void slab(const uint32_t* __restrict__ boxes,
                                     uint32_t n, const SlabFrame& f,
                                     float* tn, float* tf) {
  const uint32_t w0 = __ldg(boxes + 3 * n);
  const uint32_t w1 = __ldg(boxes + 3 * n + 1);
  const uint32_t w2 = __ldg(boxes + 3 * n + 2);
  const float t0x = (static_cast<float>(w0 >> 16) - f.rqx) * f.ivx;
  const float t1x = (static_cast<float>(w1 & 0xFFFFu) - f.rqx) * f.ivx;
  const float t0y = (static_cast<float>(w0 & 0xFFFFu) - f.rqy) * f.ivy;
  const float t1y = (static_cast<float>(w2 >> 16) - f.rqy) * f.ivy;
  const float t0z = (static_cast<float>(w1 >> 16) - f.rqz) * f.ivz;
  const float t1z = (static_cast<float>(w2 & 0xFFFFu) - f.rqz) * f.ivz;
  *tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  *tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// A node is entered when its box overlaps [t_min, tcap].
__device__ __forceinline__ bool slab_hit(float tn, float tf, float tmin,
                                         float tcap) {
  return tf >= tn && tf >= tmin && tn <= tcap;
}

// Leaf flag of node n.
__device__ __forceinline__ bool is_leaf(const uint32_t* __restrict__ bits,
                                        uint32_t n) {
  return (__ldg(bits + (n >> 5)) >> (n & 31)) & 1u;
}

// Shared-hit-point Badouel test of pack slot s: true, with t and the
// triangle id, when the ray hits it inside (tmin, tmax) and it is not
// `excl`.  Every compare is written so that NaN and -inf fail.
__device__ __forceinline__ bool row_hit(const float* __restrict__ pack,
                                        long long s, const Ray& r,
                                        float tmin, float tmax, int excl,
                                        float* t_out, int* pid_out) {
  const float* q = pack + (s >> 7) * (16 * 128) + (s & 127);
  const float nx = __ldg(q), ny = __ldg(q + 128), nz = __ldg(q + 2 * 128),
              d = __ldg(q + 3 * 128);
  const float rddn = r.dx * nx + r.dy * ny + r.dz * nz;
  const float rodn = r.ox * nx + r.oy * ny + r.oz * nz + d;
  const float t = -rodn / rddn;
  if (!(t > tmin && t < tmax)) return false;  // rejects -inf and NaN
  const float px = r.ox + t * r.dx, py = r.oy + t * r.dy,
              pz = r.oz + t * r.dz;
  const float beta = __ldg(q + 4 * 128) + px * __ldg(q + 5 * 128) +
                     py * __ldg(q + 6 * 128) + pz * __ldg(q + 7 * 128);
  const float gamma = __ldg(q + 8 * 128) + px * __ldg(q + 9 * 128) +
                      py * __ldg(q + 10 * 128) + pz * __ldg(q + 11 * 128);
  if (!(beta >= 0.f && gamma >= 0.f && beta + gamma <= 1.f)) return false;
  const int pid = __float_as_int(__ldg(q + 13 * 128));
  if (pid == excl) return false;
  *t_out = t;
  *pid_out = pid;
  return true;
}

// The (min t, then min id) winner rule, whatever order hits come in.
__device__ __forceinline__ void keep_min(float t, int pid, float* best_t,
                                         int* best_i) {
  if (t < *best_t || (t == *best_t && pid < *best_i)) {
    *best_t = t;
    *best_i = pid;
  }
}

}  // namespace rgk
