// Cluster-BVH ray intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel rgk_tpu/ops/pallas_cluster.py:_make_kernel (K2):
// the closest hit, or any hit, of each ray against a scene above 4096
// triangles, through the two-level chunk structure of
// rgk_tpu_torch/scene/clusters.py, read as it is:
//   boxes   u16 fixed-point node AABBs, 3 words a node:
//           w0 = qmin_x<<16 | qmin_y, w1 = qmin_z<<16 | qmax_x,
//           w2 = qmax_y<<16 | qmax_z; world = q * step + lo
//   bits    leaf flag of node n = (bits[n>>5] >> (n&31)) & 1
//   links   eight per-octant tables, `link_stride` words apart;
//           word n = hit<<16 | miss (unsigned fields): hit = near child
//           (inner) or chunk id (leaf), miss = the octant-DFS successor,
//           n_nodes ending the walk
//   pack    coefficient-major [T*16, 128] f32: slot s, coefficient j at
//           pack[((s>>7)*16 + j)*128 + (s&127)]; j = 0..11 Badouel
//           (n.xyz, d, b0, bv.xyz, g0, gv.xyz), 13 = the triangle id as
//           an int32 bit pattern (-1 pad); thin-glass and padding rows
//           are folded to n = 0, d = 1, so t = -inf fails t > t_min.
//
// It computes K2's function, not its block schedule.  One thread owns one
// ray (the front end sorted them by the coherence key, so a warp's rays
// share an octant and mostly the same chunks) and walks the chunk tree
// stacklessly through its own octant's front-to-back links:
//   slab-test node n on its dequantized box (the reference's quantized-
//   frame form, t = (q - (ro-lo)/step) * (step/rd), zero direction
//   components replaced by +-1e-20) against [t_min, min(best t, t_max)];
//   a hit inner node goes to its near child, a hit leaf sweeps chunk c's
//   64*chunk_halves rows (slots c*csz .. c*csz+csz-1, both leaf layouts)
//   and then, like a missed node, goes to the miss link.
// The sweep is the reference's shared-hit-point Badouel test; the winner
// is explicit (min t, then min id), so the result does not depend on the
// order in which chunks are met.  Any hit stops the thread at its first
// accepted hit and returns the witness tri 0.  A lane whose interval is
// empty (t_max <= t_min, as masked shadow rays have) cannot hit and does
// not walk.  Optional per-ray counters: nodes slab-tested, leaf chunks
// swept (null pointers skip them).
//
// What bounds it on this card: the walk is latency-bound.  Each node costs
// three box words, a link word and a leaf word (dependent loads, ~16 B,
// L1/L2-resident: 31k nodes are 0.5 MB at a million triangles), each swept
// triangle 13 loads of the pack.  The sorted order makes a warp's loads
// mostly one address (a broadcast) and keeps the hot chunks in L1; the
// divergence of rays that part ways is the main loss.  No shared memory:
// rays of one block visit different chunks.  Later work: a warp-wide
// frontier (one slab test per lane, one node per warp), staging hot
// chunks, compressed wide nodes.  nvcc contracts multiply-adds to FMA, so
// t and the barycentrics may differ from the plain version in the last
// bits; the front end recomputes the reported t and barycentrics from
// the winner's tri_pack row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;      // rays per block, one per thread
constexpr float kBig = 3.4e38f;  // "no hit" t

__device__ __forceinline__ float inv_dir(float c) {
  const float tiny = c >= 0.f ? 1e-20f : -1e-20f;
  return 1.f / (fabsf(c) > 1e-20f ? c : tiny);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
cluster_walk(const uint32_t* __restrict__ boxes,
             const uint32_t* __restrict__ bits,
             const uint32_t* __restrict__ links, int link_stride,
             int n_nodes, const float* __restrict__ pack, int csz,
             const float* __restrict__ lo, const float* __restrict__ step,
             const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ t_min,
             const float* __restrict__ t_max,
             const int* __restrict__ exclude, int r,
             float* __restrict__ t_out, int* __restrict__ tri_out,
             int* __restrict__ nodes_out, int* __restrict__ leaves_out) {
  const int ray = blockIdx.x * kBlock + threadIdx.x;
  if (ray >= r) return;
  const float ox = ro[3 * ray + 0], oy = ro[3 * ray + 1],
              oz = ro[3 * ray + 2];
  const float dx = rd[3 * ray + 0], dy = rd[3 * ray + 1],
              dz = rd[3 * ray + 2];
  const float tmin = t_min[ray], tmax = t_max[ray];
  const int excl = exclude[ray];

  const float stx = step[0], sty = step[1], stz = step[2];
  const float rqx = (ox - lo[0]) / stx;
  const float rqy = (oy - lo[1]) / sty;
  const float rqz = (oz - lo[2]) / stz;
  const float ivx = stx * inv_dir(dx);
  const float ivy = sty * inv_dir(dy);
  const float ivz = stz * inv_dir(dz);
  const int oct = (dx < 0.f) | ((dy < 0.f) << 1) | ((dz < 0.f) << 2);
  const uint32_t* lk = links + static_cast<long long>(oct) * link_stride;

  float best_t = kBig;
  int best_i = -1;
  bool found = false;
  int n_vis = 0, n_swept = 0;
  // A lane with an empty interval (a masked shadow ray) cannot hit.
  uint32_t n = tmax > tmin ? 0u : static_cast<uint32_t>(n_nodes);
  while (n < static_cast<uint32_t>(n_nodes)) {
    const uint32_t w0 = __ldg(boxes + 3 * n);
    const uint32_t w1 = __ldg(boxes + 3 * n + 1);
    const uint32_t w2 = __ldg(boxes + 3 * n + 2);
    const float t0x = (static_cast<float>(w0 >> 16) - rqx) * ivx;
    const float t1x = (static_cast<float>(w1 & 0xFFFFu) - rqx) * ivx;
    const float t0y = (static_cast<float>(w0 & 0xFFFFu) - rqy) * ivy;
    const float t1y = (static_cast<float>(w2 >> 16) - rqy) * ivy;
    const float t0z = (static_cast<float>(w1 >> 16) - rqz) * ivz;
    const float t1z = (static_cast<float>(w2 & 0xFFFFu) - rqz) * ivz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
    const float tcap = fminf(best_t, tmax);
    const bool hit = tf >= tn && tf >= tmin && tn <= tcap;
    ++n_vis;
    const uint32_t w = __ldg(lk + n);
    const bool leaf = (__ldg(bits + (n >> 5)) >> (n & 31)) & 1u;
    if (hit && !leaf) {
      n = w >> 16;
      continue;
    }
    if (hit) {
      ++n_swept;
      const long long s0 = static_cast<long long>(w >> 16) * csz;
      for (long long s = s0; s < s0 + csz; ++s) {
        const float* q = pack + (s >> 7) * (16 * 128) + (s & 127);
        const float nx = __ldg(q), ny = __ldg(q + 128),
                    nz = __ldg(q + 2 * 128), d = __ldg(q + 3 * 128);
        const float rddn = dx * nx + dy * ny + dz * nz;
        const float rodn = ox * nx + oy * ny + oz * nz + d;
        const float t = -rodn / rddn;
        if (!(t > tmin && t < tmax)) continue;  // rejects -inf and NaN
        const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
        const float beta = __ldg(q + 4 * 128) + px * __ldg(q + 5 * 128) +
                           py * __ldg(q + 6 * 128) + pz * __ldg(q + 7 * 128);
        const float gamma = __ldg(q + 8 * 128) + px * __ldg(q + 9 * 128) +
                            py * __ldg(q + 10 * 128) +
                            pz * __ldg(q + 11 * 128);
        if (!(beta >= 0.f && gamma >= 0.f && beta + gamma <= 1.f)) continue;
        const int pid = __float_as_int(__ldg(q + 13 * 128));
        if (pid == excl) continue;
        if (kAnyHit) {
          best_t = t;
          found = true;
          break;
        }
        if (t < best_t || (t == best_t && pid < best_i)) {
          best_t = t;
          best_i = pid;
        }
      }
      if (kAnyHit && found) break;
    }
    n = w & 0xFFFFu;
  }

  t_out[ray] = best_t;
  tri_out[ray] = kAnyHit ? (found ? 0 : -1) : best_i;
  if (nodes_out != nullptr) nodes_out[ray] = n_vis;
  if (leaves_out != nullptr) leaves_out[ray] = n_swept;
}

}  // namespace

// Launches the walk on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Device pointers to contiguous arrays: boxes [3*n_nodes]
// and bits [ceil(n_nodes/32)] i32; links [8*link_stride] i32; pack
// [T*16*128] f32 in whole chunks of csz slots; lo, step [3] f32; ro, rd
// [r, 3] f32; t_min, t_max [r] f32; exclude [r] i32; outputs t [r] f32,
// tri [r] i32 and, unless null, nodes / leaves [r] i32.
extern "C" int rgk_cluster_intersect(
    const int* boxes, const int* bits, const int* links, int link_stride,
    int n_nodes, const float* pack, int csz, const float* lo,
    const float* step, const float* ro, const float* rd, const float* t_min,
    const float* t_max, const int* exclude, int r, float* t_out,
    int* tri_out, int* nodes_out, int* leaves_out, int any_hit,
    void* stream) {
  if (r <= 0) return 0;
  const dim3 grid((r + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(boxes);
  const uint32_t* lb = reinterpret_cast<const uint32_t*>(bits);
  const uint32_t* lk = reinterpret_cast<const uint32_t*>(links);
  if (any_hit) {
    cluster_walk<true><<<grid, kBlock, 0, s>>>(
        b, lb, lk, link_stride, n_nodes, pack, csz, lo, step, ro, rd, t_min,
        t_max, exclude, r, t_out, tri_out, nodes_out, leaves_out);
  } else {
    cluster_walk<false><<<grid, kBlock, 0, s>>>(
        b, lb, lk, link_stride, n_nodes, pack, csz, lo, step, ro, rd, t_min,
        t_max, exclude, r, t_out, tri_out, nodes_out, leaves_out);
  }
  return static_cast<int>(cudaGetLastError());
}
