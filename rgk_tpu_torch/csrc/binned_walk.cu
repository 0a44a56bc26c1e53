// Walk-emit over the chunk tree for Hopper (sm_90a): kernel K3 of the
// binned pipeline.
//
// Replaces the TPU kernel rgk_tpu/ops/pallas_binned.py:_make_walk_kernel
// (K3).  For each ray it lists the leaf chunks whose slab test passes,
// without sweeping them:
//   ids      i32 [r, K]  the chunk ids, in walk order, capped at K, -1 pad
//   cnt      i32 [r]     every leaf that passed, the overflow included
//   skipmin  f32 [r]     the least entry t of the leaves dropped by the cap,
//                        nudged down (tn - |tn|*2e-7 - 1e-30), else 3.4e38
//   nodes    i32 [r]     nodes slab-tested (optional, null skips it)
// The front end (ops/binned_intersect.py) sweeps the listed chunks with K4
// and hands the window (skipmin, best t] to K2.
//
// It computes K3's function, not its block schedule.  The TPU kernel is
// built around that chip: a block-majority octant, 24-node frontier
// batches voted in power-of-two bits, a 4096-word scalar-memory stack and
// link paging.  None of it carries over.  One thread owns one sorted ray
// and walks K2's stackless path through its own octant's links, with the
// slab test of cluster_common.cuh, so its node decisions are K2's:
//   tcap = min(t_max, skipmin) once cnt >= K, else t_max; the best hit t
//   is never used, since nothing is swept here;
//   a hit inner node goes to its near child; a hit leaf appends its chunk
//   id (link >> 16) while cnt < K, else lowers skipmin; both count.
// Invariant the front end relies on: a chunk that is neither listed nor
// skipped is not entered before skipmin (or t_max), so pass 2 over
// (skipmin, best t] covers everything the cap dropped.  Without overflow
// the set of listed chunks and cnt do not depend on the walk order (each
// leaf is tested against the same fixed t_max), which is how the port's
// tests hold this walk to the reference's.
//
// The nudge is written with __fmul_rn / __fsub_rn so nvcc cannot fuse it
// into an FMA: skipmin is then bit-equal to the plain version's.
//
// What bounds it on this card: like K2, the dependent loads of the walk
// (three box words, a link word and a leaf word a node, all L1/L2-
// resident); there is no sweep.  Each thread writes its own row of ids;
// K is at most a few words, so the scattered stores are a small cost.

#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_common.cuh"

namespace {

using rgk::kBig;

constexpr int kBlock = 128;  // rays per block, one per thread

__global__ void __launch_bounds__(kBlock)
binned_walk(const uint32_t* __restrict__ boxes,
            const uint32_t* __restrict__ bits,
            const uint32_t* __restrict__ links, int link_stride, int n_nodes,
            const float* __restrict__ lo, const float* __restrict__ step,
            const float* __restrict__ ro, const float* __restrict__ rd,
            const float* __restrict__ t_min, const float* __restrict__ t_max,
            int r, int k_cap, int* __restrict__ ids_out,
            int* __restrict__ cnt_out, float* __restrict__ skip_out,
            int* __restrict__ nodes_out) {
  const int ray = blockIdx.x * kBlock + threadIdx.x;
  if (ray >= r) return;
  const rgk::Ray rr = rgk::load_ray(ro, rd, ray);
  const float tmin = t_min[ray], tmax = t_max[ray];
  const rgk::SlabFrame f = rgk::slab_frame(rr, lo, step);
  const uint32_t* lk =
      links + static_cast<long long>(rgk::octant(rr)) * link_stride;
  int* row = ids_out + static_cast<long long>(ray) * k_cap;
  for (int k = 0; k < k_cap; ++k) row[k] = -1;

  int cnt = 0, n_vis = 0;
  float skipmin = kBig;
  // A lane with an empty interval (a masked shadow ray) does not walk.
  uint32_t n = tmax > tmin ? 0u : static_cast<uint32_t>(n_nodes);
  while (n < static_cast<uint32_t>(n_nodes)) {
    float tn, tf;
    rgk::slab(boxes, n, f, &tn, &tf);
    const float tcap = cnt >= k_cap ? fminf(tmax, skipmin) : tmax;
    const bool hit = rgk::slab_hit(tn, tf, tmin, tcap);
    ++n_vis;
    const uint32_t w = __ldg(lk + n);
    const bool leaf = rgk::is_leaf(bits, n);
    if (hit && !leaf) {
      n = w >> 16;
      continue;
    }
    if (hit) {
      if (cnt < k_cap) {
        row[cnt] = static_cast<int>(w >> 16);
      } else {
        // Pass 2 tests t > skipmin strictly: a hit exactly on the dropped
        // box's face must stay inside its window.
        const float tn_c =
            __fsub_rn(__fsub_rn(tn, __fmul_rn(fabsf(tn), 2e-7f)), 1e-30f);
        skipmin = fminf(skipmin, tn_c);
      }
      ++cnt;
    }
    n = w & 0xFFFFu;
  }

  cnt_out[ray] = cnt;
  skip_out[ray] = skipmin;
  if (nodes_out != nullptr) nodes_out[ray] = n_vis;
}

}  // namespace

// Launches the walk on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Device pointers to contiguous arrays: boxes [3*n_nodes]
// and bits [ceil(n_nodes/32)] i32; links [8*link_stride] i32; lo, step [3]
// f32; ro, rd [r, 3] f32; t_min, t_max [r] f32; outputs ids [r, k_cap]
// i32, cnt [r] i32, skipmin [r] f32 and, unless null, nodes [r] i32.
extern "C" int rgk_binned_walk(const int* boxes, const int* bits,
                               const int* links, int link_stride,
                               int n_nodes, const float* lo,
                               const float* step, const float* ro,
                               const float* rd, const float* t_min,
                               const float* t_max, int r, int k_cap,
                               int* ids_out, int* cnt_out, float* skip_out,
                               int* nodes_out, void* stream) {
  if (r <= 0) return 0;
  if (k_cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((r + kBlock - 1) / kBlock);
  binned_walk<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(boxes),
      reinterpret_cast<const uint32_t*>(bits),
      reinterpret_cast<const uint32_t*>(links), link_stride, n_nodes, lo,
      step, ro, rd, t_min, t_max, r, k_cap, ids_out, cnt_out, skip_out,
      nodes_out);
  return static_cast<int>(cudaGetLastError());
}
