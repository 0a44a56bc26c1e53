// Cluster-BVH ray intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel rgk_tpu/ops/pallas_cluster.py:_make_kernel (K2):
// the closest hit, or any hit, of each ray against a scene above 4096
// triangles, through the two-level chunk structure of
// rgk_tpu_torch/scene/clusters.py, read as it is (layouts in
// cluster_common.cuh), plus:
//   bits    leaf flag of node n = (bits[n>>5] >> (n&31)) & 1
//   links   eight per-octant tables, `link_stride` words apart;
//           word n = hit<<16 | miss (unsigned fields): hit = near child
//           (inner) or chunk id (leaf), miss = the octant-DFS successor,
//           n_nodes ending the walk
//
// It computes K2's function, not its block schedule.  Each lane walks its
// ray stacklessly through its own octant's front-to-back links (the front
// end sorted the rays by the coherence key, so a warp's 32 rays share an
// octant and mostly the same chunks):
//   slab-test node n on its dequantized box (the reference's quantized-
//   frame form, t = (q - (ro-lo)/step) * (step/rd), zero direction
//   components replaced by +-1e-20) against [t_min, min(best t, t_max)];
//   a hit inner node goes to its near child, a hit leaf sweeps chunk c's
//   64*chunk_halves rows (slots c*csz .. c*csz+csz-1, both leaf layouts)
//   and then, like a missed node, goes to the miss link.
// The slab and row tests are cluster_common.cuh's, shared with K3 and K4;
// the winner is explicit (min t, then min id), so the result does not
// depend on the order in which chunks or rows are met.  Any hit stops the
// ray at its chunk's first accepted row (in slot order) and returns the
// witness tri 0.  A lane whose interval is empty (t_max <= t_min, as
// masked shadow rays have) cannot hit and does not walk.  Optional per-ray
// counters: nodes slab-tested, leaf chunks swept (null pointers skip
// them); they count exactly what a one-lane walk counts.
//
// What bounds it on this card: FP32 work that depends on the data, ~32
// flops per row test times 64 rows per swept chunk plus ~20 per slab
// test (a colonnade query of 518,400 rays sweeps ~5.6 chunks and tests
// ~56 nodes a ray: ~0.1 ms at 67 TFLOP/s).  A one-lane walk that sweeps
// its own chunks loses most of that to divergence: lanes of a warp reach
// leaves at different steps, and each lane's 64-row sweep (~45
// instructions a row, 13 scattered loads) runs while the others wait.
// The design, chosen from the measured SIMD efficiency of the sorted
// colonnade queries (leaves swept: mean / warp max 0.73 closest, 0.64
// shadow; nodes 0.81 / 0.77), is the warp-cooperative sweep:
// * walk: every lane takes one node step per round, in lockstep (the
//   steps are the same few instructions whatever the node);
// * sweep: the lanes that reached a leaf this round are served by the
//   whole warp, a chunk at a time: each lane loads 2 rows of each 64-row
//   block of the chunk into registers (slot lane and lane + 32, so every
//   coefficient load of the warp is one coalesced 128-byte line), once
//   for all lanes pending that chunk; each of their rays in turn is
//   broadcast by shuffles and tested against the loaded rows, and a
//   butterfly of shuffles picks the (min t, min id) winner (skipped when
//   no lane hit).  The lanes are full whatever the divergence, and a
//   ray's best t is updated before its next slab test, as in a one-lane
//   walk;
// * persistent blocks, as many as fit on the card, whose warps take
//   groups of 32 sorted rays from an atomic counter, so long rays do not
//   hold an SM in the tail.  The counter is one per device, reset on the
//   launch's stream before each launch, so two launches on one device must
//   not overlap (ops/cluster_intersect.py launches on the current stream).
// nvcc contracts multiply-adds to FMA, so t may differ from the plain
// version in the last bits; the front end recomputes the reported t and
// barycentrics from the winner's tri_pack row.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_common.cuh"

namespace {

using rgk::kBig;

constexpr int kWarps = 4;                // warps per block
constexpr int kBlock = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ unsigned int g_next_group;    // next group of 32 sorted rays

__device__ __forceinline__ rgk::Ray shfl_ray(const rgk::Ray& r, int src) {
  return rgk::Ray{__shfl_sync(kFull, r.ox, src), __shfl_sync(kFull, r.oy, src),
                  __shfl_sync(kFull, r.oz, src), __shfl_sync(kFull, r.dx, src),
                  __shfl_sync(kFull, r.dy, src), __shfl_sync(kFull, r.dz, src)};
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
             int* __restrict__ nodes_out, int* __restrict__ leaves_out,
             unsigned int* __restrict__ next_group) {
  const int lane = threadIdx.x & 31;
  const int n_groups = (r + 31) / 32;
  const uint32_t end = static_cast<uint32_t>(n_nodes);
  for (;;) {
    int group = 0;
    if (lane == 0) group = static_cast<int>(atomicAdd(next_group, 1u));
    group = __shfl_sync(kFull, group, 0);
    if (group >= n_groups) return;  // the whole warp leaves together

    const int ray = group * 32 + lane;
    const bool live = ray < r;  // the ragged tail still serves sweeps
    rgk::Ray rr{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float tmin = 0.f, tmax = 0.f;
    int excl = -1;
    if (live) {
      rr = rgk::load_ray(ro, rd, ray);
      tmin = t_min[ray];
      tmax = t_max[ray];
      excl = exclude[ray];
    }
    const rgk::SlabFrame f = rgk::slab_frame(rr, lo, step);
    const uint32_t* lk =
        links + static_cast<long long>(rgk::octant(rr)) * link_stride;

    float best_t = kBig;
    int best_i = -1;
    bool found = false;
    int n_vis = 0, n_swept = 0;
    // A lane with an empty interval (a masked shadow ray) cannot hit.
    uint32_t n = live && tmax > tmin ? 0u : end;
    while (__any_sync(kFull, n < end)) {
      // One node step per lane.
      int chunk = -1;
      if (n < end) {
        float tn, tf;
        rgk::slab(boxes, n, f, &tn, &tf);
        const bool hit = rgk::slab_hit(tn, tf, tmin, fminf(best_t, tmax));
        ++n_vis;
        const uint32_t w = __ldg(lk + n);
        if (hit && !rgk::is_leaf(bits, n)) {
          n = w >> 16;
        } else {
          if (hit) {
            chunk = static_cast<int>(w >> 16);
            ++n_swept;
          }
          n = w & 0xFFFFu;
        }
      }
      // The warp sweeps the pending (ray, chunk) pairs a chunk at a time:
      // each lane loads its two rows of every 64-row block of the chunk
      // once, and the rays of all lanes pending that chunk are tested
      // against them in turn.
      unsigned pending = __ballot_sync(kFull, chunk >= 0);
      while (pending) {
        const int c = __shfl_sync(kFull, chunk, __ffs(pending) - 1);
        const unsigned group = __ballot_sync(kFull, chunk == c);
        pending &= ~group;
        const long long s0 = static_cast<long long>(c) * csz;
        for (int base = 0; base < csz; base += 64) {
          const rgk::Row ra = rgk::load_row(pack, s0 + base + lane);
          const rgk::Row rb = rgk::load_row(pack, s0 + base + 32 + lane);
          for (unsigned g = group; g; g &= g - 1) {
            const int src = __ffs(g) - 1;
            if (kAnyHit && __shfl_sync(kFull, found, src)) continue;
            const rgk::Ray q = shfl_ray(rr, src);
            const float qmin = __shfl_sync(kFull, tmin, src);
            const float qmax = __shfl_sync(kFull, tmax, src);
            const int qex = __shfl_sync(kFull, excl, src);
            float ta = 0.f, tb = 0.f;
            int ia, ib;
            const bool ha = rgk::row_hit(ra, q, qmin, qmax, qex, &ta, &ia);
            const bool hb = rgk::row_hit(rb, q, qmin, qmax, qex, &tb, &ib);
            if (kAnyHit) {
              // The first accepted row in slot order: slots base + lane,
              // then base + 32 + lane.
              const unsigned ba = __ballot_sync(kFull, ha);
              const unsigned bb = __ballot_sync(kFull, hb);
              if ((ba | bb) != 0u) {
                const float t1 = ba ? __shfl_sync(kFull, ta, __ffs(ba) - 1)
                                    : __shfl_sync(kFull, tb, __ffs(bb) - 1);
                if (lane == src) {
                  best_t = t1;
                  found = true;
                  n = end;  // the walk ends at the first hit
                }
              }
            } else {
              float lt = kBig;
              int li = -1;
              if (ha) rgk::keep_min(ta, ia, &lt, &li);
              if (hb) rgk::keep_min(tb, ib, &lt, &li);
              if (__any_sync(kFull, li >= 0)) {
                for (int o = 16; o > 0; o >>= 1) {
                  const float ot = __shfl_xor_sync(kFull, lt, o);
                  const int oi = __shfl_xor_sync(kFull, li, o);
                  rgk::keep_min(ot, oi, &lt, &li);
                }
                if (lane == src) rgk::keep_min(lt, li, &best_t, &best_i);
              }
            }
          }
        }
      }
    }

    if (live) {
      t_out[ray] = best_t;
      tri_out[ray] = kAnyHit ? (found ? 0 : -1) : best_i;
      if (nodes_out != nullptr) nodes_out[ray] = n_vis;
      if (leaves_out != nullptr) leaves_out[ray] = n_swept;
    }
  }
}

// Per device: the blocks of the persistent grid (as many as fit) for each
// variant, and the address of its group counter; 0 / null until the first
// launch there.  Racing first launches store the same values.
constexpr int kMaxDevices = 64;
std::atomic<int> g_blocks[2][kMaxDevices];
std::atomic<void*> g_counter[kMaxDevices];

template <bool kAnyHit>
cudaError_t launch_setup(int* blocks, void** counter) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *blocks = g_blocks[kAnyHit][dev].load(std::memory_order_relaxed);
  *counter = g_counter[dev].load(std::memory_order_relaxed);
  if (*blocks > 0 && *counter != nullptr) return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cluster_walk<kAnyHit>, kBlock, 0);
  if (err == cudaSuccess) err = cudaGetSymbolAddress(counter, g_next_group);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (*blocks <= 0) return cudaErrorInvalidConfiguration;
  g_blocks[kAnyHit][dev].store(*blocks, std::memory_order_relaxed);
  g_counter[dev].store(*counter, std::memory_order_relaxed);
  return cudaSuccess;
}

template <bool kAnyHit>
int launch(const uint32_t* b, const uint32_t* lb, const uint32_t* lk,
           int link_stride, int n_nodes, const float* pack, int csz,
           const float* lo, const float* step, const float* ro,
           const float* rd, const float* t_min, const float* t_max,
           const int* exclude, int r, float* t_out, int* tri_out,
           int* nodes_out, int* leaves_out, cudaStream_t s) {
  int blocks = 0;
  void* counter = nullptr;
  cudaError_t err = launch_setup<kAnyHit>(&blocks, &counter);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (r + kBlock - 1) / kBlock;
  const dim3 grid(needed < blocks ? needed : blocks);
  cluster_walk<kAnyHit><<<grid, kBlock, 0, s>>>(
      b, lb, lk, link_stride, n_nodes, pack, csz, lo, step, ro, rd, t_min,
      t_max, exclude, r, t_out, tri_out, nodes_out, leaves_out,
      static_cast<unsigned int*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the walk on `stream` and returns the first CUDA error as an int
// (0 = launched).  Device pointers to contiguous arrays: boxes [3*n_nodes]
// and bits [ceil(n_nodes/32)] i32; links [8*link_stride] i32; pack
// [T*16*128] f32 in whole chunks of csz slots (csz a multiple of 64); lo,
// step [3] f32; ro, rd [r, 3] f32; t_min, t_max [r] f32; exclude [r] i32;
// outputs t [r] f32, tri [r] i32 and, unless null, nodes / leaves [r] i32.
extern "C" int rgk_cluster_intersect(
    const int* boxes, const int* bits, const int* links, int link_stride,
    int n_nodes, const float* pack, int csz, const float* lo,
    const float* step, const float* ro, const float* rd, const float* t_min,
    const float* t_max, const int* exclude, int r, float* t_out,
    int* tri_out, int* nodes_out, int* leaves_out, int any_hit,
    void* stream) {
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(boxes);
  const uint32_t* lb = reinterpret_cast<const uint32_t*>(bits);
  const uint32_t* lk = reinterpret_cast<const uint32_t*>(links);
  if (any_hit)
    return launch<true>(b, lb, lk, link_stride, n_nodes, pack, csz, lo, step,
                        ro, rd, t_min, t_max, exclude, r, t_out, tri_out,
                        nodes_out, leaves_out, s);
  return launch<false>(b, lb, lk, link_stride, n_nodes, pack, csz, lo, step,
                       ro, rd, t_min, t_max, exclude, r, t_out, tri_out,
                       nodes_out, leaves_out, s);
}
