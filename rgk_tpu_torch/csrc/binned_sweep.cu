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
// A pair whose key is not a chunk id (the sentinel, or anything outside
// [0, n_chunks)), or whose ray is outside [0, r), gets that "none"; no pair
// is dropped, and sorting only matters for speed.
//
// What bounds it on this card: FP32 work, 64*chunk_halves row tests a
// listed pair, 31 flops the least that decides a row (a colonnade query of
// ~3.4 M pairs: ~0.1 ms at 67 TFLOP/s); its bytes (the pairs, their rays,
// the listed chunks) take a fifth of that.  In practice the schedulers' slots
// and the latency of each row test's dependent chain bound it, and the
// card hides that latency only with many warps in flight.  The first port
// ran one thread a pair over its chunk's rows, loaded from global memory
// (broadcasts, since sorted pairs share chunks), the whole row test on
// every row; a warp whose lanes' rows passed the plane stage unevenly ran
// the barycentric stage for all of them.  The design is K2's
// warp-cooperative sweep, applied to sorted pairs:
// * each warp owns 32 consecutive sorted pairs, one a lane, and finds the
//   same-chunk runs among them by a vote (a key that differs from its
//   left neighbour's), on the device with no host sync or glue: a long
//   run spreads over many warps, a short one costs only its own pairs;
// * for each run the warp loads the chunk's rows once, two a lane per
//   64-row sub-tile (slots lane and 32 + lane: each coefficient load is one
//   coalesced 128-byte line), so csz 512 is swept as eight sub-tiles;
// * each pair of the run is tested against all 64 rows at once: its ray
//   is read by every lane as a broadcast from shared memory (three
//   float4: origin and t_min, direction and t_max, exclude), each lane
//   runs cluster_common.cuh's row test on its two rows, and a butterfly of
//   shuffles picks the (min t, min id) winner, only when some lane hit.
//   So accept decisions and t are K2's bit for bit;
// * the window narrows as hits are found: after a hit the pair's t_max
//   in shared memory becomes min(t_max, nextafter(best t)), so a row at
//   exactly the best t with a smaller id still wins, and rows behind the
//   best hit leave the row test after its plane stage.
// Measured against the first port on the colonnade's queries (PERF.md),
// designs that staged rows in shared memory by cp.async for 4 or 2 pairs
// a lane (block-wide or per-warp windows) ran 1.6-7x slower: with 99-115
// registers and 34 KB of shared memory a block, too few warps hid the
// row tests' latency.  A fast-reciprocal prefilter ahead of the exact
// test, as K1 has, made this design slower too: here the exact test's
// plane stage, contracted to FMA, already rejects a row as cheaply as a
// prefilter would, and the prefilter's registers cost warps.

#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_common.cuh"

namespace {

using rgk::kBig;

constexpr int kWarps = 4;                   // warps per block
constexpr int kThreads = 32 * kWarps;       // a warp's window: 32 pairs
constexpr int kSub = 64;                    // rows a sub-tile, 2 a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFltMax = 3.40282347e38f;  // nextafter toward it: one ulp up

__global__ void __launch_bounds__(kThreads)
binned_sweep(const int* __restrict__ cid, const int* __restrict__ ray_of,
             long long p_count, int n_chunks, const float* __restrict__ pack,
             int csz, int r, const float* __restrict__ ro,
             const float* __restrict__ rd, const float* __restrict__ t_min,
             const float* __restrict__ t_max,
             const int* __restrict__ exclude, float* __restrict__ t_out,
             int* __restrict__ tri_out) {
  const int lane = threadIdx.x & 31;
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  if (p0 >= p_count) return;  // the whole warp leaves together

  // Lane l owns pair p0 + l; its ray sits in the warp's shared memory as
  // three float4 (o, t_min | d, the narrowed t_max | exclude), which each
  // lane reads as a broadcast when the warp tests that pair.
  __shared__ float4 s_ray[kWarps][32][3];
  float4 (*rays)[3] = s_ray[threadIdx.x >> 5];
  const long long p = p0 + lane;
  const int key = p < p_count ? cid[p] : -1;
  const int ri = p < p_count ? ray_of[p] : -1;
  const bool valid = ri >= 0 && ri < r;
  const float tmax = valid ? t_max[ri] : 0.f;
  if (valid) {
    const rgk::Ray q = rgk::load_ray(ro, rd, ri);
    rays[lane][0] = make_float4(q.ox, q.oy, q.oz, t_min[ri]);
    rays[lane][1] = make_float4(q.dx, q.dy, q.dz, tmax);
    rays[lane][2] = make_float4(__int_as_float(exclude[ri]), 0.f, 0.f, 0.f);
  }
  float best_t = kBig;
  int best_i = -1;

  // Runs: a run starts where a key differs from its left neighbour's.
  const int left = __shfl_up_sync(kFull, key, 1);
  unsigned starts = __ballot_sync(kFull, lane == 0 || key != left);
  const unsigned live = __ballot_sync(kFull, valid);
  __syncwarp();
  while (starts != 0u) {
    const int lo = __ffs(starts) - 1;
    starts &= starts - 1u;
    const int hi = starts != 0u ? __ffs(starts) - 1 : 32;
    const int c = __shfl_sync(kFull, key, lo);
    if (c < 0 || c >= n_chunks) continue;
    const unsigned span = (hi == 32 ? kFull : (1u << hi) - 1u) &
                          ~((1u << lo) - 1u);
    const unsigned run = span & live;
    if (run == 0u) continue;
    const long long s0 = static_cast<long long>(c) * csz;
    for (int base = 0; base < csz; base += kSub) {
      // Each lane loads two rows of the sub-tile, once for the run.
      const rgk::Row ra = rgk::load_row(pack, s0 + base + lane);
      const rgk::Row rb = rgk::load_row(pack, s0 + base + 32 + lane);
      for (unsigned g = run; g != 0u; g &= g - 1u) {
        const int src = __ffs(g) - 1;
        const float4 o = rays[src][0], d = rays[src][1], x = rays[src][2];
        const rgk::Ray q{o.x, o.y, o.z, d.x, d.y, d.z};
        const int qex = __float_as_int(x.x);
        float lt = kBig, ta, tb;
        int li = -1, ia, ib;
        if (rgk::row_hit(ra, q, o.w, d.w, qex, &ta, &ia))
          rgk::keep_min(ta, ia, &lt, &li);
        if (rgk::row_hit(rb, q, o.w, d.w, qex, &tb, &ib))
          rgk::keep_min(tb, ib, &lt, &li);
        if (__any_sync(kFull, li >= 0)) {
          for (int m = 16; m > 0; m >>= 1) {
            const float ot = __shfl_xor_sync(kFull, lt, m);
            const int oi = __shfl_xor_sync(kFull, li, m);
            rgk::keep_min(ot, oi, &lt, &li);
          }
          if (lane == src) {
            rgk::keep_min(lt, li, &best_t, &best_i);
            // Narrow the pair's window to its best t, opened by one ulp.
            rays[src][1].w = fminf(tmax, nextafterf(best_t, kFltMax));
          }
          __syncwarp();
        }
      }
    }
  }
  if (p < p_count) {
    t_out[p] = best_t;
    tri_out[p] = best_i;
  }
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Device pointers to contiguous arrays: cid, ray_of [P]
// i32; pack [T*16*128] f32 in n_chunks whole chunks of csz slots (csz a
// multiple of 64); ro, rd [r, 3] f32; t_min, t_max [r] f32; exclude [r]
// i32; outputs t [P] f32 and tri [P] i32.
extern "C" int rgk_binned_sweep(const int* cid, const int* ray_of,
                                long long p_count, int n_chunks,
                                const float* pack, int csz, int r,
                                const float* ro, const float* rd,
                                const float* t_min,
                                const float* t_max, const int* exclude,
                                float* t_out, int* tri_out, void* stream) {
  if (p_count <= 0) return 0;
  if (csz <= 0 || csz % kSub) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (p_count + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  binned_sweep<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      cid, ray_of, p_count, n_chunks, pack, csz, r, ro, rd, t_min, t_max,
      exclude, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}
