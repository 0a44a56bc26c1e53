// Flat-sweep ray-triangle intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel rgk_tpu/ops/pallas_intersect.py:_kernel (K1):
// the closest hit, or any hit, of each ray against every triangle's
// Badouel row of a flat scene (at most 4096 triangles).  It computes
// exactly K1's function, in the expression order of the plain version
// (ops/flat_intersect.py:flat_plain) with every operation rounded on its
// own, so its decisions, t and barycentrics equal flat_plain's bit for bit:
//   t     = -(ro.n + d) / (rd.n)                 rejected if |rd.n| <= 1e-9
//   beta  = b0 + ro.bv + t * (rd.bv)
//   gamma = g0 + ro.gv + t * (rd.gv)
//   accept: beta >= 0, gamma >= 0, beta + gamma <= 1, t_min < t < t_max,
//           not thin glass (col 12 <= 0.5), id != exclude
//   closest: min t, then min id;   any: K1's witness (tri 0 / -1, bary 0),
//   with t the first accepted row's
//
// What bounds it on this card: FP32 work, R * M ray-row tests.  The least
// work that decides a row is the hit-point form, 31 flops (rd.n 5, ro.n + d
// 6, t 1, hit point 6, beta 6, gamma 6, sum 1), so at 67 TFLOP/s a query
// of 262,144 rays x 3,870 rows needs 0.47 ms; its bytes (rays, outputs, a
// 200 KB pack read from L2 by each block) take ~4 us.  The schedulers'
// instruction slots, not the FP32 lanes, are the real ceiling: the test as
// written is ~45 instructions with its IEEE division.  The design spends as
// few instructions a test as it can:
// * register blocking: a thread owns kRays rays, so each staged row,
//   loaded once into registers, serves kRays tests;
// * rows staged padded to 16 words and read as three float4 broadcasts
//   (n.d, b0.bv, g0.gv); a thin-glass row (the same for the whole block)
//   is skipped before any test;
// * a prefilter of ~35 instructions: rd.n and ro.n + d as the exact test
//   computes them, t by the fast reciprocal, the barycentrics from the hit
//   point, each test widened by a slack (below); only a row that passes it
//   (a hit, or a near miss, closer than the ray's best) runs the exact
//   test, which alone decides, so the result is K1's function;
// * asynchronous double-buffered staging: the block copies tile i+1 with
//   4-byte cp.async (a 13-word row is not 16-byte aligned) while it
//   sweeps tile i, one barrier per tile;
// * any hit: a warp whose rays are all done skips the sweep (__all_sync),
//   and the block leaves the tile loop when all its warps are done.
//
// The prefilter's slack bounds how far its values can lie from the exact
// test's.  The fast t is within 2 ulp of the exact t (kTSlack covers it
// many times).  The barycentrics differ by the roundings of both forms and
// by the error of t along rd.bv, all proportional to the magnitudes summed,
// |b0| + max|bv| * (|ro|_1 + |t| |rd|_1): at most ~15 float32 epsilons/2
// of it, for which the slack takes kEps = 64 of them, plus kSlack.  Far
// cameras, large coordinates and small triangles raise those magnitudes,
// and the slack with them.
//
// Plain CUDA rather than Triton: a compute-bound sweep with per-ray early
// exits and a block vote, not an elementwise pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;              // threads per block
constexpr int kRays = 4;                   // rays per thread
constexpr int kRaysPerBlock = kThreads * kRays;
constexpr int kTile = 128;                 // triangle rows staged per tile
constexpr int kCols = 13;                  // Badouel row + thin-glass flag
constexpr int kStride = 16;                // staged words per row
constexpr float kBig = 3.4e38f;            // "no hit" t, as in K1
constexpr float kParallelEps = 1e-9f;
// The prefilter's slack (header note): a barycentric floor, a share of the
// magnitudes summed (2^-18, 64 float32 half-epsilons), and a relative one
// on t.
constexpr float kSlack = 1e-3f;
constexpr float kEps = 3.814697265625e-6f;
constexpr float kTSlack = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// a.b of two 3-vectors in flat_plain's order, each operation rounded on
// its own (no FMA contraction).
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// c0 + o.v + t * (d.v), flat_plain's beta or gamma, rounded as it rounds.
__device__ __forceinline__ float bary(float c0, float vx, float vy, float vz,
                                      float ox, float oy, float oz, float dx,
                                      float dy, float dz, float t) {
  const float ov = __fadd_rn(
      __fadd_rn(__fadd_rn(c0, __fmul_rn(ox, vx)), __fmul_rn(oy, vy)),
      __fmul_rn(oz, vz));
  return __fadd_rn(ov, __fmul_rn(t, dot3(dx, dy, dz, vx, vy, vz)));
}

// Starts the copy of rows [base, base + rows) into a padded tile.
__device__ __forceinline__ void stage(float* tile, const float* pack,
                                      int base, int rows) {
  const float* src = pack + static_cast<long long>(base) * kCols;
  for (int k = threadIdx.x; k < rows * kCols; k += kThreads) {
    const int row = k / kCols;
    cp_async4(tile + row * kStride + (k - row * kCols), src + k);
  }
  cp_async_commit();
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
flat_sweep(const float* __restrict__ pack, int m,
           const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const int* __restrict__ exclude, int r,
           float* __restrict__ t_out, int* __restrict__ tri_out,
           float* __restrict__ bb_out, float* __restrict__ bc_out) {
  __shared__ __align__(16) float tiles[2][kTile * kStride];

  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tmin[kRays], tmax[kRays], best_t[kRays], best_b[kRays],
      best_c[kRays], o1[kRays], d1[kRays];
  int excl[kRays], best_i[kRays];
  bool found[kRays];
  const int ray0 = blockIdx.x * kRaysPerBlock + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = ray0 + k * kThreads;
    const bool live = ray < r;  // a dead slot has an empty window
    ox[k] = live ? ro[3 * ray + 0] : 0.f;
    oy[k] = live ? ro[3 * ray + 1] : 0.f;
    oz[k] = live ? ro[3 * ray + 2] : 0.f;
    dx[k] = live ? rd[3 * ray + 0] : 0.f;
    dy[k] = live ? rd[3 * ray + 1] : 0.f;
    dz[k] = live ? rd[3 * ray + 2] : 0.f;
    tmin[k] = live ? t_min[ray] : 0.f;
    tmax[k] = live ? t_max[ray] : 0.f;
    excl[k] = live ? exclude[ray] : -1;
    o1[k] = fabsf(ox[k]) + fabsf(oy[k]) + fabsf(oz[k]);
    d1[k] = fabsf(dx[k]) + fabsf(dy[k]) + fabsf(dz[k]);
    best_t[k] = kBig;
    best_b[k] = 0.f;
    best_c[k] = 0.f;
    best_i[k] = -1;
    found[k] = !live;
  }

  const int n_tiles = (m + kTile - 1) / kTile;
  if (n_tiles > 0) stage(tiles[0], pack, 0, min(kTile, m));
  bool warp_done = false;
  for (int i = 0; i < n_tiles; ++i) {
    const int base = i * kTile;
    const int rows = min(kTile, m - base);
    if (i + 1 < n_tiles) {
      stage(tiles[(i + 1) & 1], pack, base + kTile,
            min(kTile, m - base - kTile));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i has landed for every thread's copies

    if (!warp_done) {
      const float* tile = tiles[i & 1];
#pragma unroll 2
      for (int j = 0; j < rows; ++j) {
        const float* q = tile + j * kStride;
        if (q[12] > 0.5f) continue;  // thin glass: the same for the block
        const float4 qn = *reinterpret_cast<const float4*>(q);
        const float4 qb = *reinterpret_cast<const float4*>(q + 4);
        const float4 qg = *reinterpret_cast<const float4*>(q + 8);
        const int id = base + j;
        // The row's share of the slack: kEps of its largest barycentric
        // coefficients.
        const float vmax =
            fmaxf(fmaxf(fmaxf(fabsf(qb.y), fabsf(qb.z)), fabsf(qb.w)),
                  fmaxf(fmaxf(fabsf(qg.y), fabsf(qg.z)), fabsf(qg.w)));
        const float slack_v = kEps * vmax;
        const float slack_0 =
            fmaf(kEps, fmaxf(fabsf(qb.x), fabsf(qg.x)), kSlack);
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          const float rddn = dot3(dx[k], dy[k], dz[k], qn.x, qn.y, qn.z);
          const float rodn =
              __fadd_rn(dot3(ox[k], oy[k], oz[k], qn.x, qn.y, qn.z), qn.w);
          // Prefilter: t by the fast reciprocal, barycentrics from the hit
          // point, every test widened by a slack; a parallel row gives an
          // infinite or NaN t and fails it.
          const float ta = __fdividef(-rodn, rddn);
          const float px = ox[k] + ta * dx[k];
          const float py = oy[k] + ta * dy[k];
          const float pz = oz[k] + ta * dz[k];
          const float ba = qb.x + px * qb.y + py * qb.z + pz * qb.w;
          const float ga = qg.x + px * qg.y + py * qg.z + pz * qg.w;
          const float slack =
              fmaf(slack_v, fmaf(fabsf(ta), d1[k], o1[k]), slack_0);
          const float slack_t = fabsf(ta) * kTSlack;
          const float hi = kAnyHit ? tmax[k] : fminf(tmax[k], best_t[k]);
          bool maybe = ba >= -slack && ga >= -slack &&
                       fmaf(-2.f, slack, ba + ga) <= 1.f &&
                       ta + slack_t > tmin[k] && ta - slack_t < hi;
          if (kAnyHit) maybe = maybe && !found[k];
          if (!maybe) continue;
          // The exact test, as flat_plain computes it.
          const bool safe = fabsf(rddn) > kParallelEps;
          const float t = __fdiv_rn(-rodn, safe ? rddn : 1.f);
          const float beta = bary(qb.x, qb.y, qb.z, qb.w, ox[k], oy[k],
                                  oz[k], dx[k], dy[k], dz[k], t);
          const float gamma = bary(qg.x, qg.y, qg.z, qg.w, ox[k], oy[k],
                                   oz[k], dx[k], dy[k], dz[k], t);
          const bool ok = safe && beta >= 0.f && gamma >= 0.f &&
                          __fadd_rn(beta, gamma) <= 1.f && t > tmin[k] &&
                          t < tmax[k] && id != excl[k];
          if (kAnyHit) {
            if (ok) {  // the first accepted row, as in K1
              best_t[k] = t;
              found[k] = true;
            }
          } else if (ok && t < best_t[k]) {
            // Ids ascend, so a strict < keeps the lowest id on t ties.
            best_t[k] = t;
            best_i[k] = id;
            best_b[k] = beta;
            best_c[k] = gamma;
          }
        }
      }
    }
    if (kAnyHit) {
      bool mine = true;
#pragma unroll
      for (int k = 0; k < kRays; ++k) mine = mine && found[k];
      warp_done = __all_sync(kFull, mine);
      if (__syncthreads_and(mine)) break;  // also frees tile i's buffer
    } else {
      __syncthreads();  // tile i's buffer is restaged at i + 2
    }
  }
  cp_async_wait<0>();  // an any-hit exit may leave a copy in flight

#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = ray0 + k * kThreads;
    if (ray >= r) continue;
    t_out[ray] = best_t[k];
    if (kAnyHit) {
      tri_out[ray] = found[k] ? 0 : -1;
      bb_out[ray] = 0.f;
      bc_out[ray] = 0.f;
    } else {
      tri_out[ray] = best_i[k];
      bb_out[ray] = best_i[k] >= 0 ? best_b[k] : 0.f;
      bc_out[ray] = best_i[k] >= 0 ? best_c[k] : 0.f;
    }
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
  const dim3 grid((r + kRaysPerBlock - 1) / kRaysPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    flat_sweep<true><<<grid, kThreads, 0, s>>>(pack, m, ro, rd, t_min,
                                               t_max, exclude, r, t_out,
                                               tri_out, bb_out, bc_out);
  } else {
    flat_sweep<false><<<grid, kThreads, 0, s>>>(pack, m, ro, rd, t_min,
                                                t_max, exclude, r, t_out,
                                                tri_out, bb_out, bc_out);
  }
  return static_cast<int>(cudaGetLastError());
}
