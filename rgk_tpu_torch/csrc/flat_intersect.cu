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
//   with t the lowest accepted id's.
// A ray whose window is empty (not t_min < t_max) accepts no row and gets
// the no-hit record (t 3.4e38, tri -1, bary 0).
//
// What bounds it on this card: FP32 work, (live rays) x M ray-row tests.
// The least work that decides a row is the hit-point form, 31 flops (rd.n
// 5, ro.n + d 6, t 1, hit point 6, beta 6, gamma 6, sum 1), so at 67
// TFLOP/s a query of 262,144 live rays x 3,870 rows needs 0.47 ms; its
// bytes (rays, outputs, a 200 KB pack read from L2 by each block) take
// ~4 us.  The schedulers' instruction slots, not the FP32 lanes, are the
// real ceiling: the test as written is ~45 instructions with its IEEE
// division.
//
// A query is three kernels (and a memset of its counters), with grids
// fixed by R alone, so that one captured graph serves any live count:
// 1. flat_sweep_front lists the rays with a non-empty window (a block
//    scan, one atomic a block: ascending within a block) and the count,
//    and writes the no-hit record of every other ray.  The path tracer's
//    dead lanes and inactive shadow rays cost a flag read here and
//    nothing in the sweep.
// 2. flat_sweep: a block for each tile of 512 rays R could list, and at
//    least one wave of the card (every SM full).  A block takes one work
//    item, 512 listed rays x a slice of the rows, or leaves at once.  The
//    rows are cut into as many slices as the grid holds items (at least
//    kMinSliceRows each), a choice made on the device from the count
//    alone: a fully live query runs one slice, the register-blocked
//    sweep below, and writes its records; a thin one (the straggler tail
//    of the queued loop) spreads its few rays over all SMs.  A sliced
//    item folds each ray's winner into a 64-bit atomicMin on an
//    order-preserving key: (t, then id), K1's tie rule, for a closest
//    hit; the id for any hit, the row that K1's ascending sweep accepts
//    first.  (Persistent blocks that pull items from a device counter
//    measured slower at 2^20 rays: their loop's registers cost the SM a
//    block; PERF.md.)
// 3. flat_sweep_finish (sliced queries only) recomputes the winner's t and
//    barycentrics with the exact test's own expressions, so the record is
//    the one-slice sweep's bit for bit.
//
// The sweep spends as few instructions a test as it can:
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
// * a warp whose rays are all done (any hit) or that holds no listed ray
//   skips the sweep (__all_sync); an any-hit block leaves the slice when
//   all its warps are done.
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
// exits, a block vote and a persistent work queue, not an elementwise pass.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;              // threads per sweep block
constexpr int kRays = 4;                   // rays per thread
constexpr int kRaysPerBlock = kThreads * kRays;
constexpr int kTile = 128;                 // triangle rows staged per tile
constexpr int kCols = 13;                  // Badouel row + thin-glass flag
constexpr int kStride = 16;                // staged words per row
constexpr int kMinSliceRows = 64;          // the thinnest row slice
constexpr int kFrontThreads = 256;
constexpr int kFinishThreads = 128;
constexpr int kMaxDevices = 64;
constexpr float kBig = 3.4e38f;            // "no hit" t, as in K1
constexpr float kParallelEps = 1e-9f;
constexpr unsigned long long kNoKey = ~0ull;
// The prefilter's slack (header note): a barycentric floor, a share of the
// magnitudes summed (2^-18, 64 float32 half-epsilons), and a relative one
// on t.
constexpr float kSlack = 1e-3f;
constexpr float kEps = 3.814697265625e-6f;
constexpr float kTSlack = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

// A query's scratch (ops/flat_intersect.py scratch_bytes keeps the same
// layout): keys u64 [r] by list position, list i32 [r], then the counters
// ctrl i32 [2]: rays listed, row slices.
struct Scratch {
  unsigned long long* keys;
  int* list;
  int* ctrl;
};

Scratch carve(void* scratch, int r) {
  Scratch s;
  s.keys = static_cast<unsigned long long*>(scratch);
  s.list = reinterpret_cast<int*>(s.keys + r);
  s.ctrl = s.list + r;
  return s;
}

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

// The exact test's t from rd.n and ro.n + d, and whether rd.n is safe.
__device__ __forceinline__ float exact_t(float rddn, float rodn, bool* safe) {
  *safe = fabsf(rddn) > kParallelEps;
  return __fdiv_rn(-rodn, *safe ? rddn : 1.f);
}

// A closest hit's key: t's bits made order-preserving (a +0 for -0, which
// compares equal in the sweep), then the id, so min is (min t, min id).
__device__ __forceinline__ unsigned long long closest_key(float t, int id) {
  const unsigned u = __float_as_uint(__fadd_rn(t, 0.f));
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(k) << 32) |
         static_cast<unsigned>(id);
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

// Row slices for `tiles` tiles of listed rays on a grid of `blocks`, one
// item a block: as many as the grid holds, each of at least kMinSliceRows
// rows.
__device__ __forceinline__ int row_slices(int tiles, int blocks, int m) {
  if (tiles <= 0) return 1;
  return max(1, min(blocks / tiles, m / kMinSliceRows));
}

__global__ void __launch_bounds__(kFrontThreads)
flat_sweep_front(const float* __restrict__ t_min,
                 const float* __restrict__ t_max, int r, int key_rays,
                 int* __restrict__ list, unsigned long long* __restrict__ keys,
                 int* __restrict__ ctrl, unsigned long long* swept,
                 float* __restrict__ t_out, int* __restrict__ tri_out,
                 float* __restrict__ bb_out, float* __restrict__ bc_out) {
  __shared__ int warp_base[kFrontThreads / 32];
  __shared__ int block_base;
  const int i = blockIdx.x * kFrontThreads + threadIdx.x;
  bool live = false;
  if (i < r) {
    live = t_max[i] > t_min[i];  // false for a NaN bound, as in the test
    if (!live) {
      t_out[i] = kBig;
      tri_out[i] = -1;
      bb_out[i] = 0.f;
      bc_out[i] = 0.f;
    }
  }
  const unsigned ballot = __ballot_sync(kFull, live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kFrontThreads / 32; ++w) {
      const int c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    block_base = total > 0 ? atomicAdd(&ctrl[0], total) : 0;
    if (total > 0 && swept != nullptr)
      atomicAdd(swept, static_cast<unsigned long long>(total));
  }
  __syncthreads();
  if (live) {
    const int p = block_base + warp_base[warp] +
                  __popc(ballot & ((1u << lane) - 1u));
    list[p] = i;
    if (p < key_rays) keys[p] = kNoKey;
  }
}

// One work item: listed rays [p_base, p_base + 512) of the n listed, over
// rows [row0, row1); thread t takes p_base + t + 128 k, so a warp's rays
// of one k are 32 neighbours (K1's coherence).  `sliced`: fold winners
// into `keys`, else write the records.
template <bool kAnyHit>
__device__ __forceinline__ void sweep_item(
    float (*tiles)[kTile * kStride], const float* __restrict__ pack,
    int row0, int row1, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ t_min,
    const float* __restrict__ t_max, const int* __restrict__ exclude,
    const int* __restrict__ list, unsigned long long* keys, int n,
    int p_base, bool sliced, float* __restrict__ t_out,
    int* __restrict__ tri_out, float* __restrict__ bb_out,
    float* __restrict__ bc_out) {
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tmin[kRays], tmax[kRays], best_t[kRays], best_b[kRays],
      best_c[kRays], o1[kRays], d1[kRays];
  int excl[kRays], best_i[kRays];
  bool found[kRays];
  const int p0 = p_base + threadIdx.x;
  bool none = true;
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int p = p0 + k * kThreads;
    const bool live = p < n;  // an unlisted slot has an empty window
    const int ray = live ? list[p] : 0;
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
    none = none && !live;
  }

  const int n_tiles = (row1 - row0 + kTile - 1) / kTile;
  if (n_tiles > 0) stage(tiles[0], pack, row0, min(kTile, row1 - row0));
  bool warp_done = __all_sync(kFull, none);
  for (int i = 0; i < n_tiles; ++i) {
    const int base = row0 + i * kTile;
    const int rows = min(kTile, row1 - base);
    if (i + 1 < n_tiles) {
      stage(tiles[(i + 1) & 1], pack, base + kTile,
            min(kTile, row1 - base - kTile));
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
          bool safe;
          const float t = exact_t(rddn, rodn, &safe);
          const float beta = bary(qb.x, qb.y, qb.z, qb.w, ox[k], oy[k],
                                  oz[k], dx[k], dy[k], dz[k], t);
          const float gamma = bary(qg.x, qg.y, qg.z, qg.w, ox[k], oy[k],
                                   oz[k], dx[k], dy[k], dz[k], t);
          const bool ok = safe && beta >= 0.f && gamma >= 0.f &&
                          __fadd_rn(beta, gamma) <= 1.f && t > tmin[k] &&
                          t < tmax[k] && id != excl[k];
          if (kAnyHit) {
            if (ok) {  // the lowest accepted id of the slice
              best_t[k] = t;
              best_i[k] = id;
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
    const int p = p0 + k * kThreads;
    if (p >= n) continue;
    if (sliced) {
      if (best_i[k] >= 0)
        atomicMin(&keys[p],
                  kAnyHit ? static_cast<unsigned long long>(best_i[k])
                          : closest_key(best_t[k], best_i[k]));
      continue;
    }
    const int ray = list[p];
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

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
flat_sweep(const float* __restrict__ pack, int m,
           const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const int* __restrict__ exclude, const int* __restrict__ list,
           unsigned long long* keys, int* ctrl, float* __restrict__ t_out,
           int* __restrict__ tri_out, float* __restrict__ bb_out,
           float* __restrict__ bc_out) {
  __shared__ __align__(16) float tiles[2][kTile * kStride];
  const int n = ctrl[0];
  const int ray_tiles = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  const int slices = row_slices(ray_tiles, gridDim.x, m);
  if (blockIdx.x == 0 && threadIdx.x == 0) ctrl[1] = slices;
  // ray_tiles x slices <= gridDim.x (the grid covers every tile, and the
  // slices are cut to fit it): a block takes one item or leaves at once.
  if (blockIdx.x >= ray_tiles * slices) return;
  const int slice = blockIdx.x / ray_tiles;
  sweep_item<kAnyHit>(tiles, pack, slice * m / slices,
                      (slice + 1) * m / slices, ro, rd, t_min, t_max, exclude,
                      list, keys, n,
                      (blockIdx.x - slice * ray_tiles) * kRaysPerBlock,
                      slices > 1, t_out, tri_out, bb_out, bc_out);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kFinishThreads)
flat_sweep_finish(const float* __restrict__ pack,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  const int* __restrict__ list,
                  const unsigned long long* __restrict__ keys,
                  const int* __restrict__ ctrl, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ bb_out,
                  float* __restrict__ bc_out) {
  if (ctrl[1] <= 1) return;  // one slice: the sweep wrote the records
  const int n = ctrl[0];
  for (int p = blockIdx.x * kFinishThreads + threadIdx.x; p < n;
       p += gridDim.x * kFinishThreads) {
    const int ray = list[p];
    const unsigned long long key = keys[p];
    if (key == kNoKey) {
      t_out[ray] = kBig;
      tri_out[ray] = -1;
      bb_out[ray] = 0.f;
      bc_out[ray] = 0.f;
      continue;
    }
    const int id = static_cast<int>(key & 0xffffffffu);
    const float* q = pack + static_cast<long long>(id) * kCols;
    const float ox = ro[3 * ray], oy = ro[3 * ray + 1], oz = ro[3 * ray + 2];
    const float dx = rd[3 * ray], dy = rd[3 * ray + 1], dz = rd[3 * ray + 2];
    bool safe;
    const float t = exact_t(dot3(dx, dy, dz, q[0], q[1], q[2]),
                            __fadd_rn(dot3(ox, oy, oz, q[0], q[1], q[2]),
                                      q[3]),
                            &safe);
    t_out[ray] = t;
    if (kAnyHit) {
      tri_out[ray] = 0;
      bb_out[ray] = 0.f;
      bc_out[ray] = 0.f;
    } else {
      tri_out[ray] = id;
      bb_out[ray] = bary(q[4], q[5], q[6], q[7], ox, oy, oz, dx, dy, dz, t);
      bc_out[ray] =
          bary(q[8], q[9], q[10], q[11], ox, oy, oz, dx, dy, dz, t);
    }
  }
}

// The sweep's grid: a block for each tile of 512 of the r rays, and at
// least one wave of the card (resident blocks on every SM, found once per
// device and variant) where the rows can be sliced that far.
cudaError_t sweep_grid(bool any_hit, int r, int m, int* grid) {
  static std::atomic<int> wave[2][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int g = dev < kMaxDevices ? wave[any_hit][dev].load() : 0;
  if (g == 0) {
    int per_sm = 0, sms = 0;
    err = any_hit ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, flat_sweep<true>, kThreads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, flat_sweep<false>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g = per_sm * sms > 0 ? per_sm * sms : 1;
    if (dev < kMaxDevices) wave[any_hit][dev].store(g);
  }
  const int tiles = (r + kRaysPerBlock - 1) / kRaysPerBlock;
  const long long most = static_cast<long long>(tiles) *
                         (m / kMinSliceRows > 1 ? m / kMinSliceRows : 1);
  const int want = static_cast<int>(most < g ? most : g);
  *grid = want > tiles ? want : tiles;
  return cudaSuccess;
}

}  // namespace

// Launches a query on `stream` and returns the first CUDA error as an int
// (0 = launched).  All pointers are device pointers to contiguous arrays:
// pack [m, 13] f32; ro, rd [r, 3] f32; t_min, t_max [r] f32; exclude [r]
// i32; outputs t [r] f32, tri [r] i32, bary_b, bary_c [r] f32; scratch of
// 12 r + 8 bytes, 8-byte aligned (layout at `Scratch`); swept, if not
// null, one int64 to which the query adds the rays it listed.
extern "C" int rgk_flat_intersect(const float* pack, int m, const float* ro,
                                  const float* rd, const float* t_min,
                                  const float* t_max, const int* exclude,
                                  int r, float* t_out, int* tri_out,
                                  float* bb_out, float* bc_out, int any_hit,
                                  void* scratch, long long* swept,
                                  void* stream) {
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(scratch, r);
  int grid = 0;
  cudaError_t err = sweep_grid(any_hit != 0, r, m, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(sc.ctrl, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Only a query of at most grid / 2 tiles of rays is sliced: the keys
  // and the finishing pass need no more.
  const int key_rays = (grid / 2) * kRaysPerBlock < r
                           ? (grid / 2) * kRaysPerBlock
                           : r;
  flat_sweep_front<<<(r + kFrontThreads - 1) / kFrontThreads, kFrontThreads,
                     0, s>>>(t_min, t_max, r, key_rays, sc.list, sc.keys,
                             sc.ctrl,
                             reinterpret_cast<unsigned long long*>(swept),
                             t_out, tri_out, bb_out, bc_out);
  const int finish = key_rays > 0
                         ? (key_rays + kFinishThreads - 1) / kFinishThreads
                         : 1;
  if (any_hit) {
    flat_sweep<true><<<grid, kThreads, 0, s>>>(
        pack, m, ro, rd, t_min, t_max, exclude, sc.list, sc.keys, sc.ctrl,
        t_out, tri_out, bb_out, bc_out);
    flat_sweep_finish<true><<<finish, kFinishThreads, 0, s>>>(
        pack, ro, rd, sc.list, sc.keys, sc.ctrl, t_out, tri_out, bb_out,
        bc_out);
  } else {
    flat_sweep<false><<<grid, kThreads, 0, s>>>(
        pack, m, ro, rd, t_min, t_max, exclude, sc.list, sc.keys, sc.ctrl,
        t_out, tri_out, bb_out, bc_out);
    flat_sweep_finish<false><<<finish, kFinishThreads, 0, s>>>(
        pack, ro, rd, sc.list, sc.keys, sc.ctrl, t_out, tri_out, bb_out,
        bc_out);
  }
  return static_cast<int>(cudaGetLastError());
}
