// The counter-based sampler of rgk_tpu_torch/ops/sampler.py as one kernel a
// call, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: rgk_tpu/ops/sampler.py is plain jnp, which
// XLA fuses into its neighbours on the TPU.  The port's plain version
// (`hash_u32_plain`, `sample_1d_plain`, ...) emulates uint32 on int64: a
// 32x32-bit multiply is two products of 16-bit halves plus masks and
// shifts, a Halton digit four ops.  On the card each of those ops is a
// kernel of its own over the lanes, ~1,100 of them in a queued step of the
// box.  Here one thread per lane computes a whole public call with native
// uint32 arithmetic:
//   hash      hash_u32 over up to kMaxParts parts (murmur3's finalizer
//             after each part), a u32 value in an int64;
//   sample    sample_1d / sample_2d in the five modes: independent, Halton
//             (base 2 by bit reversal, other bases by the digit loop),
//             stratified and LHS (the cycle-walking permutation), VdC.
// Each part of a hash, and the seed, pixel and sample of a sample, is a
// constant or an int64 array read with a stride of 0 (one value
// for every lane) or 1, taken mod 2^32 as `_u32` takes it.
//
// What bounds it on this card: bytes.  Per lane it reads the per-lane parts
// (the int64 pixel and sample, and a per-lane seed: 8 bytes each) and writes
// 4-8 bytes; the arithmetic is a few dozen integer instructions a lane (a
// Halton digit costs a division, and the sample indices are small, so the
// loop stops after a few digits).  At the box's 262,144 lanes that is ~6.3
// MB, ~2 us at 3.35 TB/s.  The design is a flat grid-stride loop, one lane
// a thread, coalesced loads and stores (float2 for sample_2d).
//
// Bits: every output equals the plain version's on the CPU bit for bit.
// The float steps round as PyTorch rounds each of its ops, with no FMA
// contraction: __uint2float_rn, __fmul_rn, __fadd_rn, __fsub_rn and
// __fdiv_rn (nvcc's default -fmad would fuse a multiply and an add).  The
// Halton loop keeps the plain version's float32 sequence: scale =
// f32(scale * inv_base), then result + digit * scale; the plain version
// runs ceil(32 / log2(base)) digits, and the digits past the index's last
// are zeros that add +0, so the loop here stops when the index is 0.  The
// stratified forms divide by n (true division, as the CPU does; the plain
// version on a CUDA tensor multiplies by PyTorch's rounded 1 / n instead,
// which moves the last bit of ~11% of the lanes at n = 9).

#include <cuda_runtime.h>

#include <cstdint>

extern "C" {

// One part of a hash, or the seed, pixel or sample of a sample call.
struct RgkPart {
  const void* ptr;   // null for a constant
  long long stride;  // 0 (one value for every lane) or 1 (a value a lane)
  uint32_t value;    // the constant, mod 2^32
  int kind;          // kConst or kInt64
};

// A sample_1d (comps 1) or sample_2d (comps 2) call: each component's route
// (the mode the plain version takes for its dimension), dimension, and
// Halton base and np.float32(1 / base); kStrat2d computes both components.
struct RgkSampleSpec {
  RgkPart seed, pixel, sample;
  int comps;
  int route[2];
  uint32_t dim[2];
  uint32_t base[2];
  float inv_base[2];
  int n_set;  // samples a stratification set (> 1 on the stratified routes)
  int n2;     // ceil(sqrt(n_set)), kStrat2d
};

}  // extern "C"

namespace {

constexpr int kConst = 0, kInt64 = 1;
constexpr int kIndependent = 0, kHalton = 1, kStrat1d = 2, kVdc = 3,
              kStrat2d = 4;
constexpr int kMaxParts = 8;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;  // the grid strides beyond
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr float kInv24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kInv32 = 2.3283064365386963e-10f;  // 2^-32
// torch.clamp(u, max=1.0 - 1e-7): the double rounded to float32.
constexpr float kClampMax = static_cast<float>(1.0 - 1e-7);

struct HashParts {
  RgkPart p[kMaxParts];
};

__device__ __forceinline__ uint32_t part_at(const RgkPart& p, long long i) {
  if (p.kind == kInt64)
    return static_cast<uint32_t>(
        __ldg(static_cast<const long long*>(p.ptr) + i * p.stride));
  return p.value;
}

// murmur3's finalizer (`_mix`).
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// One part into the running hash (`hash_u32`'s loop body).
__device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t p) {
  return mix(h ^ (p * 0x85EBCA6Bu));
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b,
                                          uint32_t c) {
  return fold(fold(fold(kGolden, a), b), c);
}

__device__ __forceinline__ uint32_t hash4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return fold(hash3(a, b, c), d);
}

// `_u32_to_unit_float`: the top 24 bits, exact.
__device__ __forceinline__ float unit_float(uint32_t u) {
  return __fmul_rn(__uint2float_rn(u >> 8), kInv24);
}

// `_radical_inverse`.
__device__ float radical_inverse(uint32_t idx, uint32_t base, float inv) {
  if (base == 2) return __fmul_rn(__uint2float_rn(__brev(idx)), kInv32);
  float scale = 1.0f, result = 0.0f;
  while (idx != 0) {
    const uint32_t q = idx / base;
    const uint32_t digit = idx - q * base;
    idx = q;
    scale = __fmul_rn(scale, inv);
    result = __fadd_rn(result, __fmul_rn(__uint2float_rn(digit), scale));
  }
  return result;
}

// `_permute` for n > 1: Kensler's cycle walk, six rounds.
__device__ uint32_t permute(uint32_t idx, uint32_t n, uint32_t key) {
  const int w = 32 - __clz(n - 1u);
  const uint32_t mask = w >= 32 ? 0xFFFFFFFFu : (1u << w) - 1u;
  const int s1 = max(1, w / 2), s2 = max(1, (w + 1) / 2);
  uint32_t x = idx & mask;
#pragma unroll
  for (uint32_t i = 0; i < 6; ++i) {
    const uint32_t k = mix(key ^ (kGolden + i));
    uint32_t c = x ^ k;
    c = (c * 0xE170893Du) & mask;
    c ^= c >> s1;
    c = (c * 0x929E3149u) & mask;
    c ^= c >> s2;
    if (x >= n) x = c & mask;
  }
  return x % n;
}

__device__ __forceinline__ float wrap01(float u) {
  return __fsub_rn(u, floorf(u));
}

// One component of sample_1d / sample_2d (every route but kStrat2d),
// clamped as sample_1d clamps.
__device__ float component(const RgkSampleSpec& s, int c, uint32_t seed,
                           uint32_t pix, uint32_t smp) {
  const uint32_t dim = s.dim[c];
  float u;
  switch (s.route[c]) {
    case kHalton:
      // Cranley-Patterson rotation by hash01(pixel, dim, seed).
      u = wrap01(__fadd_rn(radical_inverse(smp, s.base[c], s.inv_base[c]),
                           unit_float(hash3(pix, dim, seed))));
      break;
    case kStrat1d: {
      const uint32_t n = static_cast<uint32_t>(s.n_set);
      const uint32_t stratum =
          permute(smp % n, n, hash4(pix, dim, seed, smp / n));
      const float jit = unit_float(hash4(pix, smp, dim, seed));
      u = __fdiv_rn(__fadd_rn(__uint2float_rn(stratum), jit),
                    __uint2float_rn(n));
      break;
    }
    case kVdc:
      u = wrap01(__fadd_rn(
          radical_inverse(smp ^ hash3(pix, dim, seed), 2, 0.0f),
          unit_float(hash3(pix, dim + 97u, seed))));
      break;
    default:
      u = unit_float(hash4(pix, smp, dim, seed));
  }
  return fminf(u, kClampMax);
}

// `_stratified_2d`: one stratum of an n2 x n2 grid, jittered; not clamped.
__device__ float2 stratified_2d(const RgkSampleSpec& s, uint32_t seed,
                                uint32_t pix, uint32_t smp) {
  const uint32_t n = static_cast<uint32_t>(s.n_set);
  const uint32_t n2 = static_cast<uint32_t>(s.n2);
  const uint32_t dim = s.dim[0];
  const uint32_t stratum =
      permute(smp % n, n2 * n2, hash4(pix, dim, seed, smp / n));
  const float jx = unit_float(hash4(pix, smp, dim, seed));
  const float jy = unit_float(hash4(pix, smp, dim + 1u, seed));
  const float fn2 = __uint2float_rn(n2);
  return make_float2(
      __fdiv_rn(__fadd_rn(__uint2float_rn(stratum % n2), jx), fn2),
      __fdiv_rn(__fadd_rn(__uint2float_rn(stratum / n2), jy), fn2));
}

__global__ void __launch_bounds__(kThreads)
hash_lanes(HashParts parts, int n_parts, long long n,
           long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    uint32_t h = kGolden;
#pragma unroll
    for (int j = 0; j < kMaxParts; ++j)
      if (j < n_parts) h = fold(h, part_at(parts.p[j], i));
    out[i] = static_cast<long long>(h);
  }
}

__global__ void __launch_bounds__(kThreads)
sample_lanes(RgkSampleSpec s, long long n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t seed = part_at(s.seed, i);
    const uint32_t pix = part_at(s.pixel, i);
    const uint32_t smp = part_at(s.sample, i);
    if (s.route[0] == kStrat2d) {
      reinterpret_cast<float2*>(out)[i] = stratified_2d(s, seed, pix, smp);
    } else if (s.comps == 1) {
      out[i] = component(s, 0, seed, pix, smp);
    } else {
      reinterpret_cast<float2*>(out)[i] =
          make_float2(component(s, 0, seed, pix, smp),
                      component(s, 1, seed, pix, smp));
    }
  }
}

unsigned grid(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool part_ok(const RgkPart& p) {
  if (p.kind == kConst) return true;
  return p.kind == kInt64 && p.ptr != nullptr &&
         (p.stride == 0 || p.stride == 1);
}

}  // namespace

extern "C" {

// Launches hash_u32 of `n_parts` parts (at most kMaxParts = 8) over `n`
// lanes on `stream`; writes u32 values to the int64 `out` [n].  Returns
// cudaGetLastError() as an int.
int rgk_sampler_hash(const RgkPart* parts, int n_parts, long long n,
                     long long* out, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  HashParts hp = {};
  for (int j = 0; j < n_parts; ++j) {
    if (!part_ok(parts[j])) return static_cast<int>(cudaErrorInvalidValue);
    hp.p[j] = parts[j];
  }
  if (n == 0) return 0;
  hash_lanes<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hp, n_parts, n, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches sample_1d / sample_2d over `n` lanes on `stream`; writes f32
// `out` [n] or [n, 2].  Returns cudaGetLastError() as an int.
int rgk_sampler_sample(const RgkSampleSpec* spec, long long n, float* out,
                       void* stream) {
  const RgkSampleSpec& s = *spec;
  if (n < 0 || (s.comps != 1 && s.comps != 2) || !part_ok(s.seed) ||
      !part_ok(s.pixel) || !part_ok(s.sample))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < s.comps; ++c) {
    const int r = s.route[c];
    if (r < kIndependent || r > kStrat2d ||
        (r == kHalton && s.base[c] < 2) ||
        ((r == kStrat1d || r == kStrat2d) && s.n_set < 2))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s.route[0] == kStrat2d && (s.comps != 2 || s.n2 < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  sample_lanes<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
