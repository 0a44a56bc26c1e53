// The BxDF layer of rgk_tpu_torch/ops/bxdf.py (and the LTC functions of
// ops/ltc.py it calls) as one kernel a call, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: rgk_tpu/ops/bxdf.py is plain jnp that
// evaluates every lobe for every lane and selects with `where`, which XLA
// fuses into one pass on the TPU.  The port's plain version
// (`eval_bxdf_plain`, `sample_bxdf_plain`) does the same in PyTorch, where
// each `where`, product and clamp is a kernel of its own over all the
// lanes: ~110-260 of them an eval and ~180-260 a sample.  Here one thread
// a lane computes the lane's own lobe alone, chosen by its `bxdf_type`:
// diffuse, mirror, transparent, dielectric (Fresnel, total internal
// reflection), LTC-Beckmann, LTC-GGX and the two LTC+diffuse types, and
// the one-level mix (an eval blends the two sub-materials; a sample picks
// one by `decide_and_rescale`, the reference's sample reuse).  The LTC
// lobes fetch the bilinear [8192, 10] table rows, invert the 3x3 matrix
// by its adjugate and build the scaled frame, as ops/ltc.py does.
//
// Four entries, one launch each:
//   eval        f(vi, vr)                         -> f [n, 3]
//   sample      (dir, throughput, leak)(vi, u2)   -> [n, 3], [n, 3], [n]
//   eval_bwd    the gradients of an eval's diffuse, specular, roughness
//               (of each material slot) and of vi and vr, from df
//   sample_bwd  the same of a sample (vi alone), from ddir and dthr
// The backward entries recompute the lobe from the saved inputs and keep
// no intermediate.  Where the plain version's autograd is non-finite only
// because a lobe that its `where` discarded multiplied a zero by an
// infinity, they return the selected lobe's gradient.
//
// Inputs are per-lane fields: a pointer and the elements between lanes (a
// lane's components adjacent), so the material pack's columns are read in
// place; the type is the pack's float column, converted as `.to(int32)`
// converts it.  Material slot 0 is the lane's material; on a scene with
// mixes (template argument kMix) slots 1 and 2 hold its sub-materials'
// fields.  kLtc (the scene has an LTC material) reads the LTC rows.
//
// Bits: the forward equals the plain version run on the card bit for bit.
// Every float step rounds as the PyTorch CUDA kernel of that op rounds it,
// with no FMA contraction (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn; nvcc's default -fmad would fuse a product and a sum), and the
// same libm calls (sinf, cosf, acosf, floorf).  A division by a Python
// scalar runs on the card as a product with the float reciprocal of the
// scalar (PyTorch's div_true with a CPU scalar), so `x / PI` is
// x * (1.0f / float(PI)) here.  `1.0 / t` is PyTorch's reciprocal, a
// rounded division.  `torch.sum(x, dim=-1)` over three components is
// PyTorch's reduction with two threads an output: (x0 + x2) + x1, a zero
// sum read as +0 (`sum3`).  Clamps keep a NaN, as PyTorch's do.
//
// What bounds it on this card: bytes.  A lane reads its fields (the pack's
// columns, 8-12 floats a material slot, vi, vr or u2) and writes 3-7 values;
// an LTC lane reads 4 table rows of 40 bytes, which stay in L2 (328 KB).  At
// the box's 262,144 lanes that is ~25 MB an eval, ~8 us at 3.35 TB/s.  The
// design is a flat grid-stride loop, one lane a thread.

#include <cuda_runtime.h>

#include <cstdint>

extern "C" {

// One per-lane field: `stride` elements between lanes; null when absent.
struct RgkBxdfField {
  const float* ptr;
  long long stride;
};

// A material slot's fields: diffuse [3], specular [3], roughness, ior,
// mix amount and the type (the pack's float column).
struct RgkBxdfMat {
  RgkBxdfField diffuse, specular, rough, ior, mix, type;
};

// One call.  Forward outputs and backward inputs and outputs are
// contiguous; a null gradient output is not wanted, a null gradient input
// reads as zeros.
struct RgkBxdfArgs {
  RgkBxdfMat mat[3];
  RgkBxdfField vi, vr, u2;
  const float* ltc_rows;  // [2 * 64 * 64, 10]
  long long n;
  int has_mix, has_ltc;
  float* f;              // eval [n, 3]
  float* dir;            // sample [n, 3]
  float* thr;            // sample [n, 3]
  unsigned char* leak;   // sample [n] (torch.bool)
  const float* g_f;      // eval_bwd [n, 3]
  const float* g_dir;    // sample_bwd [n, 3]
  const float* g_thr;    // sample_bwd [n, 3]
  float* g_diffuse[3];   // [n, 3] a slot
  float* g_specular[3];  // [n, 3] a slot
  float* g_rough[3];     // [n] a slot
  float* g_vi;           // [n, 3]
  float* g_vr;           // [n, 3]
};

static_assert(sizeof(RgkBxdfArgs) == 504, "ops/bxdf.py _Args");

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;  // the grid strides beyond

// scene/arrays.py BSDF_*
constexpr int kDiffuse = 0, kMirror = 1, kTransparent = 2, kDielectric = 3,
              kLtcBeckmann = 4, kLtcGgx = 5, kLtcBeckmannDiffuse = 6,
              kLtcGgxDiffuse = 7, kMix = 8;

// The Python scalars of ops/bxdf.py, ops/ltc.py and ops/warps.py as the
// card's kernels take them: float, or the float reciprocal of a divisor.
constexpr float kInvPi = 1.0f / static_cast<float>(3.14159265358979);
constexpr float kInvPiLtc = 1.0f / static_cast<float>(3.14159);
constexpr float kInvHalfPi = 1.0f / static_cast<float>(0.5 * 3.14159);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kQuarterPi = static_cast<float>(3.14159265358979323846 / 4.0);
constexpr float kAcosLo = static_cast<float>(-1.0 + 1e-6);
constexpr float kAcosHi = static_cast<float>(1.0 - 1e-6);
constexpr float kOneMinus = static_cast<float>(1.0 - 1e-7);
constexpr float kClampAt = static_cast<float>(0.999);
constexpr int kSize = 64;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
// `1.0 / t`: PyTorch's reciprocal (a rounded division), times 1.0.
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }
// torch.clamp with a NaN kept.
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// A sum that autograd or a reduction adds a zero to: -0 reads as +0.
__device__ __forceinline__ float canon(float x) { return __fadd_rn(x, 0.0f); }
// torch.sum(dim=-1) over three components (file comment).
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return canon(add(add(a, c), b));
}

// torch.sum over ten components, as autograd reduces a weight's gradient
// over a table row: eight threads an output, the first two adding
// components 8 and 9, then a tree.
__device__ __forceinline__ float sum10(const float* x) {
  float v0 = add(x[0], x[8]), v1 = add(x[1], x[9]);
  return canon(add(add(add(v0, v1), add(x[2], x[3])),
                   add(add(x[4], x[5]), add(x[6], x[7]))));
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return sum3(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z));
}

__device__ __forceinline__ V3 load3(const RgkBxdfField& f, long long i) {
  const float* p = f.ptr + i * f.stride;
  return {p[0], p[1], p[2]};
}

__device__ __forceinline__ float load1(const RgkBxdfField& f, long long i) {
  return f.ptr[i * f.stride];
}

__device__ __forceinline__ void store3(float* out, long long i, V3 v) {
  out[3 * i] = v.x;
  out[3 * i + 1] = v.y;
  out[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 load_out3(const float* g, long long i) {
  if (g == nullptr) return {0.0f, 0.0f, 0.0f};
  return {g[3 * i], g[3 * i + 1], g[3 * i + 2]};
}

struct Mat {
  V3 d, s;
  float rough, ior, mix;
  int type;
};

__device__ __forceinline__ Mat load_mat(const RgkBxdfMat& m, long long i) {
  Mat p;
  p.d = load3(m.diffuse, i);
  p.s = load3(m.specular, i);
  p.rough = load1(m.rough, i);
  p.ior = load1(m.ior, i);
  p.mix = m.mix.ptr != nullptr ? load1(m.mix, i) : 0.0f;
  p.type = static_cast<int>(load1(m.type, i));
  return p;
}

__device__ __forceinline__ bool is_ltcd(int t) {
  return t == kLtcBeckmannDiffuse || t == kLtcGgxDiffuse;
}
__device__ __forceinline__ int ltc_kind(int t) {
  return (t == kLtcGgx || t == kLtcGgxDiffuse) ? 1 : 0;
}

__device__ __forceinline__ void acc(V3& a, V3 b) {
  a.x = add(a.x, b.x);
  a.y = add(a.y, b.y);
  a.z = add(a.z, b.z);
}

__device__ __forceinline__ V3 scale(V3 v, float k) {
  return {mul(v.x, k), mul(v.y, k), mul(v.z, k)};
}

// ---------------------------------------------------------------- helpers

// vm.safe_normalize, and its backward (from the gradient of the output to
// that of v; the fallback +Z gets none).
__device__ V3 safe_normalize(V3 v) {
  float l2 = dot3(v, v);
  if (!(l2 > 1e-24f)) return {0.0f, 0.0f, 1.0f};
  float inv = rcp(sqrt_(clamp_lo(l2, 1e-24f)));
  return scale(v, inv);
}

// warps.to_hemisphere_cosine_z, with the intermediates its backward uses.
struct Hemi {
  float r, sn, cs, px, py, w, z;
};

__device__ Hemi hemi(float u0, float u1) {
  Hemi h;
  h.r = u0 > 0.0f ? sqrt_(u0) : u0;
  float a = mul(u1, kTwoPi);
  h.sn = sinf(a);
  h.cs = cosf(a);
  h.px = mul(h.r, h.sn);
  h.py = mul(h.r, h.cs);
  h.w = sub(sub(1.0f, mul(h.px, h.px)), mul(h.py, h.py));
  h.z = sqrt_(clamp_lo(h.w, 1e-5f));
  return h;
}

// warps.decide_and_rescale.
__device__ __forceinline__ bool decide(float u, float p, float* rescaled) {
  bool take = u < p;
  float dt = clamp_lo(p, 1e-12f);
  float df = clamp_lo(sub(1.0f, p), 1e-12f);
  float r = take ? dvd(u, dt) : dvd(sub(u, p), df);
  *rescaled = clamp2(r, 0.0f, kOneMinus);
  take = take && !(p <= 0.0f);
  return take || (p >= 1.0f);
}

// ---------------------------------------------------------------- Fresnel

struct Fresnel {
  float eta, c, st2, cl, ct_raw, num_s, den_s, rs, num_p, den_p, rp, r, ct;
  bool tir;
};

// _fresnel_dielectric(eta, cos_theta): reflectance `r` and cos_theta_trans
// `ct`, with what the backward reads.
__device__ Fresnel fresnel(float eta, float cos_theta) {
  Fresnel f;
  f.eta = cos_theta < 0.0f ? rcp(eta) : eta;
  f.c = fabsf(cos_theta);
  f.st2 = mul(mul(f.eta, f.eta), sub(1.0f, mul(f.c, f.c)));
  f.tir = f.st2 > 1.0f;
  f.cl = clamp_lo(sub(1.0f, f.st2), 1e-12f);
  f.ct_raw = sqrt_(f.cl);
  f.num_s = sub(mul(f.eta, f.c), f.ct_raw);
  f.den_s = clamp_lo(add(mul(f.eta, f.c), f.ct_raw), 1e-12f);
  f.rs = dvd(f.num_s, f.den_s);
  f.num_p = sub(mul(f.eta, f.ct_raw), f.c);
  f.den_p = clamp_lo(add(mul(f.eta, f.ct_raw), f.c), 1e-12f);
  f.rp = dvd(f.num_p, f.den_p);
  float r = mul(0.5f, add(mul(f.rs, f.rs), mul(f.rp, f.rp)));
  f.r = f.tir ? 1.0f : r;
  f.ct = f.tir ? 0.0f : f.ct_raw;
  return f;
}

// ---------------------------------------------------------------- LTC

// ltc.fetch_bilinear: M (row-major) and the amplitude, with what the
// backward reads.
struct Fetch {
  float t_pre, t_mid, alpha, a_sq, a_mid, dt1, da1;
  int base;
  float m[9], amp;
};

__device__ Fetch fetch(const float* rows, int kind, float theta, float alpha) {
  Fetch f;
  f.t_pre = mul(theta, kInvHalfPi);
  f.t_mid = clamp2(f.t_pre, 0.0f, 1.0f);
  f.alpha = alpha;
  f.a_sq = sqrt_(clamp_lo(alpha, 0.0f));
  f.a_mid = clamp2(f.a_sq, 0.0f, 1.0f);
  float t = clamp_hi(f.t_mid, kClampAt);
  float a = clamp_hi(f.a_mid, kClampAt);
  float ts = mul(t, 63.0f);
  float as = mul(a, 63.0f);
  int t1 = static_cast<int>(floorf(ts));
  int a1 = static_cast<int>(floorf(as));
  f.dt1 = sub(ts, static_cast<float>(t1));
  float dt2 = sub(1.0f, f.dt1);
  f.da1 = sub(as, static_cast<float>(a1));
  float da2 = sub(1.0f, f.da1);
  f.base = kind * (kSize * kSize) + t1 * kSize + a1;
  const float* r11 = rows + 10LL * f.base;
  const float* r12 = r11 + 10;
  const float* r21 = r11 + 10 * kSize;
  const float* r22 = r21 + 10;
  float w11 = mul(dt2, da2), w12 = mul(dt2, f.da1);
  float w21 = mul(f.dt1, da2), w22 = mul(f.dt1, f.da1);
  float b[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    b[k] = add(add(add(mul(r11[k], w11), mul(r12[k], w12)), mul(r21[k], w21)),
               mul(r22[k], w22));
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) f.m[k] = b[k];
  f.amp = b[9];
  return f;
}

__device__ __forceinline__ float det3(const float* m) {
  return add(sub(mul(m[0], sub(mul(m[4], m[8]), mul(m[5], m[7]))),
                 mul(m[1], sub(mul(m[3], m[8]), mul(m[5], m[6])))),
             mul(m[2], sub(mul(m[3], m[7]), mul(m[4], m[6]))));
}

__device__ __forceinline__ void cofactors(const float* m, float* c) {
  c[0] = sub(mul(m[4], m[8]), mul(m[5], m[7]));
  c[1] = sub(mul(m[2], m[7]), mul(m[1], m[8]));
  c[2] = sub(mul(m[1], m[5]), mul(m[2], m[4]));
  c[3] = sub(mul(m[5], m[6]), mul(m[3], m[8]));
  c[4] = sub(mul(m[0], m[8]), mul(m[2], m[6]));
  c[5] = sub(mul(m[2], m[3]), mul(m[0], m[5]));
  c[6] = sub(mul(m[3], m[7]), mul(m[4], m[6]));
  c[7] = sub(mul(m[1], m[6]), mul(m[0], m[7]));
  c[8] = sub(mul(m[0], m[4]), mul(m[1], m[3]));
}

// ltc._matvec: (M0 v0 + M1 v1) + M2 v2 a row.
__device__ __forceinline__ V3 matvec(const float* m, V3 v) {
  return {add(add(mul(m[0], v.x), mul(m[1], v.y)), mul(m[2], v.z)),
          add(add(mul(m[3], v.x), mul(m[4], v.y)), mul(m[5], v.z)),
          add(add(mul(m[6], v.x), mul(m[7], v.y)), mul(m[8], v.z))};
}

__device__ __forceinline__ float safe_acos(float z) {
  return acosf(clamp2(z, kAcosLo, kAcosHi));
}

// The LTC pdf's pieces from the frame vector to the value (ltc.pdf).
struct Pdf {
  Fetch ft;
  float s2raw, s2, nx, ny;
  V3 r3;
  float det, dsel, inv_det, cof[9], inv[9];
  V3 q, p, L;
  float l2, sl, l3, cl3, jac, jsel, pz0, D, num, val;
};

__device__ void ltc_pdf(const float* rows, int kind, V3 fr, V3 ve,
                        float alpha, Pdf& s) {
  s.ft = fetch(rows, kind, safe_acos(fr.z), alpha);
  const float* m = s.ft.m;
  float fx = fr.x, fy = fr.y;
  s.s2raw = add(mul(fx, fx), mul(fy, fy));
  s.s2 = clamp_lo(s.s2raw, 1e-12f);
  s.nx = add(mul(fx, ve.x), mul(fy, ve.y));
  s.ny = add(mul(-fy, ve.x), mul(fx, ve.y));
  s.r3 = {dvd(s.nx, s.s2), dvd(s.ny, s.s2), ve.z};
  s.det = det3(m);
  cofactors(m, s.cof);
  s.dsel = fabsf(s.det) > 1e-20f ? s.det : 1e-20f;
  s.inv_det = rcp(s.dsel);
#pragma unroll
  for (int k = 0; k < 9; ++k) s.inv[k] = mul(s.cof[k], s.inv_det);
  s.q = matvec(s.inv, s.r3);
  s.p = safe_normalize(s.q);
  s.L = matvec(m, s.p);
  s.l2 = dot3(s.L, s.L);
  s.sl = sqrt_(clamp_lo(s.l2, 1e-30f));
  s.l3 = mul(s.l2, s.sl);
  s.cl3 = clamp_lo(s.l3, 1e-30f);
  s.jac = dvd(s.det, s.cl3);
  s.pz0 = clamp_lo(s.p.z, 0.0f);
  s.D = mul(s.pz0, kInvPiLtc);
  s.jsel = fabsf(s.jac) > 1e-20f ? s.jac : 1e-20f;
  s.num = mul(s.ft.amp, s.D);
  s.val = dvd(s.num, s.jsel);
}

// ltc.sample's pieces: M c, z clamped, turned into the frame around v_in.
struct LtcSample {
  float th0;
  Fetch ft;
  V3 sv, rot, out;
};

__device__ void ltc_sample(const float* rows, int kind, V3 vin, float alpha,
                           V3 c, LtcSample& s) {
  s.th0 = safe_acos(vin.z);
  s.ft = fetch(rows, kind, clamp_lo(s.th0, kQuarterPi), alpha);
  s.sv = matvec(s.ft.m, c);
  float sz = clamp_lo(s.sv.z, 1e-4f);
  float fx = vin.x, fy = vin.y;
  s.rot = {sub(mul(fx, s.sv.x), mul(fy, s.sv.y)),
           add(mul(fy, s.sv.x), mul(fx, s.sv.y)), sz};
  s.out = safe_normalize(s.rot);
}

// ---------------------------------------------------------------- eval

__device__ __forceinline__ bool near_one(float dot, float tol) {
  return fabsf(sub(dot, 1.0f)) < tol;
}

__device__ __forceinline__ V3 reflect_z(V3 v) { return {-v.x, -v.y, v.z}; }

// _eval_base for the lane's own lobe.
template <bool kLtc>
__device__ V3 eval_base(const float* rows, const Mat& p, V3 vi, V3 vr) {
  const V3 zero = {0.0f, 0.0f, 0.0f};
  bool both_up = vi.z > 0.0f && vr.z > 0.0f;
  switch (p.type) {
    case kDiffuse:
      return both_up ? scale(p.d, kInvPi) : zero;
    case kMirror:
      return near_one(dot3(reflect_z(vi), vr), 1e-4f) ? p.s : zero;
    case kTransparent: {
      V3 mvi = {-vi.x, -vi.y, -vi.z};
      float one = near_one(dot3(mvi, vr), 1e-4f) ? 1.0f : 0.0f;
      return {one, one, one};
    }
    case kDielectric: {
      float eta = vi.z < 0.0f ? p.ior : rcp(p.ior);
      Fresnel f = fresnel(eta, vi.z);
      if (mul(vi.z, vr.z) > 0.0f) {
        return near_one(dot3(reflect_z(vi), vr), 1e-4f) ? scale(p.s, f.r)
                                                         : zero;
      }
      V3 refr = {mul(-vi.x, eta), mul(-vi.y, eta), vi.z > 0.0f ? -f.ct : f.ct};
      return near_one(dot3(vr, refr), 1e-3f) ? scale(p.s, sub(1.0f, f.r))
                                             : zero;
    }
    case kLtcBeckmann:
    case kLtcGgx:
    case kLtcBeckmannDiffuse:
    case kLtcGgxDiffuse: {
      if (!both_up) return zero;
      float ltc = 0.0f;
      if (kLtc) {
        Pdf s;
        ltc_pdf(rows, ltc_kind(p.type), vr, vi, p.rough, s);
        ltc = s.val;
      }
      V3 f = scale(p.s, ltc);
      if (is_ltcd(p.type)) acc(f, scale(p.d, kInvPi));
      return f;
    }
    default:
      return zero;
  }
}

// ---------------------------------------------------------------- sample

struct Sampled {
  V3 d, thr;
  bool leak;
};

// _sample_base for the lane's own lobe (the direction before the final
// safe_normalize).
template <bool kLtc>
__device__ Sampled sample_base(const float* rows, const Mat& p, V3 vi,
                               float u0, float u1) {
  const V3 zero = {0.0f, 0.0f, 0.0f};
  const V3 y_axis = {0.0f, 1.0f, 0.0f};
  bool up = vi.z > 0.0f;
  Sampled o = {zero, zero, false};
  switch (p.type) {
    case kDiffuse: {
      Hemi h = hemi(u0, u1);
      o.d = up ? V3{h.px, h.py, h.z} : y_axis;
      o.thr = up ? p.d : zero;
      break;
    }
    case kMirror:
      o.d = reflect_z(vi);
      o.thr = p.s;
      break;
    case kTransparent:
      o.d = {-vi.x, -vi.y, -vi.z};
      o.thr = {1.0f, 1.0f, 1.0f};
      o.leak = true;
      break;
    case kDielectric: {
      float eta = vi.z < 0.0f ? p.ior : rcp(p.ior);
      Fresnel f = fresnel(eta, fabsf(vi.z));
      float unused;
      bool take_refl = decide(u0, f.r, &unused);
      float act = fabsf(f.ct);
      o.d = take_refl ? reflect_z(vi)
                      : V3{mul(-vi.x, eta), mul(-vi.y, eta),
                           vi.z > 0.0f ? -act : act};
      o.thr = p.s;
      o.leak = !take_refl;
      break;
    }
    case kLtcBeckmann:
    case kLtcGgx: {
      Hemi h = hemi(u0, u1);
      V3 c = {h.px, h.py, h.z};
      V3 d = c;
      if (kLtc) {
        LtcSample s;
        ltc_sample(rows, ltc_kind(p.type), vi, p.rough, c, s);
        d = s.out;
      }
      o.d = d;
      o.thr = d.z > 0.0f ? p.s : zero;
      break;
    }
    case kLtcBeckmannDiffuse:
    case kLtcGgxDiffuse: {
      float dpow = sum3(p.d.x, p.d.y, p.d.z);
      float spow = sum3(p.s.x, p.s.y, p.s.z);
      float p_diff = dvd(dpow, add(add(dpow, spow), 1e-4f));
      float sx;
      bool take_diff = decide(u0, p_diff, &sx);
      Hemi hr = hemi(sx, u1);
      if (take_diff) {
        o.d = up ? V3{hr.px, hr.py, hr.z} : y_axis;
        o.thr = up ? p.d : zero;
      } else {
        V3 d;
        if (kLtc) {
          LtcSample s;
          ltc_sample(rows, ltc_kind(p.type), vi, p.rough,
                     V3{hr.px, hr.py, hr.z}, s);
          d = s.out;
        } else {
          Hemi h = hemi(u0, u1);
          d = {h.px, h.py, h.z};
        }
        o.d = d;
        o.thr = d.z > 0.0f ? p.s : zero;
      }
      break;
    }
    default:
      break;
  }
  return o;
}

// ---------------------------------------------------------------- kernels

__device__ __forceinline__ long long lane0() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}
__device__ __forceinline__ long long lanes_stride() {
  return static_cast<long long>(gridDim.x) * kThreads;
}

template <bool kMixOn, bool kLtc>
__global__ void __launch_bounds__(kThreads)
    eval_lanes(const RgkBxdfArgs a) {
  for (long long i = lane0(); i < a.n; i += lanes_stride()) {
    V3 vi = load3(a.vi, i), vr = load3(a.vr, i);
    Mat p0 = load_mat(a.mat[0], i);
    V3 f;
    if (kMixOn && p0.type == kMix) {
      V3 f1 = eval_base<kLtc>(a.ltc_rows, load_mat(a.mat[1], i), vi, vr);
      V3 f2 = eval_base<kLtc>(a.ltc_rows, load_mat(a.mat[2], i), vi, vr);
      float amt = p0.mix, rest = sub(1.0f, p0.mix);
      f = {add(mul(f1.x, amt), mul(f2.x, rest)),
           add(mul(f1.y, amt), mul(f2.y, rest)),
           add(mul(f1.z, amt), mul(f2.z, rest))};
    } else {
      f = eval_base<kLtc>(a.ltc_rows, p0, vi, vr);
    }
    store3(a.f, i, f);
  }
}

// The slot a sample reads and the sample it reads it with: a mix lane
// picks a sub-material by decide_and_rescale and goes on with the rescaled
// first component.
template <bool kMixOn>
__device__ __forceinline__ int sample_slot(const RgkBxdfArgs& a,
                                           const Mat& p0, long long i,
                                           float* u0) {
  if (!kMixOn || p0.type != kMix) return 0;
  float sx;
  bool take_m1 = decide(*u0, p0.mix, &sx);
  *u0 = sx;
  return take_m1 ? 1 : 2;
}

template <bool kMixOn, bool kLtc>
__global__ void __launch_bounds__(kThreads)
    sample_lanes(const RgkBxdfArgs a) {
  for (long long i = lane0(); i < a.n; i += lanes_stride()) {
    V3 vi = load3(a.vi, i);
    const float* u = a.u2.ptr + i * a.u2.stride;
    float u0 = u[0], u1 = u[1];
    Mat p0 = load_mat(a.mat[0], i);
    int k = sample_slot<kMixOn>(a, p0, i, &u0);
    Mat p = k == 0 ? p0 : load_mat(a.mat[k], i);
    Sampled o = sample_base<kLtc>(a.ltc_rows, p, vi, u0, u1);
    store3(a.dir, i, safe_normalize(o.d));
    store3(a.thr, i, o.thr);
    a.leak[i] = o.leak ? 1 : 0;
  }
}

// ---------------------------------------------------------------- backward
//
// A backward entry recomputes its lane's forward in float, bit for bit, and
// applies the chain rule to those float intermediates in double: where a
// slope cancels (an LTC lobe's neighbouring table rows, the Fresnel
// derivative near grazing) its gradient is no less accurate than
// autograd's float32 one.  A gradient that is one product of floats (the
// diffuse lobe's g / pi, the mix's g x amount, a throughput's g) rounds to
// the float autograd gives, bit for bit.

struct D3 {
  double x, y, z;
};

__device__ __forceinline__ D3 d3(V3 v) { return {v.x, v.y, v.z}; }
__device__ __forceinline__ double ddot(D3 a, D3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ D3 dscale(D3 v, double k) {
  return {v.x * k, v.y * k, v.z * k};
}
__device__ __forceinline__ void dacc(D3& a, D3 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
}
__device__ __forceinline__ double sgn(double x) {
  return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0);
}

// Gradients of one material slot and of the local directions.
struct Grad {
  D3 d, s, vi, vr;
  double rough;
};

__device__ __forceinline__ Grad zero_grad() {
  const D3 z = {0.0, 0.0, 0.0};
  return {z, z, z, z, 0.0};
}

// safe_normalize's backward: the gradient of v from that of the output
// (the fallback +Z gets none).
__device__ D3 safe_normalize_bwd(V3 v, D3 g) {
  float l2 = dot3(v, v);
  if (!(l2 > 1e-24f)) return {0.0, 0.0, 0.0};
  double sq = sqrt_(clamp_lo(l2, 1e-24f));
  double rc = rcp(sqrt_(clamp_lo(l2, 1e-24f)));
  D3 gv = dscale(g, rc);
  double g_sq = -ddot(g, d3(v)) * rc * rc;
  double g_l2 = l2 >= 1e-24f ? g_sq / (2.0 * sq) : 0.0;
  dacc(gv, dscale(d3(v), 2.0 * g_l2));
  return gv;
}

// d(hemi)/d(u0), applied to the gradient of the hemisphere vector.
__device__ double hemi_bwd(float u0, const Hemi& h, D3 g) {
  double g_w = h.w >= 1e-5f ? g.z / (2.0 * h.z) : 0.0;
  double g_px = g.x - g_w * 2.0 * h.px;
  double g_py = g.y - g_w * 2.0 * h.py;
  double g_r = g_px * h.sn + g_py * h.cs;
  return u0 > 0.0f ? g_r / (2.0 * h.r) : g_r;
}

// d(rescaled)/d(p) of decide_and_rescale, applied to the rescaled sample's
// gradient.
__device__ double decide_bwd(float u, float p, double g) {
  bool take = u < p;
  float dt = clamp_lo(p, 1e-12f);
  float one_p = sub(1.0f, p);
  float df = clamp_lo(one_p, 1e-12f);
  float r = take ? dvd(u, dt) : dvd(sub(u, p), df);
  double g_r = (r >= 0.0f && r <= kOneMinus) ? g : 0.0;
  if (take) return p >= 1e-12f ? -g_r * u / (double(dt) * dt) : 0.0;
  double g_p = -g_r / df;
  double g_df = -g_r * (double(u) - p) / (double(df) * df);
  return g_p - (one_p >= 1e-12f ? g_df : 0.0);
}

// d/d(cos_theta) of fresnel's (r, ct), applied to their gradients.
__device__ double fresnel_bwd(float cos_theta, const Fresnel& f, double g_r,
                              double g_ct) {
  if (f.tir) return 0.0;
  double eta = f.eta, c = f.c;
  double g_ctr = g_ct;
  double g_rs = g_r * f.rs, g_rp = g_r * f.rp;  // 0.5 (rs^2 + rp^2)
  double g_num_s = g_rs / f.den_s;
  double g_den_s = -g_rs * f.rs / f.den_s;
  if (!(add(mul(f.eta, f.c), f.ct_raw) >= 1e-12f)) g_den_s = 0.0;
  double g_num_p = g_rp / f.den_p;
  double g_den_p = -g_rp * f.rp / f.den_p;
  if (!(add(mul(f.eta, f.ct_raw), f.c) >= 1e-12f)) g_den_p = 0.0;
  // num_s = eta c - ct, den_s = eta c + ct, num_p = eta ct - c,
  // den_p = eta ct + c
  double g_c = (g_num_s + g_den_s) * eta + (g_den_p - g_num_p);
  g_ctr += (g_den_s - g_num_s) + (g_num_p + g_den_p) * eta;
  // ct_raw = sqrt(clamp(1 - st2)), st2 = eta^2 (1 - c^2)
  double g_st2 = sub(1.0f, f.st2) >= 1e-12f ? -g_ctr / (2.0 * f.ct_raw)
                                            : 0.0;
  g_c -= g_st2 * eta * eta * 2.0 * c;
  return g_c * sgn(cos_theta);
}

// The gradients of theta and alpha from those of M and amp.
__device__ void fetch_bwd(const float* rows, const Fetch& f, const double* g_m,
                          double g_amp, double* g_theta, double* g_alpha) {
  const float* r11 = rows + 10LL * f.base;
  const float* r12 = r11 + 10;
  const float* r21 = r11 + 10 * kSize;
  const float* r22 = r21 + 10;
  double g11 = 0.0, g12 = 0.0, g21 = 0.0, g22 = 0.0;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    double gb = k < 9 ? g_m[k] : g_amp;
    g11 += gb * r11[k];
    g12 += gb * r12[k];
    g21 += gb * r21[k];
    g22 += gb * r22[k];
  }
  double dt1 = f.dt1, da1 = f.da1, dt2 = sub(1.0f, f.dt1),
         da2 = sub(1.0f, f.da1);
  // w11 = dt2 da2, w12 = dt2 da1, w21 = dt1 da2, w22 = dt1 da1
  double g_dt1 = (g21 * da2 + g22 * da1) - (g11 * da2 + g12 * da1);
  double g_da1 = (g12 * dt2 + g22 * dt1) - (g11 * dt2 + g21 * dt1);
  // dt1 = 63 t - floor(63 t); t = clamp(clamp(t_pre, 0, 1), max=0.999)
  double g_t = g_dt1 * 63.0;
  if (!(f.t_mid <= kClampAt) || !(f.t_pre >= 0.0f && f.t_pre <= 1.0f))
    g_t = 0.0;
  *g_theta = g_t * kInvHalfPi;
  double g_a = g_da1 * 63.0;
  if (!(f.a_mid <= kClampAt) || !(f.a_sq >= 0.0f && f.a_sq <= 1.0f))
    g_a = 0.0;
  *g_alpha = f.alpha >= 0.0f ? g_a / (2.0 * f.a_sq) : 0.0;
}

// Gradient of M (added to g_m) and of v from that of M v.
__device__ __forceinline__ D3 matvec_bwd(const float* m, V3 v, D3 g,
                                         double* g_m) {
  const double gi[3] = {g.x, g.y, g.z};
  const double vj[3] = {v.x, v.y, v.z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) g_m[3 * i + j] += gi[i] * vj[j];
  }
  return {g.x * m[0] + g.y * m[3] + g.z * m[6],
          g.x * m[1] + g.y * m[4] + g.z * m[7],
          g.x * m[2] + g.y * m[5] + g.z * m[8]};
}

// d acos(clamp(z))/dz applied to g.
__device__ __forceinline__ double safe_acos_bwd(float z, double g) {
  if (!(z >= kAcosLo && z <= kAcosHi)) return 0.0;
  return -g / sqrt(1.0 - double(z) * z);
}

// The pdf's gradients of the frame vector, the evaluated vector and alpha.
__device__ void ltc_pdf_bwd(const float* rows, V3 fr, V3 ve, const Pdf& s,
                            double g, D3* g_fr, D3* g_ve, double* g_alpha) {
  const float* m = s.ft.m;
  double g_m[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  // val = amp D / jsel
  double g_num = g / s.jsel;
  double g_jac = fabsf(s.jac) > 1e-20f ? -g * s.val / s.jsel : 0.0;
  double g_amp = g_num * s.D;
  double g_pz = s.p.z >= 0.0f ? g_num * s.ft.amp * kInvPiLtc : 0.0;
  // jac = det / clamp(l2 sqrt(clamp(l2)))
  double g_det = g_jac / s.cl3;
  double g_l3 = s.l3 >= 1e-30f ? -g_jac * s.jac / s.cl3 : 0.0;
  double g_l2 = g_l3 * s.sl;
  if (s.l2 >= 1e-30f) g_l2 += g_l3 * s.l2 / (2.0 * s.sl);
  D3 g_L = dscale(d3(s.L), 2.0 * g_l2);
  D3 g_p = matvec_bwd(m, s.p, g_L, g_m);
  g_p.z += g_pz;
  D3 g_q = safe_normalize_bwd(s.q, g_p);
  double g_inv[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  D3 g_r3 = matvec_bwd(s.inv, s.r3, g_q, g_inv);
  // inv = cof inv_det, inv_det = 1 / dsel
  double g_invdet = 0.0;
  double g_cof[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    g_cof[k] = g_inv[k] * s.inv_det;
    g_invdet += g_inv[k] * s.cof[k];
  }
  if (fabsf(s.det) > 1e-20f)
    g_det -= g_invdet * double(s.inv_det) * s.inv_det;
  // det's gradient: its cofactors, the transpose of the adjugate
  const int tr[9] = {0, 3, 6, 1, 4, 7, 2, 5, 8};
#pragma unroll
  for (int k = 0; k < 9; ++k) g_m[k] += g_det * s.cof[tr[k]];
  // The cofactors c_k = m_a m_b - m_c m_d.
  const int ca[9][4] = {{4, 8, 5, 7}, {2, 7, 1, 8}, {1, 5, 2, 4},
                        {5, 6, 3, 8}, {0, 8, 2, 6}, {2, 3, 0, 5},
                        {3, 7, 4, 6}, {1, 6, 0, 7}, {0, 4, 1, 3}};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    g_m[ca[k][0]] += g_cof[k] * m[ca[k][1]];
    g_m[ca[k][1]] += g_cof[k] * m[ca[k][0]];
    g_m[ca[k][2]] -= g_cof[k] * m[ca[k][3]];
    g_m[ca[k][3]] -= g_cof[k] * m[ca[k][2]];
  }
  double g_theta;
  fetch_bwd(rows, s.ft, g_m, g_amp, &g_theta, g_alpha);
  // r3 = ((fx ex + fy ey) / s2, (-fy ex + fx ey) / s2, ez)
  double fx = fr.x, fy = fr.y;
  double g_nx = g_r3.x / s.s2, g_ny = g_r3.y / s.s2;
  double g_s2raw = s.s2raw >= 1e-12f
                       ? -(g_r3.x * s.r3.x + g_r3.y * s.r3.y) / s.s2
                       : 0.0;
  g_fr->x = g_nx * ve.x + g_ny * ve.y + 2.0 * g_s2raw * fx;
  g_fr->y = g_nx * ve.y - g_ny * ve.x + 2.0 * g_s2raw * fy;
  g_fr->z = safe_acos_bwd(fr.z, g_theta);
  g_ve->x = g_nx * fx - g_ny * fy;
  g_ve->y = g_nx * fy + g_ny * fx;
  g_ve->z = g_r3.z;
}

// ltc.sample's gradients of v_in, alpha and the cosine vector c from the
// output's.
__device__ void ltc_sample_bwd(const float* rows, V3 vin, V3 c,
                               const LtcSample& s, D3 g, D3* g_vin,
                               double* g_alpha, D3* g_c) {
  D3 gr = safe_normalize_bwd(s.rot, g);
  double fx = vin.x, fy = vin.y;
  D3 g_sv = {gr.x * fx + gr.y * fy, gr.y * fx - gr.x * fy,
             s.sv.z >= 1e-4f ? gr.z : 0.0};
  double g_m[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  *g_c = matvec_bwd(s.ft.m, c, g_sv, g_m);
  double g_theta;
  fetch_bwd(rows, s.ft, g_m, 0.0, &g_theta, g_alpha);
  if (!(s.th0 >= kQuarterPi)) g_theta = 0.0;
  g_vin->x = gr.x * s.sv.x + gr.y * s.sv.y;
  g_vin->y = gr.y * s.sv.x - gr.x * s.sv.y;
  g_vin->z = safe_acos_bwd(vin.z, g_theta);
}

// eval_base's backward: adds the slot's and the directions' gradients to
// `gr` from the gradient `g` of f.
template <bool kLtc>
__device__ void eval_base_bwd(const float* rows, const Mat& p, V3 vi, V3 vr,
                              V3 g, Grad& gr) {
  bool both_up = vi.z > 0.0f && vr.z > 0.0f;
  switch (p.type) {
    case kDiffuse:
      if (both_up) gr.d = dscale(d3(g), kInvPi);
      return;
    case kMirror:
      if (near_one(dot3(reflect_z(vi), vr), 1e-4f)) gr.s = d3(g);
      return;
    case kDielectric: {
      float eta = vi.z < 0.0f ? p.ior : rcp(p.ior);
      Fresnel f = fresnel(eta, vi.z);
      double g_r;
      if (mul(vi.z, vr.z) > 0.0f) {
        if (!near_one(dot3(reflect_z(vi), vr), 1e-4f)) return;
        gr.s = dscale(d3(g), f.r);
        g_r = ddot(d3(g), d3(p.s));
      } else {
        V3 refr = {mul(-vi.x, eta), mul(-vi.y, eta),
                   vi.z > 0.0f ? -f.ct : f.ct};
        if (!near_one(dot3(vr, refr), 1e-3f)) return;
        gr.s = dscale(d3(g), sub(1.0f, f.r));
        g_r = -ddot(d3(g), d3(p.s));
      }
      gr.vi.z += fresnel_bwd(vi.z, f, g_r, 0.0);
      return;
    }
    case kLtcBeckmann:
    case kLtcGgx:
    case kLtcBeckmannDiffuse:
    case kLtcGgxDiffuse: {
      if (!both_up) return;
      if (is_ltcd(p.type)) gr.d = dscale(d3(g), kInvPi);
      if (!kLtc) {
        gr.s = dscale(d3(g), 0.0f);
        return;
      }
      Pdf s;
      ltc_pdf(rows, ltc_kind(p.type), vr, vi, p.rough, s);
      gr.s = dscale(d3(g), s.val);
      D3 g_fr, g_ve;
      ltc_pdf_bwd(rows, vr, vi, s, ddot(d3(g), d3(p.s)), &g_fr, &g_ve,
                  &gr.rough);
      dacc(gr.vr, g_fr);
      dacc(gr.vi, g_ve);
      return;
    }
    default:
      return;
  }
}

// sample_base's backward from the gradients of the raw direction and the
// throughput.
template <bool kLtc>
__device__ void sample_base_bwd(const float* rows, const Mat& p, V3 vi,
                                float u0, float u1, D3 g_d, V3 g_thr,
                                Grad& gr) {
  bool up = vi.z > 0.0f;
  switch (p.type) {
    case kDiffuse:
      if (up) gr.d = d3(g_thr);
      return;
    case kMirror:
      gr.s = d3(g_thr);
      gr.vi = {-g_d.x, -g_d.y, g_d.z};
      return;
    case kTransparent:
      gr.vi = {-g_d.x, -g_d.y, -g_d.z};
      return;
    case kDielectric: {
      float eta = vi.z < 0.0f ? p.ior : rcp(p.ior);
      float c = fabsf(vi.z);
      Fresnel f = fresnel(eta, c);
      float unused;
      bool take_refl = decide(u0, f.r, &unused);
      gr.s = d3(g_thr);
      if (take_refl) {
        gr.vi = {-g_d.x, -g_d.y, g_d.z};
        return;
      }
      gr.vi.x = -g_d.x * eta;
      gr.vi.y = -g_d.y * eta;
      double g_ct = (vi.z > 0.0f ? -g_d.z : g_d.z) * sgn(f.ct);
      gr.vi.z = fresnel_bwd(c, f, 0.0, g_ct) * sgn(vi.z);
      return;
    }
    case kLtcBeckmann:
    case kLtcGgx: {
      Hemi h = hemi(u0, u1);
      V3 c = {h.px, h.py, h.z};
      if (!kLtc) {
        if (c.z > 0.0f) gr.s = d3(g_thr);
        return;
      }
      LtcSample s;
      ltc_sample(rows, ltc_kind(p.type), vi, p.rough, c, s);
      if (s.out.z > 0.0f) gr.s = d3(g_thr);
      D3 g_c;
      ltc_sample_bwd(rows, vi, c, s, g_d, &gr.vi, &gr.rough, &g_c);
      return;
    }
    case kLtcBeckmannDiffuse:
    case kLtcGgxDiffuse: {
      float dpow = sum3(p.d.x, p.d.y, p.d.z);
      float spow = sum3(p.s.x, p.s.y, p.s.z);
      float den = add(add(dpow, spow), 1e-4f);
      float p_diff = dvd(dpow, den);
      float sx;
      bool take_diff = decide(u0, p_diff, &sx);
      Hemi hr = hemi(sx, u1);
      D3 g_c = {0.0, 0.0, 0.0};
      if (take_diff) {
        if (!up) return;
        gr.d = d3(g_thr);
        g_c = g_d;
      } else if (kLtc) {
        V3 c = {hr.px, hr.py, hr.z};
        LtcSample s;
        ltc_sample(rows, ltc_kind(p.type), vi, p.rough, c, s);
        if (s.out.z > 0.0f) gr.s = d3(g_thr);
        ltc_sample_bwd(rows, vi, c, s, g_d, &gr.vi, &gr.rough, &g_c);
      } else {
        if (hemi(u0, u1).z > 0.0f) gr.s = d3(g_thr);
        return;
      }
      // sx = decide_and_rescale(u0, dpow / (dpow + spow + 1e-4))
      double g_pd = decide_bwd(u0, p_diff, hemi_bwd(sx, hr, g_c));
      double g_dpow = g_pd / den;
      double g_den = -g_pd * p_diff / den;
      g_dpow += g_den;
      dacc(gr.d, D3{g_dpow, g_dpow, g_dpow});
      dacc(gr.s, D3{g_den, g_den, g_den});
      return;
    }
    default:
      return;
  }
}

// A gradient as stored: rounded to float, -0 read as +0 (autograd adds the
// other lobes' zeros to it).
__device__ __forceinline__ void store_grad3(float* out, long long i, D3 v) {
  if (out) {
    store3(out, i, V3{canon(static_cast<float>(v.x)),
                      canon(static_cast<float>(v.y)),
                      canon(static_cast<float>(v.z))});
  }
}

__device__ __forceinline__ void store_slot(const RgkBxdfArgs& a, int k,
                                           long long i, const Grad& g) {
  store_grad3(a.g_diffuse[k], i, g.d);
  store_grad3(a.g_specular[k], i, g.s);
  if (a.g_rough[k]) a.g_rough[k][i] = canon(static_cast<float>(g.rough));
}

template <bool kMixOn, bool kLtc>
__global__ void __launch_bounds__(kThreads)
    eval_bwd_lanes(const RgkBxdfArgs a) {
  for (long long i = lane0(); i < a.n; i += lanes_stride()) {
    V3 vi = load3(a.vi, i), vr = load3(a.vr, i);
    V3 g = load_out3(a.g_f, i);
    Mat p0 = load_mat(a.mat[0], i);
    Grad gs[3] = {zero_grad(), zero_grad(), zero_grad()};
    D3 g_vi, g_vr;
    if (kMixOn && p0.type == kMix) {
      // f1 amt + f2 (1 - amt): each slot's gradient, as autograd rounds it
      eval_base_bwd<kLtc>(a.ltc_rows, load_mat(a.mat[1], i), vi, vr,
                          scale(g, p0.mix), gs[1]);
      eval_base_bwd<kLtc>(a.ltc_rows, load_mat(a.mat[2], i), vi, vr,
                          scale(g, sub(1.0f, p0.mix)), gs[2]);
      g_vi = gs[1].vi;
      dacc(g_vi, gs[2].vi);
      g_vr = gs[1].vr;
      dacc(g_vr, gs[2].vr);
    } else {
      eval_base_bwd<kLtc>(a.ltc_rows, p0, vi, vr, g, gs[0]);
      g_vi = gs[0].vi;
      g_vr = gs[0].vr;
    }
    for (int k = 0; k < (kMixOn ? 3 : 1); ++k) store_slot(a, k, i, gs[k]);
    store_grad3(a.g_vi, i, g_vi);
    store_grad3(a.g_vr, i, g_vr);
  }
}

template <bool kMixOn, bool kLtc>
__global__ void __launch_bounds__(kThreads)
    sample_bwd_lanes(const RgkBxdfArgs a) {
  for (long long i = lane0(); i < a.n; i += lanes_stride()) {
    V3 vi = load3(a.vi, i);
    const float* u = a.u2.ptr + i * a.u2.stride;
    float u0 = u[0], u1 = u[1];
    Mat p0 = load_mat(a.mat[0], i);
    int k = sample_slot<kMixOn>(a, p0, i, &u0);
    Mat p = k == 0 ? p0 : load_mat(a.mat[k], i);
    Sampled o = sample_base<kLtc>(a.ltc_rows, p, vi, u0, u1);
    D3 g_d = safe_normalize_bwd(o.d, d3(load_out3(a.g_dir, i)));
    Grad gs[3] = {zero_grad(), zero_grad(), zero_grad()};
    sample_base_bwd<kLtc>(a.ltc_rows, p, vi, u0, u1, g_d,
                          load_out3(a.g_thr, i), gs[k]);
    for (int j = 0; j < (kMixOn ? 3 : 1); ++j) store_slot(a, j, i, gs[j]);
    store_grad3(a.g_vi, i, gs[k].vi);
  }
}

unsigned grid(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

enum Entry { kEval, kSample, kEvalBwd, kSampleBwd };

template <bool M, bool L>
void go(Entry e, const RgkBxdfArgs& a, unsigned g, cudaStream_t s) {
  switch (e) {
    case kEval:
      eval_lanes<M, L><<<g, kThreads, 0, s>>>(a);
      break;
    case kSample:
      sample_lanes<M, L><<<g, kThreads, 0, s>>>(a);
      break;
    case kEvalBwd:
      eval_bwd_lanes<M, L><<<g, kThreads, 0, s>>>(a);
      break;
    case kSampleBwd:
      sample_bwd_lanes<M, L><<<g, kThreads, 0, s>>>(a);
      break;
  }
}

int launch(Entry e, const RgkBxdfArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  unsigned g = grid(a->n);
  if (a->has_mix) {
    if (a->has_ltc) go<true, true>(e, *a, g, s);
    else go<true, false>(e, *a, g, s);
  } else {
    if (a->has_ltc) go<false, true>(e, *a, g, s);
    else go<false, false>(e, *a, g, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry: one launch over args->n lanes on `stream`; returns
// cudaGetLastError() as an int (0 with no lane and no launch).
int rgk_bxdf_eval(const RgkBxdfArgs* a, void* stream) {
  return launch(kEval, a, stream);
}

int rgk_bxdf_sample(const RgkBxdfArgs* a, void* stream) {
  return launch(kSample, a, stream);
}

int rgk_bxdf_eval_bwd(const RgkBxdfArgs* a, void* stream) {
  return launch(kEvalBwd, a, stream);
}

int rgk_bxdf_sample_bwd(const RgkBxdfArgs* a, void* stream) {
  return launch(kSampleBwd, a, stream);
}

}  // extern "C"
