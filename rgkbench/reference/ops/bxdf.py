"""Branchless BxDF dispatch: eval and sample for whole wavefronts
(port of rgk_tpu/ops/bxdf.py).

Every lane computes all lobes and selects by the material's
`bxdf_type`.  Conventions are the reference's: vectors in the local
shading frame (+Z = shading normal); `eval(Vi, Vr)` returns the BRDF
value; `sample(Vi, u2)` returns (direction, throughput, may_leak);
delta lobes eval to their albedo only within the reference's cosine
tolerance of the delta direction.  One mix level is supported.
"""

from __future__ import annotations

import torch

from ..scene.arrays import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_LTC_BECKMANN,
    BSDF_LTC_BECKMANN_DIFFUSE,
    BSDF_LTC_GGX,
    BSDF_LTC_GGX_DIFFUSE,
    BSDF_MIRROR,
    BSDF_MIX,
    BSDF_TRANSPARENT,
)
from . import ltc as ltc_ops
from . import textures as tex_ops
from . import vecmath as vm
from . import warps

PI = 3.14159265358979


def _fresnel_dielectric(eta, cos_theta):
    """(reflectance, cos_theta_trans); eta flips when the ray comes
    from below."""
    flip = cos_theta < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_theta = torch.abs(cos_theta)
    sin_t_sq = eta * eta * (1.0 - cos_theta * cos_theta)
    tir = sin_t_sq > 1.0
    cos_trans = torch.sqrt(torch.clamp(1.0 - sin_t_sq, min=1e-12))
    rs = (eta * cos_theta - cos_trans) / torch.clamp(
        eta * cos_theta + cos_trans, min=1e-12)
    rp = (eta * cos_trans - cos_theta) / torch.clamp(
        eta * cos_trans + cos_theta, min=1e-12)
    r = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, r), torch.where(tir, 0.0, cos_trans)


def build_mat_pack(materials) -> torch.Tensor:
    """One [NM, 19] row per material: emission(3) diffuse(3)
    specular(3) roughness ior mix_amt bxdf_type mix_m1 mix_m2
    diffuse_tex specular_tex bump_tex no_russian."""
    m = materials

    def col(x):
        return x.to(torch.float32)[:, None]

    return torch.cat([
        m.emission, m.diffuse, m.specular,
        col(m.roughness), col(m.ior), col(m.mix_amt), col(m.bxdf_type),
        col(m.mix_m1), col(m.mix_m2), col(m.diffuse_tex),
        col(m.specular_tex), col(m.bump_tex), col(m.no_russian),
    ], dim=1)


class MatParams:
    """Per-lane material parameters from one row of the pack; pass a
    prefetched `row` to reuse it."""

    def __init__(self, scene, mat_pack, mat_id, uv, row=None,
                 has_textures=True):
        if row is None:
            row = vm.take_rows(mat_pack, mat_id)
        self.emission = row[..., 0:3]
        self.bxdf_type = row[..., 12].to(torch.int32)
        self.diffuse = self._resolve(scene, row[..., 15], row[..., 3:6], uv,
                                     has_textures)
        self.specular = self._resolve(scene, row[..., 16], row[..., 6:9], uv,
                                      has_textures)
        self.roughness = row[..., 9]
        self.ior = row[..., 10]
        self.mix_amt = row[..., 11]
        self.mix_m1 = row[..., 13].to(torch.int32)
        self.mix_m2 = row[..., 14].to(torch.int32)
        # LTC table kind: GGX for the GGX types, else Beckmann.
        self.ltc_kind = torch.where(
            (self.bxdf_type == BSDF_LTC_GGX)
            | (self.bxdf_type == BSDF_LTC_GGX_DIFFUSE),
            ltc_ops.KIND_GGX, ltc_ops.KIND_BECKMANN)

    @staticmethod
    def _resolve(scene, tex_col, solid, uv, has_textures):
        if not has_textures:
            return solid
        return tex_ops.resolve_color(scene.textures, tex_col.to(torch.int32),
                                     solid, uv)


def _eval_base(tables, p: MatParams, vi, vr, has_ltc=True):
    """All-lobes eval, selected by type.  vi/vr: local [...,3]."""
    viz = vi[..., 2]
    vrz = vr[..., 2]
    both_up = ((viz > 0.0) & (vrz > 0.0))[..., None]

    f_diffuse = torch.where(both_up, p.diffuse / PI, 0.0)

    refl = vm.reflect_z(vi)
    is_mirror_dir = (torch.abs(vm.dot(refl, vr) - 1.0) < 1e-4)[..., None]
    f_mirror = torch.where(is_mirror_dir, p.specular, 0.0)

    is_inverse_dir = (torch.abs(vm.dot(-vi, vr) - 1.0) < 1e-4)[..., None]
    f_transparent = torch.where(is_inverse_dir, 1.0,
                                torch.zeros_like(p.specular))

    # Dielectric (reference BxDFDielectric::value)
    eta = torch.where(viz < 0.0, p.ior, 1.0 / p.ior)
    r_p, cos_t = _fresnel_dielectric(eta, viz)
    same_side = (viz * vrz > 0.0)[..., None]
    refr = torch.stack([
        -vi[..., 0] * eta,
        -vi[..., 1] * eta,
        torch.where(viz > 0.0, -cos_t, cos_t)], dim=-1)
    is_refr_dir = (torch.abs(vm.dot(vr, refr) - 1.0) < 1e-3)[..., None]
    f_dielectric = torch.where(
        same_side,
        torch.where(is_mirror_dir, r_p[..., None] * p.specular, 0.0),
        torch.where(is_refr_dir, (1.0 - r_p)[..., None] * p.specular, 0.0))

    # LTC: frame around outgoing vr, evaluated at vi
    if has_ltc:
        ltc_val = ltc_ops.pdf(tables, p.ltc_kind, vr, vi, p.roughness)
    else:
        ltc_val = torch.zeros_like(p.roughness)
    f_ltc = torch.where(both_up, p.specular * ltc_val[..., None], 0.0)
    f_ltc_diffuse = torch.where(
        both_up, p.specular * ltc_val[..., None] + p.diffuse / PI, 0.0)

    t = p.bxdf_type[..., None]
    out = torch.where(t == BSDF_DIFFUSE, f_diffuse, 0.0)
    out = torch.where(t == BSDF_MIRROR, f_mirror, out)
    out = torch.where(t == BSDF_TRANSPARENT, f_transparent, out)
    out = torch.where(t == BSDF_DIELECTRIC, f_dielectric, out)
    out = torch.where((t == BSDF_LTC_BECKMANN) | (t == BSDF_LTC_GGX),
                      f_ltc, out)
    out = torch.where((t == BSDF_LTC_BECKMANN_DIFFUSE)
                      | (t == BSDF_LTC_GGX_DIFFUSE), f_ltc_diffuse, out)
    return out


def eval_bxdf(scene, mat_pack, mat_id, vi, vr, uv, tables,
              has_mix=True, has_ltc=True, has_textures=True, p0=None):
    """BRDF value f(Vi, Vr) for lanes; handles one-level mixes.  The
    has_* flags are static scene facts (SceneMeta) that skip lobes the
    scene cannot reach; `p0` reuses prefetched MatParams."""
    p = p0 if p0 is not None else MatParams(scene, mat_pack, mat_id, uv,
                                            has_textures=has_textures)
    base = _eval_base(tables, p, vi, vr, has_ltc)
    if not has_mix:
        return base
    is_mix = (p.bxdf_type == BSDF_MIX)[..., None]
    amt = p.mix_amt[..., None]
    f1 = _eval_base(tables, MatParams(scene, mat_pack, p.mix_m1, uv,
                                      has_textures=has_textures),
                    vi, vr, has_ltc)
    f2 = _eval_base(tables, MatParams(scene, mat_pack, p.mix_m2, uv,
                                      has_textures=has_textures),
                    vi, vr, has_ltc)
    return torch.where(is_mix, f1 * amt + f2 * (1.0 - amt), base)


def _sample_base(tables, p: MatParams, vi, u2, has_ltc=True):
    """All-lobes sample, selected by type.
    Returns (dir, throughput, may_leak)."""
    viz = vi[..., 2]
    up = (viz > 0.0)[..., None]
    # Built on the device: a tensor from a Python list would be a
    # host-to-device copy, a sync that a CUDA-graph capture refuses.
    y_axis = torch.zeros_like(vi)
    y_axis[..., 1] = 1.0

    cos_dir = warps.to_hemisphere_cosine_z(u2)

    d_diffuse = torch.where(up, cos_dir, y_axis)
    t_diffuse = torch.where(up, p.diffuse, 0.0)

    d_mirror = vm.reflect_z(vi)
    d_transparent = -vi

    # Dielectric: reflect w.p. R else refract; the decision consumes
    # u2.x via decide_and_rescale.
    eta = torch.where(viz < 0.0, p.ior, 1.0 / p.ior)
    r_p, cos_t = _fresnel_dielectric(eta, torch.abs(viz))
    take_refl, _ = warps.decide_and_rescale(u2[..., 0], r_p)
    d_refr = torch.stack([
        -vi[..., 0] * eta,
        -vi[..., 1] * eta,
        torch.where(viz > 0.0, -torch.abs(cos_t), torch.abs(cos_t))], dim=-1)
    d_dielectric = torch.where(take_refl[..., None], d_mirror, d_refr)
    leak_dielectric = ~take_refl

    # LTC + diffuse lobe choice by relative albedo power.
    dpow = p.diffuse.sum(dim=-1)
    spow = p.specular.sum(dim=-1)
    p_diff = dpow / (dpow + spow + 1e-4)
    take_diff, sx = warps.decide_and_rescale(u2[..., 0], p_diff)
    cos_dir_r = warps.to_hemisphere_cosine_z(
        torch.stack([sx, u2[..., 1]], dim=-1))

    # One LTC transform serves both lobes: pure-LTC lanes feed the raw
    # cosine vector, LTC+diffuse lanes the rescaled one.
    tt = p.bxdf_type
    is_ltc = (tt == BSDF_LTC_BECKMANN) | (tt == BSDF_LTC_GGX)
    is_ltcd = (tt == BSDF_LTC_BECKMANN_DIFFUSE) | (tt == BSDF_LTC_GGX_DIFFUSE)
    if has_ltc:
        cos_sel = torch.where(is_ltcd[..., None], cos_dir_r, cos_dir)
        d_ltc = ltc_ops.sample(tables, p.ltc_kind, vi, p.roughness, cos_sel)
    else:
        d_ltc = cos_dir
    ltc_ok = (d_ltc[..., 2] > 0.0)[..., None]
    t_ltc = torch.where(ltc_ok, p.specular, 0.0)
    take_diff3 = take_diff[..., None]
    d_ltcdiff = torch.where(take_diff3,
                            torch.where(up, cos_dir_r, y_axis), d_ltc)
    t_ltcdiff = torch.where(take_diff3, torch.where(up, p.diffuse, 0.0),
                            t_ltc)

    t = tt[..., None]
    d = torch.where(t == BSDF_DIFFUSE, d_diffuse, 0.0)
    thr = torch.where(t == BSDF_DIFFUSE, t_diffuse, 0.0)
    d = torch.where(t == BSDF_MIRROR, d_mirror, d)
    thr = torch.where(t == BSDF_MIRROR, p.specular, thr)
    d = torch.where(t == BSDF_TRANSPARENT, d_transparent, d)
    thr = torch.where(t == BSDF_TRANSPARENT, 1.0, thr)
    d = torch.where(t == BSDF_DIELECTRIC, d_dielectric, d)
    thr = torch.where(t == BSDF_DIELECTRIC, p.specular, thr)
    d = torch.where(is_ltc[..., None], d_ltc, d)
    thr = torch.where(is_ltc[..., None], t_ltc, thr)
    d = torch.where(is_ltcd[..., None], d_ltcdiff, d)
    thr = torch.where(is_ltcd[..., None], t_ltcdiff, thr)

    leak = (tt == BSDF_TRANSPARENT) | ((tt == BSDF_DIELECTRIC)
                                       & leak_dielectric)
    return vm.safe_normalize(d), thr, leak


def sample_bxdf(scene, mat_pack, mat_id, vi, uv, u2, tables,
                has_mix=True, has_ltc=True, has_textures=True, p0=None):
    """Sample an outgoing direction.  Returns (dir, throughput, leak);
    mix lanes pick a leaf with the reference's sample-reuse split."""
    if p0 is None:
        p0 = MatParams(scene, mat_pack, mat_id, uv, has_textures=has_textures)
    if not has_mix:
        return _sample_base(tables, p0, vi, u2, has_ltc)
    is_mix = p0.bxdf_type == BSDF_MIX
    take_m1, sx = warps.decide_and_rescale(u2[..., 0], p0.mix_amt)
    u2_mix = torch.stack([sx, u2[..., 1]], dim=-1)
    # Non-mix lanes keep the original sample; mix lanes the rescaled.
    u2_eff = torch.where(is_mix[..., None], u2_mix, u2)
    sub_id = torch.where(is_mix, torch.where(take_m1, p0.mix_m1, p0.mix_m2),
                         mat_id.to(torch.int32))
    p = MatParams(scene, mat_pack, sub_id, uv, has_textures=has_textures)
    return _sample_base(tables, p, vi, u2_eff, has_ltc)
