"""BxDF dispatch: eval and sample for whole wavefronts (port of
rgk_tpu/ops/bxdf.py).

Conventions are the reference's: vectors in the local shading frame
(+Z = shading normal); `eval(Vi, Vr)` returns the BRDF value;
`sample(Vi, u2)` returns (direction, throughput, may_leak); delta lobes
eval to their albedo only within the reference's cosine tolerance of the
delta direction.  One mix level is supported.

The plain version (`eval_bxdf_plain`, `sample_bxdf_plain`) is the
reference's branchless form: every lane computes all lobes and selects
by the material's `bxdf_type`.  The public functions take it on a CPU
tensor.  On a CUDA tensor each call of `eval_bxdf` or `sample_bxdf` is
one launch of the BxDF kernel (`csrc/bxdf.cu`, built at first use by
`rgk_tpu_torch.kernels`), which computes each lane's own lobe alone, bit
for bit the plain version run on the card; another device raises.
`MatParams` (the pack's row, textures resolved) stays in PyTorch and the
kernel reads its per-lane fields in place.  Under autograd a call is a
`torch.autograd.Function` whose backward is one launch more
(`eval_bwd` / `sample_bwd`), recomputing the lobe from the saved inputs:
it returns the gradients of diffuse, specular, roughness and the local
directions; ior and the mix amount, no parameter of `diff/params.py`,
get none.  Inside the gradient step the backward launches are stamped
as its `bxdf_bwd_ns` phase (`graph_while.grad_phase`).  `launches`
counts the kernel's launches by entry; nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import math
from functools import cached_property

import torch
from torch.autograd.function import once_differentiable

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
from . import graph_while as gw
from . import ltc as ltc_ops
from . import textures as tex_ops
from . import vecmath as vm
from . import warps

PI = 3.14159265358979

launches = {"eval": 0, "sample": 0, "eval_bwd": 0, "sample_bwd": 0}


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
    """One [NM, 20] row per material: emission(3) diffuse(3)
    specular(3) roughness ior mix_amt bxdf_type mix_m1 mix_m2
    diffuse_tex specular_tex bump_tex no_russian is_thinglass."""
    m = materials

    def col(x):
        return x.to(torch.float32)[:, None]

    return torch.cat([
        m.emission, m.diffuse, m.specular,
        col(m.roughness), col(m.ior), col(m.mix_amt), col(m.bxdf_type),
        col(m.mix_m1), col(m.mix_m2), col(m.diffuse_tex),
        col(m.specular_tex), col(m.bump_tex), col(m.no_russian),
        col(m.is_thinglass),
    ], dim=1)


class MatParams:
    """Per-lane material parameters from one row of the pack; pass a
    prefetched `row` to reuse it.  The integer fields and the LTC kind
    are computed when first read (the kernel reads the type column of
    `row` itself)."""

    def __init__(self, scene, mat_pack, mat_id, uv, row=None,
                 has_textures=True):
        if row is None:
            row = vm.take_rows(mat_pack, mat_id)
        self.row = row
        self.emission = row[..., 0:3]
        self.diffuse = self._resolve(scene, row[..., 15], row[..., 3:6], uv,
                                     has_textures)
        self.specular = self._resolve(scene, row[..., 16], row[..., 6:9], uv,
                                      has_textures)
        self.roughness = row[..., 9]
        self.ior = row[..., 10]
        self.mix_amt = row[..., 11]

    @cached_property
    def bxdf_type(self):
        return self.row[..., 12].to(torch.int32)

    @cached_property
    def mix_m1(self):
        return self.row[..., 13].to(torch.int32)

    @cached_property
    def mix_m2(self):
        return self.row[..., 14].to(torch.int32)

    @cached_property
    def ltc_kind(self):
        """LTC table kind: GGX for the GGX types, else Beckmann."""
        return torch.where(
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


def eval_bxdf_plain(scene, mat_pack, mat_id, vi, vr, uv, tables,
                    has_mix=True, has_ltc=True, has_textures=True, p0=None):
    """`eval_bxdf` in plain PyTorch, every lobe for every lane."""
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


def sample_bxdf_plain(scene, mat_pack, mat_id, vi, uv, u2, tables,
                      has_mix=True, has_ltc=True, has_textures=True,
                      p0=None):
    """`sample_bxdf` in plain PyTorch, every lobe for every lane."""
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


def eval_bxdf(scene, mat_pack, mat_id, vi, vr, uv, tables,
              has_mix=True, has_ltc=True, has_textures=True, p0=None):
    """BRDF value f(Vi, Vr) for lanes; handles one-level mixes.  The
    has_* flags are static scene facts (SceneMeta) that skip lobes the
    scene cannot reach; `p0` reuses prefetched MatParams.  The plain
    version on a CPU tensor, one kernel launch on a CUDA tensor."""
    if _device(vi).type == "cpu":
        return eval_bxdf_plain(scene, mat_pack, mat_id, vi, vr, uv, tables,
                               has_mix, has_ltc, has_textures, p0)
    p = p0 if p0 is not None else MatParams(scene, mat_pack, mat_id, uv,
                                            has_textures=has_textures)
    mats = _slots(scene, mat_pack, p, uv, has_mix, has_textures)
    return _call(_EvalFn, _Static(mats, tables, has_mix, has_ltc), vi, vr)


def sample_bxdf(scene, mat_pack, mat_id, vi, uv, u2, tables,
                has_mix=True, has_ltc=True, has_textures=True, p0=None):
    """Sample an outgoing direction.  Returns (dir, throughput, leak);
    mix lanes pick a leaf with the reference's sample-reuse split.  The
    plain version on a CPU tensor, one kernel launch on a CUDA tensor."""
    if _device(vi).type == "cpu":
        return sample_bxdf_plain(scene, mat_pack, mat_id, vi, uv, u2, tables,
                                 has_mix, has_ltc, has_textures, p0)
    if p0 is None:
        p0 = MatParams(scene, mat_pack, mat_id, uv, has_textures=has_textures)
    mats = _slots(scene, mat_pack, p0, uv, has_mix, has_textures)
    return _call(_SampleFn, _Static(mats, tables, has_mix, has_ltc), vi, u2)


def _device(vi):
    if vi.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no BxDF kernel for device {vi.device}")
    return vi.device


def _slots(scene, mat_pack, p, uv, has_mix, has_textures):
    """The kernel's material slots: the lane's, and on a scene with mixes
    its two sub-materials' (gathered as the plain eval gathers them)."""
    if not has_mix:
        return (p,)
    return (p,) + tuple(MatParams(scene, mat_pack, m, uv,
                                  has_textures=has_textures)
                        for m in (p.mix_m1, p.mix_m2))


class _Static:
    """A call's inputs that take no gradient: each slot's ior, mix amount
    (slot 0) and type column, the LTC rows and the scene's flags."""

    def __init__(self, mats, tables, has_mix, has_ltc):
        self.fixed = tuple((m.ior.detach(), m.mix_amt.detach() if k == 0
                            else None, m.row[..., 12].detach())
                           for k, m in enumerate(mats))
        self.diff = tuple(t for m in mats
                          for t in (m.diffuse, m.specular, m.roughness))
        self.rows = tables.rows if has_ltc else None
        self.has_mix, self.has_ltc = has_mix, has_ltc


def _call(fn, st, vi, second):
    """`fn`'s forward, through autograd when a floating input needs a
    gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (vi, second) + st.diff):
        return fn.apply(st, vi, second, *st.diff)
    return fn.launch(st, vi, second, st.diff)


class _EvalFn(torch.autograd.Function):
    """eval under autograd: saves its inputs, recomputes in backward."""

    @staticmethod
    def launch(st, vi, vr, diff):
        lead = vi.shape[:-1]
        n = math.prod(lead)
        a, keep = _args(st, lead, n, diff, vi=vi, vr=vr)
        f = torch.empty((n, 3), dtype=torch.float32, device=vi.device)
        a.f = f.data_ptr()
        _launch("eval", a, n, vi.device, keep)
        return f.reshape(*lead, 3)

    @staticmethod
    def forward(ctx, st, vi, vr, *diff):
        ctx.st = st
        ctx.save_for_backward(vi, vr, *diff)
        ctx.set_materialize_grads(False)
        return _EvalFn.launch(st, vi, vr, diff)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_f):
        vi, vr, *diff = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        if g_f is None or not any(need):
            return (None,) * (1 + len(need))
        lead = vi.shape[:-1]
        n = math.prod(lead)
        a, keep = _args(ctx.st, lead, n, diff, vi=vi, vr=vr)
        g_f = g_f.reshape(n, 3).contiguous()
        a.g_f = g_f.data_ptr()
        keep.append(g_f)
        grads = _grad_outputs(a, need, lead, n, vi.device, ("vi", "vr"))
        with gw.grad_phase("bxdf_bwd_ns"):
            _launch("eval_bwd", a, n, vi.device, keep)
        return (None,) + grads


class _SampleFn(torch.autograd.Function):
    """sample under autograd: saves its inputs, recomputes in backward;
    `leak` takes no gradient."""

    @staticmethod
    def launch(st, vi, u2, diff):
        lead = vi.shape[:-1]
        n = math.prod(lead)
        a, keep = _args(st, lead, n, diff, vi=vi, u2=u2)
        dev = vi.device
        d = torch.empty((n, 3), dtype=torch.float32, device=dev)
        thr = torch.empty((n, 3), dtype=torch.float32, device=dev)
        leak = torch.empty((n,), dtype=torch.bool, device=dev)
        a.dir, a.thr, a.leak = d.data_ptr(), thr.data_ptr(), leak.data_ptr()
        _launch("sample", a, n, dev, keep)
        return d.reshape(*lead, 3), thr.reshape(*lead, 3), leak.reshape(lead)

    @staticmethod
    def forward(ctx, st, vi, u2, *diff):
        ctx.st = st
        ctx.save_for_backward(vi, u2, *diff)
        ctx.set_materialize_grads(False)
        out = _SampleFn.launch(st, vi, u2, diff)
        ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_dir, g_thr, _g_leak):
        vi, u2, *diff = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        if (g_dir is None and g_thr is None) or not any(need):
            return (None,) * (1 + len(need))
        lead = vi.shape[:-1]
        n = math.prod(lead)
        a, keep = _args(ctx.st, lead, n, diff, vi=vi, u2=u2)
        for name, g in (("g_dir", g_dir), ("g_thr", g_thr)):
            if g is not None:
                g = g.reshape(n, 3).contiguous()
                setattr(a, name, g.data_ptr())
                keep.append(g)
        grads = _grad_outputs(a, need, lead, n, vi.device, ("vi", None))
        with gw.grad_phase("bxdf_bwd_ns"):
            _launch("sample_bwd", a, n, vi.device, keep)
        return (None,) + grads


# The kernel's argument struct (csrc/bxdf.cu RgkBxdfArgs).
class _Field(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_longlong)]


class _Mat(ctypes.Structure):
    _fields_ = [(name, _Field) for name in (
        "diffuse", "specular", "rough", "ior", "mix", "type")]


class _Args(ctypes.Structure):
    _fields_ = [("mat", _Mat * 3), ("vi", _Field), ("vr", _Field),
                ("u2", _Field), ("ltc_rows", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("has_mix", ctypes.c_int),
                ("has_ltc", ctypes.c_int), ("f", ctypes.c_void_p),
                ("dir", ctypes.c_void_p), ("thr", ctypes.c_void_p),
                ("leak", ctypes.c_void_p), ("g_f", ctypes.c_void_p),
                ("g_dir", ctypes.c_void_p), ("g_thr", ctypes.c_void_p),
                ("g_diffuse", ctypes.c_void_p * 3),
                ("g_specular", ctypes.c_void_p * 3),
                ("g_rough", ctypes.c_void_p * 3), ("g_vi", ctypes.c_void_p),
                ("g_vr", ctypes.c_void_p)]


def _field(t, lead, n, comps, dev, keep):
    """A per-lane field of `lead` lanes and `comps` components (0: none)
    as the kernel reads it: float32 on `dev`, lanes at a stride, a lane's
    components adjacent.  A view that cannot be read so is copied."""
    if t.dtype != torch.float32 or t.device != dev:
        raise TypeError(f"BxDF kernel fields are float32 on {dev}, got "
                        f"{t.dtype} on {t.device}")
    tail = (comps,) if comps else ()
    if t.shape != lead + tail:
        t = t.expand(lead + tail)
    t = t.reshape((n,) + tail)
    if (comps and t.stride(1) != 1) or (n > 1 and t.stride(0) == 0):
        t = t.contiguous()
    keep.append(t)
    return _Field(t.data_ptr(), t.stride(0))


def _args(st, lead, n, diff, vi, vr=None, u2=None):
    """-> (the `_Args` of a call, the tensors it points into, which the
    caller holds until its launch is queued)."""
    dev = vi.device
    keep = []
    a = _Args(n=n, has_mix=int(st.has_mix), has_ltc=int(st.has_ltc))
    for k, (ior, mix, typ) in enumerate(st.fixed):
        d, s, r = diff[3 * k:3 * k + 3]
        m = a.mat[k]
        m.diffuse = _field(d, lead, n, 3, dev, keep)
        m.specular = _field(s, lead, n, 3, dev, keep)
        m.rough = _field(r, lead, n, 0, dev, keep)
        m.ior = _field(ior, lead, n, 0, dev, keep)
        if mix is not None:
            m.mix = _field(mix, lead, n, 0, dev, keep)
        m.type = _field(typ, lead, n, 0, dev, keep)
    a.vi = _field(vi, lead, n, 3, dev, keep)
    if vr is not None:
        a.vr = _field(vr, lead, n, 3, dev, keep)
    if u2 is not None:
        a.u2 = _field(u2, lead, n, 2, dev, keep)
    if st.rows is not None:
        rows = st.rows
        if rows.shape != (2 * 64 * 64, 10) or rows.dtype != torch.float32 \
                or rows.device != dev or not rows.is_contiguous():
            raise ValueError("the LTC rows must be a contiguous float32 "
                             f"[8192, 10] table on {dev}")
        a.ltc_rows = rows.data_ptr()
        keep.append(rows)
    return a, keep


def _grad_outputs(a, need, lead, n, dev, dirs):
    """Allocates the gradients that `need` (needs_input_grad after the
    static argument: the two directions, then diffuse, specular and
    roughness a slot) asks for and points `a` at them.  -> the gradients
    in the inputs' shapes, None where not needed."""
    out = []
    for name, want in zip(dirs, need[:2]):
        if name is None or not want:
            out.append(None)
            continue
        g = torch.empty((n, 3), dtype=torch.float32, device=dev)
        setattr(a, f"g_{name}", g.data_ptr())
        out.append(g.reshape(*lead, 3))
    for k in range(len(need[2:]) // 3):
        for j, (name, comps) in enumerate((("g_diffuse", 3),
                                           ("g_specular", 3),
                                           ("g_rough", 0))):
            if not need[2 + 3 * k + j]:
                out.append(None)
                continue
            shape = (n, comps) if comps else (n,)
            g = torch.empty(shape, dtype=torch.float32, device=dev)
            getattr(a, name)[k] = g.data_ptr()
            out.append(g.reshape(*lead, comps) if comps else g.reshape(lead))
    return tuple(out)


def _on_card(dev, entry, *args):
    """Calls the library's `entry` with `args` and the current stream of
    the card `dev`, and raises unless it launched."""
    from .. import kernels

    with torch.cuda.device(dev):
        rc = entry(*args, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(rc, "BxDF")


def _launch(entry, a, n, dev, keep):
    """One launch of the kernel's `entry` over `n` lanes (none with no
    lane)."""
    from .. import kernels

    if n == 0:
        return
    _on_card(dev, getattr(kernels.load(), f"rgk_bxdf_{entry}"),
             ctypes.addressof(a))
    launches[entry] += 1
