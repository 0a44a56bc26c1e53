"""Queued wavefront path tracing (port of the unidirectional tracer of
rgk_tpu/integrator/path.py).

One lane per pixel; each lane traces its samples back to back,
starting the next sample's camera ray on the iteration after a path
ends.  Each iteration of the loop does, for every lane: camera ray for
lanes that (re)start, the path's light sample, one closest-hit query,
shading and BxDF sampling, NEE with one any-hit shadow query, and the
flush of finished samples.  The physics is the reference's: per-path
single light sample, per-vertex radiance = NEE + emission clamped and
weighted by the contribution before the vertex, russian roulette from
vertex 2, throughput cutoff at 1e-3, light-leak guard, +-10*eps ray
offsets and sky escape at -ray_dir.

The loop runs on the host: its condition costs one device-to-host sync
per iteration.  Every value is a pure function of (seed, pixel, sample),
so a render is bitwise repeatable.

Not ported yet (raise NotImplementedError): bidirectional paths
(`reverse > 0`) and the `tint-thinglass` extension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bxdf as bxdf_ops
from ..ops import intersect as isect
from ..ops import lights as light_ops
from ..ops import ltc as ltc_ops
from ..ops import sampler as smp
from ..ops import textures as tex_ops
from ..ops import vecmath as vm
from ..scene.camera import pixel_rays

RAY_FAR = 10000.0  # the reference Ray's default far plane


def check_supported(settings, meta) -> None:
    """Raise for the settings this slice does not render."""
    if int(settings.reverse) > 0:
        raise NotImplementedError(
            "bidirectional rendering (reverse > 0, rgk_tpu/integrator/"
            "path.py trace_wavefront_queued_bdpt) is not ported yet")
    if meta.has_thinglass and bool(settings.tint_thinglass):
        raise NotImplementedError(
            "tint-thinglass (rgk_tpu/ops/thinglass.py) is not ported yet")


class ShadePoint(NamedTuple):
    """Geometry + material data at a hit, lane-parallel."""
    ok: torch.Tensor       # hit & usable normal
    pos: torch.Tensor
    face_n: torch.Tensor   # interpolated vertex normal
    light_n: torch.Tensor  # bump-tilted shading normal
    t_f: torch.Tensor      # shading frame tangent
    b_f: torch.Tensor      # shading frame bitangent
    vr: torch.Tensor       # toward the previous vertex (unit)
    uv: torch.Tensor
    mat_id: torch.Tensor
    mat_row: torch.Tensor  # material pack row [.,20]
    tri: torch.Tensor


def _shade_point(scene, meta, settings, hit, ro, rd, mat_pack) -> ShadePoint:
    """Interpolate attributes and build the shading frame at `hit`."""
    tri = torch.clamp(hit.tri, min=0).long()
    mat_id = scene.tri_meta[tri][..., 3]
    mat_row = mat_pack[mat_id.long()]
    srow = scene.tri_shade[tri]
    ba = 1.0 - hit.bary_b - hit.bary_c
    pos = ro + rd * hit.t[..., None]
    vr = -rd

    wa = ba[..., None]
    wb = hit.bary_b[..., None]
    wc = hit.bary_c[..., None]
    na, nb, nc = srow[..., 0:3], srow[..., 3:6], srow[..., 6:9]
    face_n_raw = wa * na + wb * nb + wc * nc
    # NaN-normal fallback chain: vertex A's, then B's, then C's normal;
    # only all-NaN or an exactly zero-length normal kills the lane.
    for cand in (na, nb, nc):
        is_nan = torch.isnan(face_n_raw).any(dim=-1, keepdim=True)
        face_n_raw = torch.where(is_nan, cand, face_n_raw)
    n_ok = vm.dot(face_n_raw, face_n_raw) > 0.0  # False for NaN too
    face_n = vm.safe_normalize(face_n_raw)
    uv = (wa * srow[..., 9:11] + wb * srow[..., 11:13]
          + wc * srow[..., 13:15])

    light_n = face_n
    if meta.has_textures:
        bump_tex = mat_row[..., 17].to(torch.int32)
        has_bump = bump_tex >= 0
        s_right, s_bottom = tex_ops.bump_slopes(
            scene.textures, torch.clamp(bump_tex, min=0), uv)
        tangent = (wa * srow[..., 15:18] + wb * srow[..., 18:21]
                   + wc * srow[..., 21:24])
        t_ok = vm.dot(tangent, tangent) >= 1e-3
        tangent = vm.safe_normalize(tangent)
        bitangent = vm.safe_normalize(vm.cross(face_n, tangent))
        tangent2 = vm.cross(bitangent, face_n)
        tilted = vm.safe_normalize(
            face_n + (tangent2 * s_right[..., None]
                      + bitangent * s_bottom[..., None])
            * float(settings.bumpmap_scale),
            fallback=face_n)
        light_n = torch.where((has_bump & t_ok)[..., None], tilted, face_n)

    t_f, b_f = vm.build_onb(light_n)
    return ShadePoint(ok=hit.valid & n_ok, pos=pos, face_n=face_n,
                      light_n=light_n, t_f=t_f, b_f=b_f, vr=vr, uv=uv,
                      mat_id=mat_id, mat_row=mat_row, tri=tri)


def _to_local(sp: ShadePoint, v):
    return vm.to_local(sp.light_n, sp.t_f, sp.b_f, v)


def _extend_path(scene, meta, tables, mat_pack, intersect, ctx, ro, rd,
                 last_tri, contribution, alive, bounce, russian, settings):
    """One eye-path extension step: closest hit, shading, BxDF sample,
    roulette and the next ray.  Returns (next ray state, sp, p0, act,
    rays traced, sky_mask)."""
    hit = intersect(scene, ro, rd, 0.0, RAY_FAR, exclude=last_tri)
    rays = alive.sum()

    sky_mask = alive & ~hit.valid
    sp = _shade_point(scene, meta, settings, hit, ro, rd, mat_pack)
    act = alive & sp.ok

    # Per-bounce dims: (tag 1 = eye path, bounce) folded into the seed.
    bctx = ctx._replace(seed=smp.hash_u32(ctx.seed, 1, bounce + 1), mode=0)
    u2 = smp.sample_2d(bctx, smp.DIM_EYE_BOUNCE)
    rr_u = smp.sample_1d(bctx, smp.DIM_EYE_BOUNCE + 2)

    p0 = bxdf_ops.MatParams(scene, mat_pack, sp.mat_id, sp.uv,
                            row=sp.mat_row, has_textures=meta.has_textures)
    dir_local, transfer, may_leak = bxdf_ops.sample_bxdf(
        scene, mat_pack, sp.mat_id, _to_local(sp, sp.vr), sp.uv, u2, tables,
        has_mix=meta.has_mix, has_ltc=meta.has_ltc,
        has_textures=meta.has_textures, p0=p0)
    inside = dir_local[..., 2] < 0.0
    dir_world = vm.to_global(sp.light_n, sp.t_f, sp.b_f, dir_local)

    same_sign = (vm.dot(dir_world, sp.face_n)
                 * vm.dot(sp.vr, sp.face_n)) > 0.0
    leak_kill = ~same_sign & ~may_leak

    no_russian = sp.mat_row[..., 18] > 0.5
    vertex_n = bounce + 1
    if russian > 0.0:
        rus_coeff = torch.where(~no_russian & (vertex_n > 1),
                                1.0 / russian, 1.0)
    else:
        rus_coeff = torch.ones_like(rr_u)
    new_contribution = torch.where(
        act[..., None], contribution * rus_coeff[..., None] * transfer,
        contribution)
    cum_low = new_contribution.amax(dim=-1) < 1e-3
    if russian >= 0.0:
        rr_kill = ~no_russian & (rr_u > russian)
    else:
        rr_kill = torch.zeros_like(act)
    alive_next = act & ~cum_low & ~rr_kill & ~leak_kill

    offset = (scene.epsilon * 10.0
              * torch.where(inside, -1.0, 1.0))[..., None] * sp.face_n
    a3 = act[..., None]
    nxt = dict(ro=torch.where(a3, sp.pos + offset, ro),
               rd=torch.where(a3, vm.safe_normalize(dir_world), rd),
               last_tri=torch.where(act, hit.tri, last_tri),
               contribution=new_contribution, alive=alive_next)
    return nxt, sp, p0, act, rays, sky_mask


def _sample_path_light(scene, ctx):
    """The path's single light sample."""
    areal2 = smp.sample_2d(ctx, smp.DIM_AREAL)
    choice2 = smp.sample_2d(ctx, smp.DIM_LIGHT_CHOICE)
    light = light_ops.sample_light(scene, choice2, areal2)
    return light_ops.offset_sphere_light(light, areal2)


def _vertex_radiance(scene, meta, tables, mat_pack, intersect, light, sp,
                     p0, active=None):
    """NEE direct light + emission at one shaded vertex, before the
    clamp.  `active` masks lanes whose radiance is consumed; the others
    get an empty shadow interval."""
    to_light = light.pos - sp.pos
    dist2 = torch.clamp(vm.dot(to_light, to_light), min=1e-12)
    vi_l = to_light / torch.sqrt(dist2)[..., None]
    vis = isect.visibility(scene, intersect, light.pos, sp.pos,
                           active=active)
    f = bxdf_ops.eval_bxdf(scene, mat_pack, sp.mat_id,
                           _to_local(sp, vi_l), _to_local(sp, sp.vr), sp.uv,
                           tables, has_mix=meta.has_mix, has_ltc=meta.has_ltc,
                           has_textures=meta.has_textures, p0=p0)
    g = torch.abs(vm.dot(sp.light_n, vi_l)) / dist2
    inc = (light.color * light.intensity[..., None]
           * light.directional_factor(-vi_l)[..., None])
    total_here = torch.where((vis & light.valid)[..., None],
                             inc * f * g[..., None], 0.0)
    # Emission, front side only.
    front = vm.dot(sp.face_n, sp.vr) > 0.0
    return total_here + torch.where(front[..., None], sp.mat_row[..., 0:3],
                                    0.0)


def trace_wavefront_queued(scene, meta, settings, cam, px, py,
                           sample0: int, n_samples: int, seed: int,
                           sampler_mode: int = 1):
    """Trace samples sample0 .. sample0+n_samples-1 of the pixels
    (px, py), one lane per pixel.  `cam` and the pixel tensors live on
    the scene's device.  Returns (radiance sum f32 [R,3] over the
    lane's samples, extension rays traced as an int64 scalar tensor)."""
    check_supported(settings, meta)
    tables = ltc_ops.LTCTables(rows=scene.ltc_rows)
    mat_pack = bxdf_ops.build_mat_pack(scene.materials)
    intersect = isect.make_intersector(meta)
    depth = int(settings.recursion_max)
    russian = float(settings.russian)
    clamp = float(settings.clamp)
    n_set = max(1, int(settings.multisample))
    r, dev = px.shape[0], px.device

    pixel_id = py.long() * cam.xres + px.long()
    s_end = int(sample0) + int(n_samples)
    seed = int(seed) & 0xFFFFFFFF

    zeros3 = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    ro = zeros3
    rd = zeros3 + zeros3.new_tensor([0.0, 0.0, 1.0])
    last_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    contribution = zeros3
    alive = torch.zeros(r, dtype=torch.bool, device=dev)
    bounce = torch.zeros(r, dtype=torch.int64, device=dev)
    s = torch.full((r,), int(sample0), dtype=torch.int64, device=dev)
    sample_rad = zeros3
    radiance = zeros3
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    # Host loop: one device->host sync per iteration for its condition.
    while bool((alive | (s < s_end)).any()):
        # 1) (Re)start lanes that are idle but still have samples.
        need = ~alive & (s < s_end)
        ctx = smp.SampleCtx(seed=seed, pixel=pixel_id, sample=s,
                            mode=sampler_mode, n_set=n_set)
        jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
        lens = None if cam.is_simple else smp.sample_2d(ctx, smp.DIM_LENS)
        ro0, rd0 = pixel_rays(cam, px, py, jitter, lens_sample=lens)
        n3 = need[..., None]
        ro = torch.where(n3, ro0, ro)
        rd = torch.where(n3, rd0, rd)
        last_tri = torch.where(need, -1, last_tri)
        contribution = torch.where(n3, 1.0, contribution)
        alive = alive | need
        bounce = torch.where(need, 0, bounce)

        # 2) This sample's light.
        light = _sample_path_light(scene, ctx)

        # 3) One extension step.
        nxt, sp, p0, act, n_rays, sky_mask = _extend_path(
            scene, meta, tables, mat_pack, intersect, ctx, ro, rd,
            last_tri, contribution, alive, bounce, russian, settings)
        rays = rays + n_rays

        # 4) Radiance at this vertex: sky escape or NEE + emission.
        sky = tex_ops.sky_radiance(scene, -rd, has_envmap=meta.has_envmap)
        sample_rad = sample_rad + torch.where(sky_mask[..., None],
                                              contribution * sky, 0.0)
        total_here = _vertex_radiance(scene, meta, tables, mat_pack,
                                      intersect, light, sp, p0, active=act)
        total_here = torch.clamp(total_here, max=clamp)
        sample_rad = sample_rad + torch.where(act[..., None],
                                              contribution * total_here, 0.0)

        # 5) Depth termination; finished paths flush the sample with the
        #    whole-sample clamp + NaN/negative scrub, then advance.
        alive_after = nxt["alive"] & (bounce + 1 < depth)
        ended = alive & ~alive_after
        flushed = torch.clamp(sample_rad, max=clamp)
        flushed = torch.where(torch.isnan(flushed) | (flushed < 0.0), 0.0,
                              flushed)
        e3 = ended[..., None]
        ro, rd = nxt["ro"], nxt["rd"]
        last_tri = nxt["last_tri"]
        contribution = nxt["contribution"]
        alive = alive_after
        bounce = bounce + 1
        s = torch.where(ended, s + 1, s)
        sample_rad = torch.where(e3, 0.0, sample_rad)
        radiance = radiance + torch.where(e3, flushed, 0.0)
    return radiance, rays
