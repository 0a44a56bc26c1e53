"""Per-sample path tracing, the plain reference's copy of the
renderer's per-sample path (`render_lanes`, `trace_wavefront`): one
lane per (pixel, sample), the eye path in a host bounce loop.  Only
unidirectional scenes (`reverse` 0, no thin glass): `render.load`
refuses the others.

The physics: per-path single light sample, per-vertex radiance = NEE +
emission clamped and weighted by the contribution before the vertex, russian roulette from vertex 2, throughput cutoff at
1e-3, light-leak guard, +-10*eps ray offsets and sky escape at
-ray_dir.  Every value is a pure function of (seed, pixel, sample), so
the sum of a pixel's samples is the same whether the renderer traced
them one lane each or back to back in one lane.
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
TAG_EYE = 1  # folded into the per-bounce sample seed


class TraceResult(NamedTuple):
    radiance: torch.Tensor   # f32 [R,3] per-lane radiance estimate
    rays: torch.Tensor       # int64 [] extension rays traced (shadow
    #                          rays excluded)


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


class _Setup(NamedTuple):
    """What every tracer reads of a scene and its settings."""
    tables: ltc_ops.LTCTables
    mat_pack: torch.Tensor
    intersect: object
    depth: int
    russian: float
    clamp: float
    n_set: int


def _setup(scene, meta, settings) -> _Setup:
    return _Setup(
        tables=ltc_ops.LTCTables(rows=scene.ltc_rows),
        mat_pack=bxdf_ops.build_mat_pack(scene.materials),
        intersect=isect.make_intersector(meta),
        depth=int(settings.recursion_max), russian=float(settings.russian),
        clamp=float(settings.clamp), n_set=max(1, int(settings.multisample)))


def _shade_point(scene, meta, settings, hit, ro, rd, mat_pack) -> ShadePoint:
    """Interpolate attributes and build the shading frame at `hit`."""
    tri = torch.clamp(hit.tri, min=0)
    mat_id = vm.take_rows(scene.tri_meta, tri)[..., 3]
    mat_row = vm.take_rows(mat_pack, mat_id)
    srow = vm.take_rows(scene.tri_shade, tri)
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


def _extend_path(scene, meta, settings, su: _Setup, ctx, ro, rd, last_tri,
                 contribution, alive, bounce, russian, tag):
    """One eye-path extension step (`tag` 1): closest hit, shading,
    BxDF sample, roulette and the next ray.  `bounce` (an int or a
    per-lane tensor) is the vertex index within the path; `russian` < 0
    disables roulette.  Returns (next ray state, sp, p0, act, rays traced,
    sky_mask)."""
    hit = su.intersect(scene, ro, rd, 0.0, RAY_FAR, exclude=last_tri)
    rays = alive.sum()

    sky_mask = alive & ~hit.valid
    sp = _shade_point(scene, meta, settings, hit, ro, rd, su.mat_pack)
    act = alive & sp.ok

    # Per-bounce dims: (tag, bounce) folded into the seed.
    bctx = ctx._replace(seed=smp.hash_u32(ctx.seed, tag, bounce + 1), mode=0)
    u2 = smp.sample_2d(bctx, smp.DIM_EYE_BOUNCE)
    rr_u = smp.sample_1d(bctx, smp.DIM_EYE_BOUNCE + 2)

    p0 = bxdf_ops.MatParams(scene, su.mat_pack, sp.mat_id, sp.uv,
                            row=sp.mat_row, has_textures=meta.has_textures)
    dir_local, transfer, may_leak = bxdf_ops.sample_bxdf(
        scene, su.mat_pack, sp.mat_id, _to_local(sp, sp.vr), sp.uv, u2,
        su.tables, has_mix=meta.has_mix, has_ltc=meta.has_ltc,
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


def _vertex_radiance(scene, meta, su: _Setup, light, sp, p0, active=None):
    """NEE direct light + emission at one shaded vertex, before the
    clamp.  `active` masks lanes whose radiance is
    consumed; the others get an empty shadow interval."""
    to_light = light.pos - sp.pos
    dist2 = torch.clamp(vm.dot(to_light, to_light), min=1e-12)
    vi_l = to_light / torch.sqrt(dist2)[..., None]
    vis = isect.visibility(scene, su.intersect, light.pos, sp.pos,
                           active=active)
    f = bxdf_ops.eval_bxdf(scene, su.mat_pack, sp.mat_id,
                           _to_local(sp, vi_l), _to_local(sp, sp.vr), sp.uv,
                           su.tables, has_mix=meta.has_mix,
                           has_ltc=meta.has_ltc,
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


# ------------------------------------------------------ per-sample path

class _LaneFixed(NamedTuple):
    """What every bounce of the per-sample path reads, set before the
    first (the reference's `trace_wavefront` closure)."""
    ctx: smp.SampleCtx
    light: light_ops.LightSample


class _LaneState(NamedTuple):
    """The eye walk's carry (the reference's `w_cond` / `w_body` carry)."""
    ro: torch.Tensor            # f32 [R,3]
    rd: torch.Tensor            # f32 [R,3]
    last_tri: torch.Tensor      # int32 [R]
    contribution: torch.Tensor  # f32 [R,3]
    alive: torch.Tensor         # bool [R]
    radiance: torch.Tensor      # f32 [R,3]
    rays: torch.Tensor          # int64 [] extension rays traced
    bounce: torch.Tensor        # int64 [] the next bounce's index


def _lane_init(scene, meta, settings, su: _Setup, cam, ctx, px, py):
    """Camera rays, the path's light and the eye walk's carry at
    bounce 0.  -> (_LaneFixed, _LaneState)."""
    jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
    lens = None if cam.is_simple else smp.sample_2d(ctx, smp.DIM_LENS)
    ro, rd = pixel_rays(cam, px, py, jitter, lens_sample=lens)
    # One light per path; the reference also draws DIM_LIGHT_TRI here
    # and discards it, which moves no other dimension.
    light = _sample_path_light(scene, ctx)
    r, dev = ro.shape[0], ro.device
    state = _LaneState(
        ro=ro, rd=rd,
        last_tri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        contribution=torch.ones((r, 3), dtype=torch.float32, device=dev),
        alive=torch.ones(r, dtype=torch.bool, device=dev),
        radiance=torch.zeros((r, 3), dtype=torch.float32, device=dev),
        rays=torch.zeros((), dtype=torch.int64, device=dev),
        bounce=torch.zeros((), dtype=torch.int64, device=dev))
    return _LaneFixed(ctx=ctx, light=light), state


def _lane_live(su: _Setup, q: _LaneState) -> torch.Tensor:
    """The eye walk's end test, a bool [] on the device: bounces left
    and some lane alive (the reference's `w_cond`)."""
    return (q.bounce < su.depth) & q.alive.any()


def _lane_bounce(scene, meta, settings, su: _Setup, f: _LaneFixed,
                 q: _LaneState, bounce) -> _LaneState:
    """One eye bounce (the reference's `eye_bounce`): extension, sky
    escape, NEE and emission.  `bounce` is the
    vertex index, a Python int or `q.bounce` (an int64 [] on the device,
    for a captured body: the same samples and roulette).  On a state
    where no lane is alive it changes nothing but `bounce`."""
    contrib, ray_dir = q.contribution, q.rd
    nxt, sp, p0, act, n_rays, sky_mask = _extend_path(
        scene, meta, settings, su, f.ctx, q.ro, ray_dir, q.last_tri,
        contrib, q.alive, bounce, su.russian, TAG_EYE)
    # Sky escape.
    sky = tex_ops.sky_radiance(scene, -ray_dir, has_envmap=meta.has_envmap)
    radiance = q.radiance + torch.where(sky_mask[..., None], contrib * sky,
                                        0.0)
    total_here = _vertex_radiance(scene, meta, su, f.light, sp, p0,
                                  active=act)
    total_here = torch.clamp(total_here, max=su.clamp)
    radiance = radiance + torch.where(act[..., None],
                                      contrib * total_here, 0.0)
    return _LaneState(ro=nxt["ro"], rd=nxt["rd"], last_tri=nxt["last_tri"],
                      contribution=nxt["contribution"], alive=nxt["alive"],
                      radiance=radiance, rays=q.rays + n_rays,
                      bounce=q.bounce + 1)


def _lane_finish(su: _Setup, f: _LaneFixed, q: _LaneState) -> TraceResult:
    """Final clamp + NaN/negative scrub."""
    radiance = torch.clamp(q.radiance, max=su.clamp)
    radiance = torch.where(torch.isnan(radiance) | (radiance < 0.0), 0.0,
                           radiance)
    return TraceResult(radiance=radiance, rays=q.rays)


def trace_wavefront(scene, meta, settings, cam, ctx, px, py,
                    differentiable: bool = False) -> TraceResult:
    """Trace one eye path per lane; `ctx` gives each lane's (seed, pixel, sample).

    `differentiable` keeps the reference's meaning: True runs all
    `recursion_max` bounces (its `lax.scan`, which autograd records);
    False is its `while_loop`, the host reading `_lane_live` before
    every bounce (one device-to-host sync each; `graph.LaneGraph` runs
    the same pieces on the card with the test on the device).  The
    values are the same either way: a dead lane adds nothing."""
    su = _setup(scene, meta, settings)
    f, q = _lane_init(scene, meta, settings, su, cam, ctx, px, py)
    if differentiable:
        for bounce in range(su.depth):
            q = _lane_bounce(scene, meta, settings, su, f, q, bounce)
    else:
        bounce = 0
        while bool(_lane_live(su, q)):
            q = _lane_bounce(scene, meta, settings, su, f, q, bounce)
            bounce += 1
    return _lane_finish(su, f, q)


def render_lanes(scene, meta, settings, cam, px, py, sample_idx, seed,
                 sampler_mode: int = 1, differentiable: bool = False):
    """Render a batch of lanes: px, py int [R], sample_idx int [R]
    (globally unique per round x multisample), seed a u32."""
    pixel_id = py.long() * cam.xres + px.long()
    ctx = smp.SampleCtx(seed=int(seed) & 0xFFFFFFFF, pixel=pixel_id,
                        sample=sample_idx.long(), mode=sampler_mode,
                        n_set=max(1, int(settings.multisample)))
    return trace_wavefront(scene, meta, settings, cam, ctx, px, py,
                           differentiable=differentiable)
