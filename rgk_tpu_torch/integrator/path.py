"""Wavefront path tracing (port of rgk_tpu/integrator/path.py).

Three tracers share one extension step (`_extend_path`) and one vertex
shading (`_vertex_radiance`):
* `trace_wavefront_queued`, the unidirectional renders' tracer: one
  lane per pixel; each lane traces its samples back to back, starting
  the next sample's camera ray on the iteration after a path ends.
  Each iteration does, for every lane: camera ray for lanes that
  (re)start, the path's light sample, one closest-hit query, shading
  and BxDF sampling, NEE with one any-hit shadow query, and the flush
  of finished samples;
* `trace_wavefront_queued_bdpt`, the bidirectional renders' tracer
  (`reverse > 0`): every light subpath of the block at once, their
  camera splats scattered into one splat image, then the same queued
  eye walk with `reverse` eye-to-light-vertex connections a vertex;
* `trace_wavefront`, the per-sample path (`render_lanes`,
  `render_image_round`): one lane per (pixel, sample), the eye path in
  a bounce loop, light subpath and splats as above.
The physics is the reference's: per-path single light sample,
per-vertex radiance = NEE + emission (+ BDPT connections) clamped and
weighted by the contribution before the vertex, russian roulette from
vertex 2, throughput cutoff at 1e-3, light-leak guard, +-10*eps ray
offsets and sky escape at -ray_dir.

The `tint-thinglass` extension filters the NEE shadow segment through
the thin-glass panes it crosses in every tracer, and the sky escape in
`trace_wavefront_queued` only.  The reference does not tint the sky
escape of `trace_wavefront` or of the queued BDPT tracer, nor the BDPT
connections; the port follows each function as it is.

Where the loops run:
* the queued tracers are split as the reference's `while_loop` is: the
  carry `_QueuedState`, the block's inputs `_QueuedInputs` (device
  tensors), the body `_queued_step` (no host sync) and the end test
  `_queued_live` (a device bool).  On a CUDA tensor a block runs as one
  CUDA graph whose conditional WHILE node runs the captured step while
  the end test holds, the BDPT light phase before it
  (`integrator/graph.py`); on the CPU as the plain host loop
  `_queued_walk`, one sync an iteration;
* `trace_wavefront` is split as the reference's: `_lane_init`, the
  end test `_lane_live` (a device bool), the body `_lane_bounce` and
  `_lane_finish`.  Differentiable, every bounce runs (the reference's
  `lax.scan`, which autograd records; the gradient step replays forward
  and backward as one graph, `diff/graph.py`); else the host reads the
  end test before every bounce.  On the card `render_image_round` and
  the mesh's render function run the pieces as one CUDA graph with a
  conditional WHILE node (`graph.LaneGraph`, no sync, no bounce past
  the last live lane).
Every value is a pure function of (seed, pixel, sample), so a render is
bitwise repeatable, except the splat sums of a BDPT render on the card
(`_splat_image`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import bxdf as bxdf_ops
from ..ops import intersect as isect
from ..ops import lights as light_ops
from ..ops import ltc as ltc_ops
from ..ops import sampler as smp
from ..ops import textures as tex_ops
from ..ops import thinglass as tg
from ..ops import vecmath as vm
from ..ops import warps
from ..scene.camera import coords_from_direction, pixel_rays

RAY_FAR = 10000.0  # the reference Ray's default far plane
TAG_EYE, TAG_LIGHT = 1, 2  # folded into the per-bounce sample seed


class TraceResult(NamedTuple):
    radiance: torch.Tensor   # f32 [R,3] per-lane radiance estimate
    rays: torch.Tensor       # int64 [] extension rays traced (shadow,
    #                          connection and splat rays excluded)
    splat_pix: torch.Tensor  # int32 [R,K] target pixel (-1 = none)
    splat_val: torch.Tensor  # f32 [R,K,3] weight-0 splat radiance


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
    tint: bool  # the tint-thinglass extension is on and the scene has glass
    binned: str  # the route of `intersect` (`ops/intersect.binned_mode`)
    # A queued runner's phase stamps and device counts (`graph._Probe`),
    # or None on the eager route: the BDPT light phase adds its counts
    # through it, and the queued step marks its connections.
    probe: Optional[object] = None


def _setup(scene, meta, settings) -> _Setup:
    return _Setup(
        tables=ltc_ops.LTCTables(rows=scene.ltc_rows),
        mat_pack=bxdf_ops.build_mat_pack(scene.materials),
        intersect=isect.make_intersector(meta),
        depth=int(settings.recursion_max), russian=float(settings.russian),
        clamp=float(settings.clamp), n_set=max(1, int(settings.multisample)),
        tint=bool(meta.has_thinglass and settings.tint_thinglass),
        binned=isect.binned_mode(meta))


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
    """One path-extension step, shared by eye (tag 1) and light (tag 2)
    subpaths: closest hit, shading, BxDF sample, roulette and the next
    ray.  `bounce` (an int or a per-lane tensor) is the vertex index
    within the path; `russian` < 0 disables roulette (the light
    subpath).  Returns (next ray state, sp, p0, act, rays traced,
    sky_mask).  A dead lane's query has an empty window, so it gets the
    no-hit record, as the shadow queries of inactive lanes do: every use
    of its record below is masked by `alive` or `act`."""
    hit = su.intersect(scene, ro, rd, 0.0, torch.where(alive, RAY_FAR, -1.0),
                       exclude=last_tri)
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


def _tinted(scene, radiance, ro, rd, t_min, t_max, through):
    """`radiance` filtered by the thin-glass crossings of the segment
    ro + t rd, t in (t_min, t_max), oriented along `through`."""
    ts, tris = tg.collect_thinglass(scene, ro, rd, t_min, t_max)
    return tg.apply_thinglass(scene, radiance, ts, tris, through, tint=True)


def _vertex_radiance(scene, meta, su: _Setup, light, sp, p0, active=None):
    """NEE direct light + emission at one shaded vertex, before BDPT
    connections and the clamp.  `active` masks lanes whose radiance is
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
    if su.tint:
        # The shadow segment's crossings, collected light -> point with
        # the visibility query's 20*eps margins; orientation along the
        # point -> light direction, as the reference does.
        seg = sp.pos - light.pos
        dist = vm.length(seg)
        margin = scene.epsilon * 20.0
        inc = _tinted(scene, inc, light.pos,
                      seg / torch.clamp(dist, min=1e-12)[..., None], margin,
                      dist - margin, vi_l)
    total_here = torch.where((vis & light.valid)[..., None],
                             inc * f * g[..., None], 0.0)
    # Emission, front side only.
    front = vm.dot(sp.face_n, sp.vr) > 0.0
    return total_here + torch.where(front[..., None], sp.mat_row[..., 0:3],
                                    0.0)


# ----------------------------------------------------------- BDPT pieces

# The stand-in of a dropped connection or splat (`_finite_ends`): the
# other end at the origin, the light vertex one unit from it, seen
# along _STAND_IN_DIR, in the axis frame, lit by nothing.  No component
# is 0, so no axis-aligned shading frame sees that direction grazing.
_STAND_IN_DIR = (2 / 7, 3 / 7, 6 / 7)
_STAND_IN = dict(light_n=(0.0, 0.0, 1.0), t_f=(1.0, 0.0, 0.0),
                 b_f=(0.0, 1.0, 0.0), vr=(-3 / 7, 2 / 7, 6 / 7),
                 uv=(0.5, 0.5))


def _finite_ends(keep, lv, other):
    """The light vertex `lv` ([..., d] fields as in lrec) and the point
    `other` at the far end of its segment [..., 3], with every lane
    where `keep` is False swapped for the finite stand-in above.

    A dropped lane's vertex may lie at a miss's far point (|pos| ~ 3e38),
    where the geometry term and the BxDF factors of a connection or a
    splat are not finite.  A `where` on the product alone passes such a
    lane a zero gradient, which the product's backward multiplies by the
    other factors: 0 x NaN = NaN, and the NaN reaches the tables.  (The
    reference does exactly that: rgk_tpu's BDPT gradients are NaN.)
    Swapping the inputs first keeps every factor finite; a kept lane
    computes on its own values, bit for bit.  The constants are made on
    the device: a host copy would be a sync, which a capture refuses."""
    k = keep[..., None]
    one = lv["pos"][..., 0]

    def const(values):
        return torch.stack([torch.full_like(one, v) for v in values], dim=-1)

    out = dict(lv)
    out["pos"] = torch.where(k, lv["pos"], -const(_STAND_IN_DIR))
    for f, values in _STAND_IN.items():
        out[f] = torch.where(k, lv[f], const(values))
    out["light_here"] = torch.where(k, lv["light_here"], 0.0)
    return out, torch.where(k, other, 0.0)


def _trace_light_subpaths(scene, meta, settings, cam, ctx, su: _Setup,
                          light, lightdir2, reverse: int):
    """One `reverse`-vertex light subpath per lane, every vertex
    projected to the camera.

    Returns (lrec, splat_pix int32 [R,K], splat_val f32 [R,K,3], rays):
    lrec holds [K, R, ...] per-vertex tensors (valid, pos, light_n, t_f,
    b_f, vr, uv, mat_id, light_here), read by the eye walk's
    connections."""
    emission_dir = warps.to_hemisphere_cosine_directed(lightdir2,
                                                       light.normal)
    light_at_start = (light.color * light.intensity[..., None]
                      * light.directional_factor(emission_dir)[..., None])
    r, dev = light.pos.shape[0], light.pos.device
    state = dict(ro=light.pos + scene.epsilon * 100.0 * light.normal,
                 rd=emission_dir,
                 last_tri=torch.full((r,), -1, dtype=torch.int32, device=dev),
                 contribution=torch.ones((r, 3), dtype=torch.float32,
                                         device=dev),
                 alive=light.valid.clone())
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    recs = []
    for k in range(reverse):
        contrib = state["contribution"]
        state, sp, _, act, n_rays, _ = _extend_path(
            scene, meta, settings, su, ctx, state["ro"], state["rd"],
            state["last_tri"], contrib, state["alive"], k, -1.0, TAG_LIGHT)
        rays = rays + n_rays
        recs.append(dict(valid=act, pos=sp.pos, light_n=sp.light_n,
                         t_f=sp.t_f, b_f=sp.b_f, vr=sp.vr, uv=sp.uv,
                         mat_id=sp.mat_id,
                         light_here=contrib * light_at_start))
    lrec = {f: torch.stack([rec[f] for rec in recs]) for f in recs[0]}

    # Splat every light vertex to the camera: one any-hit query over
    # K*R rays (K*R*S in the queued tracer's block).  Invalid vertices
    # get an empty interval; splat_ok drops them whatever the query says,
    # so the splat image is the reference's, which traces them too.
    lpos, lvalid = lrec["pos"], lrec["valid"]         # [K,R,3], [K,R]
    campos = cam.origin.expand(lpos.shape)
    vis_cam = isect.visibility(
        scene, su.intersect, lpos.reshape(-1, 3), campos.reshape(-1, 3),
        active=lvalid.reshape(-1)).reshape(lvalid.shape)
    # An invalid or hidden vertex is dropped whatever q is; its inputs
    # are swapped for the finite stand-in, so that no non-finite q gets a
    # NaN gradient from the `where` below.
    lv, campos = _finite_ends(lvalid & vis_cam, lrec, campos)
    lpos = lv["pos"]
    direction = vm.normalize(lpos - campos)           # camera -> vertex
    frame = (lv["light_n"], lv["t_f"], lv["b_f"])
    f_cam = bxdf_ops.eval_bxdf(
        scene, su.mat_pack, lv["mat_id"].reshape(-1),
        vm.to_local(*frame, lv["vr"]).reshape(-1, 3),
        vm.to_local(*frame, -direction).reshape(-1, 3),
        lv["uv"].reshape(-1, 2), su.tables, has_mix=meta.has_mix,
        has_ltc=meta.has_ltc, has_textures=meta.has_textures,
    ).reshape(lpos.shape)
    g_cam = (torch.clamp(vm.dot(lv["light_n"], -direction), min=0.0)
             / torch.clamp(vm.distance2(campos, lpos), min=1e-12))
    q = lv["light_here"] * f_cam * g_cam[..., None]
    x2, y2, in_view = coords_from_direction(cam, direction)
    splat_ok = (lvalid & vis_cam & in_view & (g_cam >= 1e-5)
                & torch.isfinite(q).all(dim=-1))
    pix = torch.where(splat_ok, y2 * cam.xres + x2, -1).to(torch.int32)
    splat_val = torch.where(splat_ok[..., None], q, 0.0)
    return lrec, pix.T, splat_val.transpose(0, 1), rays


def _splat_image(pix, val, hw: int):
    """Scatter splats (pix int [N], -1 = none; val f32 [N, 3]) into an
    [hw + 1, 3] image whose last row takes the misses.

    The scatter order: on the CPU `index_add_` adds in the splats'
    order, so a render is bitwise repeatable; on the card it adds with
    atomics, in another order each run, so two card renders of one BDPT
    scene agree within rtol 1e-5, not bit for bit
    (tests/test_torch_cuda.py::test_splat_scatter_contract).  The
    reference states the same for its scatter ("1-ulp class")."""
    good = pix >= 0
    idx = torch.where(good, pix, hw).long()
    img = torch.zeros((hw + 1, 3), dtype=torch.float32, device=val.device)
    return img.index_add_(0, idx, torch.where(good[:, None], val, 0.0))


def _connect_to_light_vertex(scene, meta, su: _Setup, lv, sp, p0, act):
    """One eye-vertex x light-vertex connection.  `lv` holds one light
    vertex per lane ([R, ...] fields as in lrec).  No thin-glass tint,
    as in the reference."""
    l_valid, l_pos = lv["valid"], lv["pos"]
    vis_c = isect.visibility(scene, su.intersect, l_pos, sp.pos,
                             active=l_valid & act)
    # `act` is part of the test: the visibility query leaves an inactive
    # lane visible, and the caller drops that lane's sum.
    keep = l_valid & act & vis_c
    lv, p_pos = _finite_ends(keep, lv, sp.pos)
    l_pos, l_frame = lv["pos"], (lv["light_n"], lv["t_f"], lv["b_f"])
    light_to_p = vm.normalize(p_pos - l_pos)
    p_to_light = -light_to_p
    f_light = bxdf_ops.eval_bxdf(
        scene, su.mat_pack, lv["mat_id"], vm.to_local(*l_frame, light_to_p),
        vm.to_local(*l_frame, lv["vr"]), lv["uv"], su.tables,
        has_mix=meta.has_mix, has_ltc=meta.has_ltc,
        has_textures=meta.has_textures)
    f_point = bxdf_ops.eval_bxdf(
        scene, su.mat_pack, sp.mat_id, _to_local(sp, sp.vr),
        _to_local(sp, p_to_light), sp.uv, su.tables, has_mix=meta.has_mix,
        has_ltc=meta.has_ltc, has_textures=meta.has_textures, p0=p0)
    g_c = (torch.abs(vm.dot(sp.light_n, p_to_light))
           / torch.clamp(vm.distance2(l_pos, p_pos), min=1e-12))
    term = lv["light_here"] * f_light * f_point * g_c[..., None]
    return torch.where(keep[..., None], term, 0.0)


# One row of floats per (lane, sample, light vertex): valid, pos3,
# light_n3, t_f3, b_f3, vr3, uv2, mat_id, then light_here3.
_LV_F = 19
_LV_ROW = _LV_F + 3


def _pack_light_vertices(lrec, r: int, n_samples: int):
    """[K, R*S, ...] lrec (sample-outer lanes: flat index s*R + lane) ->
    [R, S, K*22] rows."""
    flat = torch.cat([
        lrec["valid"][..., None].to(torch.float32),
        lrec["pos"], lrec["light_n"], lrec["t_f"], lrec["b_f"], lrec["vr"],
        lrec["uv"], lrec["mat_id"][..., None].to(torch.float32),
        lrec["light_here"]], dim=-1)               # [K, R*S, 22]
    k = flat.shape[0]
    flat = flat.transpose(0, 1).reshape(n_samples, r, k * _LV_ROW)
    return flat.transpose(0, 1).contiguous()       # [R, S, K*22]


def _unpack_light_vertex(rows, k: int):
    """[R, K*22] packed rows -> the light-vertex dict of slot k."""
    o = k * _LV_ROW
    return dict(valid=rows[:, o] > 0.5, pos=rows[:, o + 1:o + 4],
                light_n=rows[:, o + 4:o + 7], t_f=rows[:, o + 7:o + 10],
                b_f=rows[:, o + 10:o + 13], vr=rows[:, o + 13:o + 16],
                uv=rows[:, o + 16:o + 18],
                mat_id=rows[:, o + 18].to(torch.int32),
                light_here=rows[:, o + 19:o + 22])


# --------------------------------------------------------- queued tracers

class _QueuedInputs(NamedTuple):
    """What a block feeds the queued loop.  The values that change from
    block to block or round to round are device tensors, not Python
    numbers: a captured step (integrator/graph.py) reads them from
    memory, where a Python number would be baked into the capture and
    every replay would render the first block's samples again."""
    px: torch.Tensor        # int32 [R]
    py: torch.Tensor        # int32 [R]
    pixel_id: torch.Tensor  # int64 [R] py * xres + px
    sample0: torch.Tensor   # int64 [] the block's first sample index
    s_end: torch.Tensor     # int64 [] sample0 + samples a lane
    seed: torch.Tensor      # int64 [] the root seed, a u32 value
    lpack: Optional[torch.Tensor] = None  # BDPT: f32 [R, S, K*22]


class _QueuedState(NamedTuple):
    """The queued loop's carry (the reference's `_Q`)."""
    ro: torch.Tensor            # f32 [R,3]
    rd: torch.Tensor            # f32 [R,3]
    last_tri: torch.Tensor      # int32 [R]
    contribution: torch.Tensor  # f32 [R,3]
    alive: torch.Tensor         # bool [R]
    bounce: torch.Tensor        # int64 [R] vertex index within the path
    s: torch.Tensor             # int64 [R] the lane's current sample
    sample_rad: torch.Tensor    # f32 [R,3] the in-flight sample's sum
    radiance: torch.Tensor      # f32 [R,3] flushed over finished samples
    rays: torch.Tensor          # int64 [] extension rays traced


def _queued_inputs(px, py, xres: int, sample0: int, n_samples: int,
                   seed: int, lpack=None) -> _QueuedInputs:
    """The block's inputs on the pixels' device."""
    def scalar(v):
        return torch.full((), int(v), dtype=torch.int64, device=px.device)

    return _QueuedInputs(
        px=px, py=py, pixel_id=py.long() * xres + px.long(),
        sample0=scalar(sample0), s_end=scalar(int(sample0) + int(n_samples)),
        seed=scalar(int(seed) & 0xFFFFFFFF), lpack=lpack)


def _queued_init(inp: _QueuedInputs) -> _QueuedState:
    """Every lane idle at the block's first sample, each field its own
    tensor (the graph runner copies them into its static buffers)."""
    r, dev = inp.px.shape[0], inp.px.device

    def zeros3():
        return torch.zeros((r, 3), dtype=torch.float32, device=dev)

    rd = zeros3()
    rd[:, 2] = 1.0
    return _QueuedState(
        ro=zeros3(), rd=rd,
        last_tri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        contribution=zeros3(),
        alive=torch.zeros(r, dtype=torch.bool, device=dev),
        bounce=torch.zeros(r, dtype=torch.int64, device=dev),
        s=inp.sample0.expand(r).clone(), sample_rad=zeros3(),
        radiance=zeros3(),
        rays=torch.zeros((), dtype=torch.int64, device=dev))


def _queued_live(q: _QueuedState, inp: _QueuedInputs) -> torch.Tensor:
    """The loop's end test, a bool [] on the device: some lane is on a
    path or has samples left (the reference's `cond`)."""
    return (q.alive | (q.s < inp.s_end)).any()


def _queued_step(scene, meta, settings, su: _Setup, cam, inp: _QueuedInputs,
                 q: _QueuedState, sampler_mode: int) -> _QueuedState:
    """One iteration of the queued eye walk (the reference's `body`):
    NEE when `inp.lpack` is None, else BDPT with connections to the
    light vertices of the lane's sample.  No host sync: every value
    that varies between blocks is read from `inp`.  On a state where no
    lane is live it changes no output: `need` and `act` are false, so
    ro, rd, contribution, radiance and rays keep their values (only the
    dead lanes' bounce counters move)."""
    # The reference tints the sky escape here only in the NEE tracer.
    tint_sky = su.tint and inp.lpack is None

    # 1) (Re)start lanes that are idle but still have samples.
    need = ~q.alive & (q.s < inp.s_end)
    ctx = smp.SampleCtx(seed=inp.seed, pixel=inp.pixel_id, sample=q.s,
                        mode=sampler_mode, n_set=su.n_set)
    jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
    lens = None if cam.is_simple else smp.sample_2d(ctx, smp.DIM_LENS)
    ro0, rd0 = pixel_rays(cam, inp.px, inp.py, jitter, lens_sample=lens)
    n3 = need[..., None]
    ro = torch.where(n3, ro0, q.ro)
    rd = torch.where(n3, rd0, q.rd)
    last_tri = torch.where(need, -1, q.last_tri)
    contribution = torch.where(n3, 1.0, q.contribution)
    alive = q.alive | need
    bounce = torch.where(need, 0, q.bounce)

    # 2) This sample's light.
    light = _sample_path_light(scene, ctx)

    # 3) One extension step.
    nxt, sp, p0, act, n_rays, sky_mask = _extend_path(
        scene, meta, settings, su, ctx, ro, rd, last_tri, contribution,
        alive, bounce, su.russian, TAG_EYE)

    # 4) Radiance at this vertex: sky escape or NEE + emission
    #    (+ the connections to this sample's light vertices).
    sky = tex_ops.sky_radiance(scene, -rd, has_envmap=meta.has_envmap)
    if tint_sky:
        sky = _tinted(scene, sky, ro, rd, 0.0, RAY_FAR, rd)
    sample_rad = q.sample_rad + torch.where(sky_mask[..., None],
                                            contribution * sky, 0.0)
    total_here = _vertex_radiance(scene, meta, su, light, sp, p0, active=act)
    if inp.lpack is not None:
        if su.probe is not None:
            su.probe.phase("connect")
        r = inp.px.shape[0]
        # The slot of the lane's sample, from the block's first sample
        # on the device (not a Python number, which a capture would bake).
        s_rel = torch.clamp(q.s - inp.sample0, 0, inp.lpack.shape[1] - 1)
        rows = inp.lpack[torch.arange(r, device=inp.px.device), s_rel]
        for k in range(inp.lpack.shape[2] // _LV_ROW):
            total_here = total_here + _connect_to_light_vertex(
                scene, meta, su, _unpack_light_vertex(rows, k), sp, p0, act)
        if su.probe is not None:
            su.probe.phase("eye")
    total_here = torch.clamp(total_here, max=su.clamp)
    sample_rad = sample_rad + torch.where(act[..., None],
                                          contribution * total_here, 0.0)

    # 5) Depth termination; finished paths flush the sample with the
    #    whole-sample clamp + NaN/negative scrub, then advance.
    alive_after = nxt["alive"] & (bounce + 1 < su.depth)
    ended = alive & ~alive_after
    flushed = torch.clamp(sample_rad, max=su.clamp)
    flushed = torch.where(torch.isnan(flushed) | (flushed < 0.0), 0.0,
                          flushed)
    e3 = ended[..., None]
    return _QueuedState(
        ro=nxt["ro"], rd=nxt["rd"], last_tri=nxt["last_tri"],
        contribution=nxt["contribution"], alive=alive_after,
        bounce=bounce + 1, s=torch.where(ended, q.s + 1, q.s),
        sample_rad=torch.where(e3, 0.0, sample_rad),
        radiance=q.radiance + torch.where(e3, flushed, 0.0),
        rays=q.rays + n_rays)


def _queued_walk(scene, meta, settings, su: _Setup, cam, inp: _QueuedInputs,
                 q: _QueuedState, sampler_mode: int) -> _QueuedState:
    """The queued eye walk driven from the host: the end test read
    before every step (one device-to-host sync each)."""
    while bool(_queued_live(q, inp)):
        q = _queued_step(scene, meta, settings, su, cam, inp, q, sampler_mode)
    return q


def _light_phase(scene, meta, settings, su: _Setup, cam, inp: _QueuedInputs,
                 n_samples: int, sampler_mode: int):
    """Phase 1 of the queued BDPT tracer: every (pixel, sample) light
    subpath of the block at once (R*S lanes, sample-outer), their camera
    splats scattered into one [H*W+1, 3] image (the last row takes the
    misses), and the vertex records packed per (lane, sample).  ->
    (lpack f32 [R, S, K*22], splat image, light extension rays)."""
    r = inp.px.shape[0]
    # Lane j of the flat R*S lanes traces sample sample0 + j // R.
    s_f = (torch.arange(n_samples * r, device=inp.px.device) // r
           + inp.sample0)
    ctx_f = smp.SampleCtx(seed=inp.seed, pixel=inp.pixel_id.repeat(n_samples),
                          sample=s_f, mode=sampler_mode, n_set=su.n_set)
    lrec, splat_pix, splat_val, rays = _trace_light_subpaths(
        scene, meta, settings, cam, ctx_f, su, _sample_path_light(scene, ctx_f),
        smp.sample_2d(ctx_f, smp.DIM_LIGHTDIR), int(settings.reverse))
    if su.probe is not None:
        su.probe.add("light_vertices", lrec["valid"].sum())
        su.probe.add("splats", (splat_pix >= 0).sum())
    splat_img = _splat_image(splat_pix.reshape(-1), splat_val.reshape(-1, 3),
                             cam.xres * cam.yres)
    return _pack_light_vertices(lrec, r, n_samples), splat_img, rays


def trace_wavefront_queued(scene, meta, settings, cam, px, py,
                           sample0: int, n_samples: int, seed: int,
                           sampler_mode: int = 1):
    """Trace samples sample0 .. sample0+n_samples-1 of the pixels
    (px, py), one lane per pixel, unidirectionally (`reverse` is not
    read).  `cam` and the pixel tensors live on the scene's device.
    Returns (radiance sum f32 [R,3] over the lane's samples, extension
    rays traced as an int64 scalar tensor).

    On a CUDA tensor the loop runs as one launch of a CUDA graph with a
    WHILE node (`graph.QueuedGraph`, captured for this call); on the CPU
    as the plain host loop `trace_wavefront_queued_eager`."""
    if px.device.type == "cuda":
        from .graph import QueuedGraph

        return QueuedGraph(scene, meta, settings, cam, px.shape[0],
                           n_samples, sampler_mode, seed=seed).trace(
                               px, py, sample0, seed, cam)
    return trace_wavefront_queued_eager(scene, meta, settings, cam, px, py,
                                        sample0, n_samples, seed,
                                        sampler_mode)


def trace_wavefront_queued_eager(scene, meta, settings, cam, px, py,
                                 sample0: int, n_samples: int, seed: int,
                                 sampler_mode: int = 1):
    """`trace_wavefront_queued` as the host loop of `_queued_walk` (one
    sync per iteration for the end test), on any device."""
    su = _setup(scene, meta, settings)
    inp = _queued_inputs(px, py, cam.xres, sample0, n_samples, seed)
    q = _queued_walk(scene, meta, settings, su, cam, inp, _queued_init(inp),
                     sampler_mode)
    return q.radiance, q.rays


def _check_reverse(settings):
    if int(settings.reverse) <= 0:
        raise ValueError(f"queued BDPT needs reverse > 0, got "
                         f"{int(settings.reverse)}")


def trace_wavefront_queued_bdpt(scene, meta, settings, cam, px, py,
                                sample0: int, n_samples: int, seed: int,
                                sampler_mode: int = 1):
    """Queued bidirectional tracer (`settings.reverse` > 0), one lane
    per pixel, in two phases:
    1. `_light_phase`: every (pixel, sample) light subpath of the block
       at once, their camera splats scattered once into an [H*W+1, 3]
       splat image, and the vertex records packed per (lane, sample);
    2. the queued eye walk of `trace_wavefront_queued`, which gathers
       its sample's packed row once an iteration and connects every
       eye vertex to the `reverse` stored light vertices.
    Every per-(pixel, sample) value equals `trace_wavefront`'s, since
    sampling is a pure function of (seed, pixel, sample, dim); only the
    splat sums add in another order.  Returns (radiance f32 [R,3],
    splat image f32 [H*W+1, 3], rays int64 []: light-subpath plus eye
    extensions).  On a CUDA tensor both phases run as one launch of a
    CUDA graph with a WHILE node (`graph.QueuedGraph`), on the CPU as
    `trace_wavefront_queued_bdpt_eager`.

    Sizes at the CLI's defaults (blocks of 2^20 // ms pixels): at 16 spp
    and reverse 4 a block's light phase runs on 1,048,576 lanes, its
    splat visibility query is 4,194,304 rays in one kernel launch (K1's
    and K2's int32 ray offsets hold 715 M), and the packed vertices take
    65,536 x 16 x 88 floats, 369 MB.  Each eye iteration adds `reverse`
    connections to the NEE loop's work, one any-hit query and two
    `eval_bxdf` calls each."""
    _check_reverse(settings)
    if px.device.type == "cuda":
        from .graph import QueuedGraph

        return QueuedGraph(scene, meta, settings, cam, px.shape[0],
                           n_samples, sampler_mode, seed=seed).trace(
                               px, py, sample0, seed, cam)
    return trace_wavefront_queued_bdpt_eager(scene, meta, settings, cam, px,
                                             py, sample0, n_samples, seed,
                                             sampler_mode)


def trace_wavefront_queued_bdpt_eager(scene, meta, settings, cam, px, py,
                                      sample0: int, n_samples: int,
                                      seed: int, sampler_mode: int = 1):
    """`trace_wavefront_queued_bdpt` with the eye walk as the host loop
    of `_queued_walk`, on any device."""
    _check_reverse(settings)
    su = _setup(scene, meta, settings)
    inp = _queued_inputs(px, py, cam.xres, sample0, n_samples, seed)
    lpack, splat_img, rays = _light_phase(scene, meta, settings, su, cam, inp,
                                          n_samples, sampler_mode)
    inp = inp._replace(lpack=lpack)
    q = _queued_walk(scene, meta, settings, su, cam, inp,
                     _queued_init(inp)._replace(rays=rays), sampler_mode)
    return q.radiance, splat_img, q.rays


# ------------------------------------------------------ per-sample path

class _LaneFixed(NamedTuple):
    """What every bounce of the per-sample path reads, set before the
    first (the reference's `trace_wavefront` closure)."""
    ctx: smp.SampleCtx
    light: light_ops.LightSample
    lrec: Optional[dict]     # BDPT: [K, R, ...] light vertices, else None
    splat_pix: torch.Tensor  # int32 [R,K]
    splat_val: torch.Tensor  # f32 [R,K,3]


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
    """Camera rays, the path's light, the light subpaths and their
    splats (`reverse` > 0), and the eye walk's carry at bounce 0.  ->
    (_LaneFixed, _LaneState)."""
    reverse = int(settings.reverse)
    jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
    lens = None if cam.is_simple else smp.sample_2d(ctx, smp.DIM_LENS)
    ro, rd = pixel_rays(cam, px, py, jitter, lens_sample=lens)
    # One light per path; the reference also draws DIM_LIGHT_TRI here
    # and discards it, which moves no other dimension.
    light = _sample_path_light(scene, ctx)
    r, dev = ro.shape[0], ro.device
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    lrec = None
    if reverse > 0:
        lrec, splat_pix, splat_val, rays = _trace_light_subpaths(
            scene, meta, settings, cam, ctx, su, light,
            smp.sample_2d(ctx, smp.DIM_LIGHTDIR), reverse)
    else:
        splat_pix = torch.full((r, 0), -1, dtype=torch.int32, device=dev)
        splat_val = torch.zeros((r, 0, 3), dtype=torch.float32, device=dev)
    state = _LaneState(
        ro=ro, rd=rd,
        last_tri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        contribution=torch.ones((r, 3), dtype=torch.float32, device=dev),
        alive=torch.ones(r, dtype=torch.bool, device=dev),
        radiance=torch.zeros((r, 3), dtype=torch.float32, device=dev),
        rays=rays, bounce=torch.zeros((), dtype=torch.int64, device=dev))
    return _LaneFixed(ctx=ctx, light=light, lrec=lrec, splat_pix=splat_pix,
                      splat_val=splat_val), state


def _lane_live(su: _Setup, q: _LaneState) -> torch.Tensor:
    """The eye walk's end test, a bool [] on the device: bounces left
    and some lane alive (the reference's `w_cond`)."""
    return (q.bounce < su.depth) & q.alive.any()


def _lane_bounce(scene, meta, settings, su: _Setup, f: _LaneFixed,
                 q: _LaneState, bounce) -> _LaneState:
    """One eye bounce (the reference's `eye_bounce`): extension, sky
    escape, NEE and emission, the BDPT connections.  `bounce` is the
    vertex index, a Python int or `q.bounce` (an int64 [] on the device,
    for a captured body: the same samples and roulette).  On a state
    where no lane is alive it changes nothing but `bounce`."""
    contrib, ray_dir = q.contribution, q.rd
    nxt, sp, p0, act, n_rays, sky_mask = _extend_path(
        scene, meta, settings, su, f.ctx, q.ro, ray_dir, q.last_tri,
        contrib, q.alive, bounce, su.russian, TAG_EYE)
    # Sky escape (not tinted through thin glass, as in the reference).
    sky = tex_ops.sky_radiance(scene, -ray_dir, has_envmap=meta.has_envmap)
    radiance = q.radiance + torch.where(sky_mask[..., None], contrib * sky,
                                        0.0)
    total_here = _vertex_radiance(scene, meta, su, f.light, sp, p0,
                                  active=act)
    if f.lrec is not None:
        for k in range(f.lrec["valid"].shape[0]):
            lv = {name: v[k] for name, v in f.lrec.items()}
            total_here = total_here + _connect_to_light_vertex(
                scene, meta, su, lv, sp, p0, act)
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
    return TraceResult(radiance=radiance, rays=q.rays, splat_pix=f.splat_pix,
                       splat_val=f.splat_val)


def trace_wavefront(scene, meta, settings, cam, ctx, px, py,
                    differentiable: bool = False) -> TraceResult:
    """Trace one eye path (and, with `reverse` > 0, one light subpath)
    per lane; `ctx` gives each lane's (seed, pixel, sample).

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


def _round_lanes(cam, ms: int, round_idx: int, dev):
    """One round's lanes, every pixel x `ms` samples, sample-outer:
    (px, py int32 [H*W*ms], sample_idx int64)."""
    xres, yres = cam.xres, cam.yres
    pix = torch.arange(xres * yres, device=dev)
    px = (pix % xres).to(torch.int32).repeat(ms)
    py = (pix // xres).to(torch.int32).repeat(ms)
    sample_idx = (torch.arange(ms, device=dev).repeat_interleave(xres * yres)
                  + round_idx * ms)
    return px, py, sample_idx


def _round_image(result: TraceResult, cam, ms: int):
    """A round's TraceResult -> (radiance sum f32 [H,W,3] with the
    splats added, counts f32 [H,W], rays)."""
    xres, yres = cam.xres, cam.yres
    rad = result.radiance.reshape(ms, yres, xres, 3).sum(dim=0)
    if result.splat_pix.shape[1] > 0:
        flat = _splat_image(result.splat_pix.reshape(-1),
                            result.splat_val.reshape(-1, 3), xres * yres)
        rad = rad + flat[:-1].reshape(yres, xres, 3)
    counts = torch.full((yres, xres), float(ms), dtype=torch.float32,
                        device=rad.device)
    # A copy: a runner's buffer is rewritten by its next call.
    return rad, counts, result.rays.clone()


def render_image_round(scene, meta, settings, cam, round_idx: int,
                       seed: int = 42, sampler_mode: int = 1, runner=None):
    """Render one full round (all pixels x multisample) on the scene's
    device in one batch of lanes.  Returns (radiance sum f32 [H,W,3],
    counts f32 [H,W], rays).  Splats (weight-0 side effects) are added
    into the sum.  For small and medium images; the driver blocks
    larger frames.

    On a CUDA tensor the lanes go through `runner`, a
    `graph.LaneGraph` of H*W*multisample lanes (one is built for this
    call when None; pass one to render many rounds without capturing
    again): one graph launch, no sync.  On the CPU the same as
    `render_image_round_eager`."""
    dev = scene.tri_pack.device
    if dev.type != "cuda":
        return render_image_round_eager(scene, meta, settings, cam,
                                        round_idx, seed, sampler_mode)
    from .graph import LaneGraph

    ms = int(settings.multisample)
    cam = cam.to(dev)
    px, py, sample_idx = _round_lanes(cam, ms, round_idx, dev)
    if runner is None:
        runner = LaneGraph(scene, meta, settings, cam, px.shape[0],
                           sampler_mode, seed=seed)
    return _round_image(runner.trace(px, py, sample_idx, seed, cam), cam, ms)


def render_image_round_eager(scene, meta, settings, cam, round_idx: int,
                             seed: int = 42, sampler_mode: int = 1):
    """`render_image_round` through `render_lanes` (the host bounce
    loop, one sync a bounce), on any device."""
    ms = int(settings.multisample)
    dev = scene.tri_pack.device
    cam = cam.to(dev)
    px, py, sample_idx = _round_lanes(cam, ms, round_idx, dev)
    result = render_lanes(scene, meta, settings, cam, px, py, sample_idx,
                          seed, sampler_mode)
    return _round_image(result, cam, ms)
