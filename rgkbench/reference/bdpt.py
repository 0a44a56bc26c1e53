"""The plain reference's bidirectional path (`reverse` > 0): one round's
splat image and the eye paths of a set of pixels with their
connections, for the `bdpt` window driver.

A copy of the renderer's per-sample BDPT path (`rgk_tpu_torch`'s
`integrator/path.py`: `_lane_init` with `reverse` > 0,
`_trace_light_subpaths`, `_connect_to_light_vertex`, `_lane_bounce`),
written over the reference's own unidirectional pieces
(`integrator/path.py`: the extension step, NEE and emission, the
clamp), sampler, shading, lights and ray queries.  What makes it
independent is the repo's CPU tests, which hold the renderer's BDPT
path against the JAX package it was ported from (`tests/test_bdpt.py`,
`tests/test_torch_bdpt.py`).

Every value is a pure function of (seed, pixel, sample): the light
subpath of (pixel, sample) is the one whose vertices that sample's eye
path connects to, and whose vertices splat to the camera.  A round's
image is, at each pixel, the eye paths' sum plus every splat that lands
there, from the light subpaths of every pixel.  So `splat_image` traces
the light subpaths of every (pixel, sample) of the round, and
`pixel_sums` traces the eye paths of the pixels asked for, each with
its own light subpath again.

Departures from the renderer's per-sample path:
* no finite stand-in for dropped connections and splats
  (`_finite_ends`): a dropped lane's term is masked by a `where` alone.
  The stand-in keeps gradients finite; the forward values of the kept
  lanes are the same, and the reference takes no gradient here;
* the splats are summed in float64 in the lanes' order, where the
  renderer adds float32 with atomics on the card, in another order each
  run; the eye sums are float64 too;
* dead lanes trace their stale ray to the far plane, where the renderer
  gives them an empty window: their results are masked either way;
* thin glass is refused, as by the unidirectional reference; TF32 is
  off in every entry point (the reference makes no matrix product, but
  a change to it could).

`load` reads the scene through the reference's unchanged loaders, with
`Config.install`'s refusal of `reverse` > 0 turned round (`BdptConfig`);
the unidirectional reference, `render.load`, keeps refusing it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .integrator import path as upath
from .ops import bxdf as bxdf_ops
from .ops import intersect as isect
from .ops import sampler as smp
from .ops import textures as tex_ops
from .ops import vecmath as vm
from .ops import warps
from .scene import config
from .scene.json_utils import ConfigError

LANES = 1 << 18  # lanes of one batch, eye paths or light subpaths
TAG_LIGHT = 2    # folded into the light subpath's per-bounce sample seed


class BdptConfig(config.Config):
    """`config.Config` whose `install` refuses thin glass and
    unidirectional scenes, which `render.load` takes."""

    def install(self, builder) -> None:
        if self.settings.thinglass or int(self.settings.reverse) <= 0:
            raise ConfigError("the BDPT reference traces bidirectional "
                              "paths without thin glass only")
        self.install_materials(builder)
        self.install_scene(builder)
        self.install_lights(builder)
        self.install_sky(builder)


@contextlib.contextmanager
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def load(scene_path: str, device):
    """-> (settings, scene arrays, meta, camera) of the scene at
    `scene_path` on `device`, `reverse` > 0 allowed."""
    cfg = BdptConfig(scene_path)
    scene, meta = config.build_scene(cfg, device)
    cam = cfg.get_camera()
    cfg.post_check()
    return cfg.settings, scene, meta, cam.to(device)


# ------------------------------------------------------- light subpaths

def _hemisphere_cosine_directed(sample, direction):
    """Cosine-weighted hemisphere around the unit `direction`: the Y-up
    warp turned by `rotation_from_y`."""
    p = warps.to_disc_uniform(sample)
    y = torch.sqrt(torch.clamp(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2,
                               min=1e-5))
    return vm.rotation_from_y(direction,
                              torch.stack([p[..., 0], y, p[..., 1]], dim=-1))


def _coords_from_direction(cam, dirs):
    """World directions from the camera origin -> (x int32, y int32,
    in_view bool): the view plane's distance guards q = dot(dir,
    forward) at 1e-12, x and y are truncated toward zero, then clipped."""
    n = cam.direction
    q = vm.dot(dirs, n)
    t = vm.dot(cam.viewscreen - cam.origin, n) / torch.where(
        torch.abs(q) > 1e-12, q, 1e-12)
    p = cam.origin + dirs * t[..., None]
    vp = p - cam.viewscreen
    x_ratio = vm.dot(vp, cam.viewscreen_x) / vm.dot(cam.viewscreen_x,
                                                    cam.viewscreen_x)
    y_ratio = vm.dot(vp, cam.viewscreen_y) / vm.dot(cam.viewscreen_y,
                                                    cam.viewscreen_y)
    in_view = ((q >= 1e-4) & (t > 0) & (x_ratio >= 0.0) & (x_ratio <= 1.0)
               & (y_ratio >= 0.0) & (y_ratio <= 1.0))
    x = torch.clamp((cam.xres * x_ratio).to(torch.int32), 0, cam.xres - 1)
    y = torch.clamp((cam.yres * y_ratio).to(torch.int32), 0, cam.yres - 1)
    return x, y, in_view


def _light_subpaths(scene, meta, settings, cam, su, ctx, light):
    """One `reverse`-vertex light subpath per lane from the path's light
    `light`, and its vertices' splats.  -> (lrec: [K, R, ...] vertex
    fields, splat pixel int64 [K, R] (-1: none), splat value f32
    [K, R, 3], light extension rays)."""
    reverse = int(settings.reverse)
    emission_dir = _hemisphere_cosine_directed(
        smp.sample_2d(ctx, smp.DIM_LIGHTDIR), light.normal)
    light_at_start = (light.color * light.intensity[..., None]
                      * light.directional_factor(emission_dir)[..., None])
    r, dev = light.pos.shape[0], light.pos.device
    state = dict(ro=light.pos + scene.epsilon * 100.0 * light.normal,
                 rd=emission_dir,
                 last_tri=torch.full((r,), -1, dtype=torch.int32, device=dev),
                 contribution=torch.ones((r, 3), dtype=torch.float32,
                                         device=dev),
                 alive=light.valid.clone())
    rays = 0
    recs = []
    for k in range(reverse):
        contrib = state["contribution"]
        state, sp, _, act, n_rays, _ = upath._extend_path(
            scene, meta, settings, su, ctx, state["ro"], state["rd"],
            state["last_tri"], contrib, state["alive"], k, -1.0, TAG_LIGHT)
        rays += int(n_rays)
        recs.append(dict(valid=act, pos=sp.pos, light_n=sp.light_n,
                         t_f=sp.t_f, b_f=sp.b_f, vr=sp.vr, uv=sp.uv,
                         mat_id=sp.mat_id,
                         light_here=contrib * light_at_start))
    lrec = {f: torch.stack([rec[f] for rec in recs]) for f in recs[0]}

    # Every light vertex seen from the camera: one visibility query.
    lpos, lvalid = lrec["pos"], lrec["valid"]            # [K,R,3], [K,R]
    campos = cam.origin.expand(lpos.shape)
    vis_cam = isect.visibility(
        scene, su.intersect, lpos.reshape(-1, 3), campos.reshape(-1, 3),
        active=lvalid.reshape(-1)).reshape(lvalid.shape)
    direction = vm.normalize(lpos - campos)              # camera -> vertex
    frame = (lrec["light_n"], lrec["t_f"], lrec["b_f"])
    f_cam = bxdf_ops.eval_bxdf(
        scene, su.mat_pack, lrec["mat_id"].reshape(-1),
        vm.to_local(*frame, lrec["vr"]).reshape(-1, 3),
        vm.to_local(*frame, -direction).reshape(-1, 3),
        lrec["uv"].reshape(-1, 2), su.tables, has_mix=meta.has_mix,
        has_ltc=meta.has_ltc, has_textures=meta.has_textures,
    ).reshape(lpos.shape)
    g_cam = (torch.clamp(vm.dot(lrec["light_n"], -direction), min=0.0)
             / torch.clamp(vm.distance2(campos, lpos), min=1e-12))
    q = lrec["light_here"] * f_cam * g_cam[..., None]
    x2, y2, in_view = _coords_from_direction(cam, direction)
    ok = (lvalid & vis_cam & in_view & (g_cam >= 1e-5)
          & torch.isfinite(q).all(dim=-1))
    pix = torch.where(ok, y2.long() * cam.xres + x2.long(), -1)
    return lrec, pix, torch.where(ok[..., None], q, 0.0), rays


def _lanes_ctx(settings, cam, seed, pix, sample, sampler_mode):
    return smp.SampleCtx(seed=int(seed) & 0xFFFFFFFF, pixel=pix,
                         sample=sample, mode=sampler_mode,
                         n_set=max(1, int(settings.multisample)))


def splat_image(loaded, sample0: int, n_samples: int, seed: int,
                sampler_mode: int = 1, lanes: int = LANES):
    """The splats of samples sample0 .. sample0+n_samples-1 of every
    pixel, summed per pixel.  -> (float64 [H*W, 3], light extension
    rays traced, an int)."""
    settings, scene, meta, cam = loaded
    dev = scene.tri_pack.device
    hw = cam.xres * cam.yres
    su = upath._setup(scene, meta, settings)
    img = torch.zeros((hw, 3), dtype=torch.float64, device=dev)
    rays = 0
    n = hw * n_samples
    with torch.no_grad(), _no_tf32():
        for s in range(0, n, lanes):
            j = torch.arange(s, min(n, s + lanes), device=dev)
            ctx = _lanes_ctx(settings, cam, seed, j % hw,
                             j // hw + int(sample0), sampler_mode)
            light = upath._sample_path_light(scene, ctx)
            _, pix, val, n_rays = _light_subpaths(scene, meta, settings,
                                                  cam, su, ctx, light)
            good = pix.reshape(-1) >= 0
            img.index_add_(0, pix.reshape(-1)[good],
                           val.reshape(-1, 3)[good].double())
            rays += n_rays
    return img.cpu().numpy(), rays


# ------------------------------------------------------------ eye paths

def _connect(scene, meta, su, lv, sp, p0, act):
    """One eye-vertex x light-vertex connection; `lv` holds one light
    vertex per lane ([R, ...] fields as in lrec)."""
    l_pos = lv["pos"]
    vis_c = isect.visibility(scene, su.intersect, l_pos, sp.pos,
                             active=lv["valid"] & act)
    keep = lv["valid"] & act & vis_c
    l_frame = (lv["light_n"], lv["t_f"], lv["b_f"])
    light_to_p = vm.normalize(sp.pos - l_pos)
    p_to_light = -light_to_p
    f_light = bxdf_ops.eval_bxdf(
        scene, su.mat_pack, lv["mat_id"], vm.to_local(*l_frame, light_to_p),
        vm.to_local(*l_frame, lv["vr"]), lv["uv"], su.tables,
        has_mix=meta.has_mix, has_ltc=meta.has_ltc,
        has_textures=meta.has_textures)
    f_point = bxdf_ops.eval_bxdf(
        scene, su.mat_pack, sp.mat_id, upath._to_local(sp, sp.vr),
        upath._to_local(sp, p_to_light), sp.uv, su.tables,
        has_mix=meta.has_mix, has_ltc=meta.has_ltc,
        has_textures=meta.has_textures, p0=p0)
    g_c = (torch.abs(vm.dot(sp.light_n, p_to_light))
           / torch.clamp(vm.distance2(l_pos, sp.pos), min=1e-12))
    term = lv["light_here"] * f_light * f_point * g_c[..., None]
    return torch.where(keep[..., None], term, 0.0)


def _bounce(scene, meta, settings, su, f, lrec, q, bounce):
    """One eye bounce: extension, sky escape, NEE and emission, the
    connections to the lane's light vertices, the clamp."""
    contrib, ray_dir = q.contribution, q.rd
    nxt, sp, p0, act, n_rays, sky_mask = upath._extend_path(
        scene, meta, settings, su, f.ctx, q.ro, ray_dir, q.last_tri,
        contrib, q.alive, bounce, su.russian, upath.TAG_EYE)
    sky = tex_ops.sky_radiance(scene, -ray_dir, has_envmap=meta.has_envmap)
    radiance = q.radiance + torch.where(sky_mask[..., None], contrib * sky,
                                        0.0)
    total_here = upath._vertex_radiance(scene, meta, su, f.light, sp, p0,
                                        active=act)
    for k in range(lrec["valid"].shape[0]):
        lv = {name: v[k] for name, v in lrec.items()}
        total_here = total_here + _connect(scene, meta, su, lv, sp, p0, act)
    total_here = torch.clamp(total_here, max=su.clamp)
    radiance = radiance + torch.where(act[..., None],
                                      contrib * total_here, 0.0)
    return upath._LaneState(
        ro=nxt["ro"], rd=nxt["rd"], last_tri=nxt["last_tri"],
        contribution=nxt["contribution"], alive=nxt["alive"],
        radiance=radiance, rays=q.rays + n_rays, bounce=q.bounce + 1)


def _eye_lanes(loaded, px, py, sample, seed, sampler_mode):
    """The eye paths of lanes (px, py, sample), each connected to its own
    light subpath.  -> (radiance f32 [R, 3] after the final clamp and
    scrub, eye extension rays)."""
    settings, scene, meta, cam = loaded
    su = upath._setup(scene, meta, settings)
    pixel_id = py.long() * cam.xres + px.long()
    ctx = _lanes_ctx(settings, cam, seed, pixel_id, sample, sampler_mode)
    f, q = upath._lane_init(scene, meta, settings, su, cam, ctx, px, py)
    lrec, _, _, _ = _light_subpaths(scene, meta, settings, cam, su, ctx,
                                    f.light)
    bounce = 0
    while bool(upath._lane_live(su, q)):
        q = _bounce(scene, meta, settings, su, f, lrec, q, bounce)
        bounce += 1
    out = upath._lane_finish(su, f, q)
    return out.radiance, int(out.rays)


def pixel_sums(loaded, pixels, sample0: int, n_samples: int, seed: int,
               sampler_mode: int = 1, lanes: int = LANES):
    """The eye paths' sum of samples sample0 .. sample0+n_samples-1 of
    each pixel in `pixels` (flat indices y * xres + x), splats left out.
    -> (float64 [P, 3], eye extension rays traced, an int)."""
    _, scene, _, cam = loaded
    dev = scene.tri_pack.device
    pix = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=dev)
    n_pix = pix.shape[0]
    lane_pix = torch.arange(n_pix, device=dev).repeat_interleave(n_samples)
    lane_s = torch.arange(n_samples, device=dev).repeat(n_pix) + int(sample0)
    sums = torch.zeros((n_pix, 3), dtype=torch.float64, device=dev)
    rays = 0
    with torch.no_grad(), _no_tf32():
        for s in range(0, lane_pix.shape[0], lanes):
            who = lane_pix[s:s + lanes]
            p = pix[who]
            rad, n_rays = _eye_lanes(
                loaded, (p % cam.xres).to(torch.int32),
                (p // cam.xres).to(torch.int32), lane_s[s:s + lanes], seed,
                sampler_mode)
            sums.index_add_(0, who, rad.double())
            rays += n_rays
    return sums.cpu().numpy(), rays


def round_pixels(loaded, pixels, sample0: int, n_samples: int, seed: int,
                 sampler_mode: int = 1, lanes: int = LANES):
    """A round's image at `pixels`: the eye paths' sums plus the splat
    image there.  -> float64 [P, 3]."""
    eye, _ = pixel_sums(loaded, pixels, sample0, n_samples, seed,
                        sampler_mode, lanes)
    splats, _ = splat_image(loaded, sample0, n_samples, seed, sampler_mode,
                            lanes)
    return eye + splats[np.asarray(pixels)]
