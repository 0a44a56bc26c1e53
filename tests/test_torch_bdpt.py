"""Port parity for bidirectional rendering (`reverse > 0`) and the
per-sample path: rgk_tpu_torch against rgk_tpu on the CPU.

Tolerances:
* the inverse projection `coords_from_direction`: x, y and in_view
  exact; the light-subpath warps rtol 1e-6 / atol 1e-6 (float32 ops in
  another library);
* per-lane radiance of the queued BDPT tracer and of the per-sample
  path: rtol 1e-4 / atol 1e-5 on >= 99% of lanes (the plain sweep and
  the reference's sum in another order, which may flip a hit exactly on
  an edge and send that lane down another path); extension-ray count
  within 0.5%; the splat image to the same bounds, per pixel;
* the port's queued BDPT against its own per-sample path: ray counts
  equal, images within rtol 2e-5 / atol 1e-6 (the splats add in
  another order), as tests/test_bdpt.py holds the reference's;
* whole images: the bounds of bench.py parity_gate
  (rgk_tpu_torch/parity.py); a resume against a straight run: bitwise.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.driver import cli as jcli
from rgk_tpu.integrator import path as jpath
from rgk_tpu.ops import sampler as jsmp
from rgk_tpu.ops import vecmath as jvm
from rgk_tpu.ops import warps as jwarps
from rgk_tpu.scene import camera as jcamera
from rgk_tpu_torch.driver import cli
from rgk_tpu_torch.driver.render import RenderDriver
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.io import read_exr
from rgk_tpu_torch.ops import sampler as smp
from rgk_tpu_torch.ops import vecmath as vm
from rgk_tpu_torch.ops import warps
from rgk_tpu_torch.parity import image_parity
from rgk_tpu_torch.scene import camera as tcamera


def _cam_pair(**kw):
    return jcamera.make_camera(**kw), tcamera.make_camera(**kw)


def test_coords_from_direction_matches_reference():
    """Directions all around the camera, in view or not (behind it, past
    the frame's edges, grazing the view plane): x, y and in_view equal
    the reference's on every lane whose projection is finite."""
    jcam, tcam = _cam_pair(position=[1.0, 2.0, 3.0], lookat=[0.0, 0.5, -1.0],
                           up=[0.0, 1.0, 0.0], yview=0.8, xview=1.1,
                           xres=64, yres=48)
    rng = np.random.default_rng(21)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:2048] += 2.0 * np.asarray(tcam.direction)  # many in view
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jx, jy, jv = (np.asarray(a) for a in
                  jcamera.coords_from_direction(jcam, jnp.asarray(d)))
    tx, ty, tv = (a.numpy() for a in
                  tcamera.coords_from_direction(tcam, torch.from_numpy(d)))
    assert tx.dtype == ty.dtype == np.int32 and tv.dtype == bool
    np.testing.assert_array_equal(tv, jv)
    assert 0.2 < tv.mean() < 0.8
    # Off the view plane's side the ratios run to +-inf, where the
    # float -> int32 cast has no defined value; those lanes never splat.
    q = d @ np.asarray(tcam.direction)
    finite = np.abs(q) > 1e-3
    np.testing.assert_array_equal(tx[finite], jx[finite])
    np.testing.assert_array_equal(ty[finite], jy[finite])


def test_coords_from_direction_roundtrips_pixel_rays():
    """Forward-project pixel centers, inverse-project the directions:
    the same pixel, in view (tests/test_bdpt.py's check on the port)."""
    cam = tcamera.make_camera(position=[1.0, 2.0, 3.0],
                              lookat=[0.0, 0.5, -1.0], up=[0.0, 1.0, 0.0],
                              yview=0.8, xview=1.1, xres=64, yres=48)
    rng = np.random.default_rng(7)
    px = torch.from_numpy(rng.integers(0, 64, 256).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, 48, 256).astype(np.int32))
    _, rd = tcamera.pixel_rays(cam, px, py, torch.full((256, 2), 0.5))
    x, y, in_view = tcamera.coords_from_direction(cam, rd)
    assert bool(in_view.all())
    assert torch.equal(x, px) and torch.equal(y, py)


def test_coords_from_direction_rejects_behind():
    cam = tcamera.make_camera(position=[0.0, 0.0, 0.0],
                              lookat=[0.0, 0.0, -1.0], up=[0.0, 1.0, 0.0],
                              yview=1.0, xview=1.0, xres=32, yres=32)
    dirs = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    assert not bool(tcamera.coords_from_direction(cam, dirs)[2].any())


def test_light_subpath_warps_match_reference():
    """The emission direction's warps, and the sampler dims the port
    adds, against the reference's."""
    assert (smp.DIM_LIGHTDIR, smp.DIM_LIGHT_TRI) == (jsmp.DIM_LIGHTDIR,
                                                     jsmp.DIM_LIGHT_TRI)
    rng = np.random.default_rng(5)
    u = rng.random((2048, 2), dtype=np.float32)
    n = rng.normal(size=(2048, 3)).astype(np.float32)
    n[:4] = [[0, 1, 0], [0, -1, 0], [0, -1, 1e-7], [1e-7, 1, 0]]
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    v = rng.normal(size=(2048, 3)).astype(np.float32)
    pairs = (
        (warps.to_hemisphere_cosine_y(torch.from_numpy(u)),
         jwarps.to_hemisphere_cosine_y(jnp.asarray(u))),
        (warps.to_hemisphere_cosine_directed(torch.from_numpy(u),
                                             torch.from_numpy(n)),
         jwarps.to_hemisphere_cosine_directed(jnp.asarray(u),
                                              jnp.asarray(n))),
        (vm.rotation_from_y(torch.from_numpy(n), torch.from_numpy(v)),
         jvm.rotation_from_y(jnp.asarray(n), jnp.asarray(v))),
        (vm.distance2(torch.from_numpy(n), torch.from_numpy(v)),
         jvm.distance2(jnp.asarray(n), jnp.asarray(v))),
        (vm.length2(torch.from_numpy(v)), jvm.length2(jnp.asarray(v))))
    for port, ref in pairs:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ the tracers

def _box(tmp_path, res=16, ms=4, reverse=2, name="bdpt.json", **overrides):
    cfg = scenes.box_config(res=res, ms=ms, reverse=reverse, **overrides)
    return scenes.write_config(tmp_path, cfg, name)


def _bvh_box(tmp_path, res=16, ms=4, reverse=2):
    cfg = scenes.add_sphere(tmp_path, scenes.box_config(
        res=res, ms=ms, reverse=reverse), n_tris=5000)
    return scenes.write_config(tmp_path, cfg, "bdpt_bvh.json")


def _pixels(res):
    pix = np.arange(res * res)
    return (pix % res).astype(np.int32), (pix // res).astype(np.int32)


def _assert_lanes_close(port, ref, rays_port, rays_ref):
    close = np.isclose(port, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(rays_port - rays_ref) <= 0.005 * rays_ref
    assert ref.mean() > 0.0


@pytest.mark.parametrize("has_bvh", [False, True])
def test_queued_bdpt_matches_reference(tmp_path, has_bvh):
    """The box at 16x16, 4 spp, reverse 2, depth 4 (and the box plus a
    5000-triangle sphere, a BVH scene): per-lane radiance, the splat
    image per pixel, and the ray count (light plus eye extensions)."""
    path = _bvh_box(tmp_path) if has_bvh else _box(tmp_path)
    _, jarrays, jmeta, jcfg = scenes.jax_build(path)
    tarrays, tmeta, tcfg = scenes.port_build(path)
    assert tmeta.has_bvh == jmeta.has_bvh == has_bvh
    px, py = _pixels(16)
    jrad, jsplat, jrays = jpath.trace_wavefront_queued_bdpt(
        jarrays, jmeta, jcfg.settings, jcfg.get_camera(), jnp.asarray(px),
        jnp.asarray(py), 0, 4, 42, sampler_mode=1)
    trad, tsplat, trays = tpath.trace_wavefront_queued_bdpt(
        tarrays, tmeta, tcfg.settings, tcfg.get_camera(),
        torch.from_numpy(px), torch.from_numpy(py), 0, 4, 42,
        sampler_mode=1)
    assert tsplat.shape == (16 * 16 + 1, 3) and trays.dtype == torch.int64
    _assert_lanes_close(trad.numpy(), np.asarray(jrad), int(trays),
                        int(jrays))
    _assert_lanes_close(tsplat[:-1].numpy(), np.asarray(jsplat)[:-1],
                        int(trays), int(jrays))
    assert float(tsplat[:-1].sum()) > 0.0


def test_per_sample_path_matches_reference(tmp_path):
    """render_lanes (trace_wavefront) with BDPT: per-lane radiance and
    each lane's splats against the reference's, and the same values with
    `differentiable` (the fixed-length loop) as with the early exit."""
    path = _box(tmp_path, res=16, ms=4, reverse=2)
    _, jarrays, jmeta, jcfg = scenes.jax_build(path)
    tarrays, tmeta, tcfg = scenes.port_build(path)
    rng = np.random.default_rng(3)
    n = 512
    px = rng.integers(0, 16, n).astype(np.int32)
    py = rng.integers(0, 16, n).astype(np.int32)
    si = (np.arange(n) % 4).astype(np.uint32)
    j = jpath.render_lanes(jarrays, jmeta, jcfg.settings, jcfg.get_camera(),
                           jnp.asarray(px), jnp.asarray(py), jnp.asarray(si),
                           jnp.uint32(42))
    args = (tarrays, tmeta, tcfg.settings, tcfg.get_camera(),
            torch.from_numpy(px), torch.from_numpy(py),
            torch.from_numpy(si.astype(np.int64)), 42)
    t = tpath.render_lanes(*args)
    _assert_lanes_close(t.radiance.numpy(), np.asarray(j.radiance),
                        int(t.rays), int(j.rays))
    same = (t.splat_pix.numpy() == np.asarray(j.splat_pix)).all(axis=1)
    assert same.mean() >= 0.99
    val_close = np.isclose(t.splat_val.numpy(), np.asarray(j.splat_val),
                           rtol=1e-4, atol=1e-5).all(axis=(1, 2))
    assert (val_close & same).mean() >= 0.99
    d = tpath.render_lanes(*args, differentiable=True)
    for a, b in zip(d, t):
        assert torch.equal(a, b)


def test_splats_are_weight0_side_effects(tmp_path):
    """tests/test_bdpt.py's check on the port: splats add radiance
    without adding to the sample counts, and the BDPT image holds more
    energy than the NEE-only render of the same scene."""
    sums = {}
    for reverse in (2, 0):
        path = _box(tmp_path, res=24, ms=8, reverse=reverse,
                    name=f"r{reverse}.json")
        arrays, meta, cfg = scenes.port_build(path)
        drv = RenderDriver(cfg.settings, arrays, meta, cfg.get_camera())
        drv.render_round(0)
        drv.fetch_accumulation()
        assert (drv.acc.count == cfg.settings.multisample).all()
        assert np.isfinite(drv.acc.sum).all() and (drv.acc.sum >= 0).all()
        sums[reverse] = drv.acc.sum.sum()
    assert sums[2] > sums[0]


def test_splat_pixels_in_range(tmp_path):
    """tests/test_bdpt.py's check on the port: every splat indexes a
    real pixel with finite, non-negative radiance, a healthy share of
    light vertices splat, and missed slots carry exactly zero."""
    path = _box(tmp_path, res=24, ms=8, reverse=2)
    arrays, meta, cfg = scenes.port_build(path)
    n = 512
    rng = np.random.default_rng(3)
    px = torch.from_numpy(rng.integers(0, 24, n).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, 24, n).astype(np.int32))
    r = tpath.render_lanes(arrays, meta, cfg.settings, cfg.get_camera(), px,
                           py, torch.arange(n) % 8, 42)
    pix, val = r.splat_pix.numpy(), r.splat_val.numpy()
    assert pix.shape == (n, 2)
    ok = pix >= 0
    assert ok.mean() > 0.3, ok.mean()
    assert (pix[ok] < 24 * 24).all()
    assert np.isfinite(val).all() and (val >= 0).all()
    assert (val[~ok] == 0).all()


def test_queued_bdpt_matches_per_sample_path(tmp_path):
    """The port's queued BDPT tracer against its own per-sample path
    (render_image_round), as tests/test_bdpt.py holds the reference's:
    the same estimator, so ray counts equal and the images agree up to
    the order the splats add in."""
    path = _box(tmp_path, res=16, ms=4, reverse=3)
    arrays, meta, cfg = scenes.port_build(path)
    cam = cfg.get_camera()
    rad_ref, counts, rays_ref = tpath.render_image_round(
        arrays, meta, cfg.settings, cam, 0, seed=42)
    assert bool((counts == 4).all())
    px, py = _pixels(16)
    rad_q, splat_img, rays_q = tpath.trace_wavefront_queued_bdpt(
        arrays, meta, cfg.settings, cam, torch.from_numpy(px),
        torch.from_numpy(py), 0, 4, 42)
    img_q = rad_q.reshape(16, 16, 3) + splat_img[:-1].reshape(16, 16, 3)
    assert int(rays_q) == int(rays_ref)
    np.testing.assert_allclose(img_q.numpy(), rad_ref.numpy(), rtol=2e-5,
                               atol=1e-6)


def _port_render(cfg_path, out_dir, *extra):
    assert cli.main([cfg_path, "--cpu", "-q", "-D", str(out_dir),
                     *extra]) == 0
    return read_exr(os.path.join(str(out_dir), "bdpt_box.exr"))


def test_cli_bdpt_image_matches_reference(tmp_path):
    """A BDPT render through both CLIs (24x24, 8 spp, reverse 2)."""
    path = _box(tmp_path, res=24, ms=8, reverse=2)
    ref_dir = tmp_path / "ref"
    assert jcli.main([path, "--cpu", "--devices", "1", "-q", "-D",
                      str(ref_dir)]) == 0
    ref = read_exr(os.path.join(str(ref_dir), "bdpt_box.exr"))
    img = _port_render(path, tmp_path / "port")
    assert img.shape == ref.shape == (24, 24, 3)
    stats = image_parity(img, ref)
    assert stats["ok"], stats


def test_bdpt_blocks_and_resume(tmp_path):
    """One round, then a resume to two, equals two rounds straight,
    through the CLI; with --chunk-lanes 512 and 8 spp the frame runs in
    four blocks of 64 pixels, and gives the one-block image up to the
    order the splat images add in."""
    cfg = scenes.box_config(res=16, ms=8, reverse=2, rounds=2)
    straight = scenes.write_config(tmp_path, cfg, "straight.json")
    first = scenes.write_config(tmp_path, dict(cfg, rounds=1), "first.json")
    img2 = _port_render(straight, tmp_path / "straight")
    out = tmp_path / "resumed"
    _port_render(first, out)
    img = _port_render(straight, out, "--resume")
    np.testing.assert_array_equal(img, img2)
    with np.load(os.path.join(str(out), "bdpt_box.exr.ckpt.npz")) as d, \
            np.load(os.path.join(str(tmp_path / "straight"),
                                 "bdpt_box.exr.ckpt.npz")) as s:
        assert int(d["next_round"]) == 2
        assert int(d["rays"]) == int(s["rays"]) > 0
    blocks = _port_render(straight, tmp_path / "blocks", "--chunk-lanes",
                          "512")
    np.testing.assert_allclose(blocks, img2, rtol=2e-5, atol=1e-6)
