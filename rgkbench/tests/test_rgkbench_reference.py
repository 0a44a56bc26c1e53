"""The plain reference against the renderer's CPU path, and what the
comparison makes of the bfloat16 control: the box at 32x32, the
colonnade generator at 6,000 triangles (a BVH scene on the renderer's
side), and the box's gradient step."""

import numpy as np
import pytest
import torch

from conftest import small, small_config
from rgkbench import harness
from rgkbench.drivers import grad as grad_drv

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def test_reference_matches_the_box_queued_render(scenes):
    wl = small("box_sphere.nee", width=32, height=32, pixels=48)
    got = harness.readings("box_sphere.nee", SEED, 0.05, CPU, wl=wl,
                           scenes=scenes)
    limit = harness.workload("box_sphere.nee")["check"]["limits"]["image_gap"]
    assert got["sound"]["image_gap"] < limit / 10
    assert got["control"]["image_gap"] > 10 * limit


def test_reference_matches_the_colonnade_bvh_render(scenes):
    wl = small("colonnade.nee", width=48, height=27, pixels=16)
    cfg = small_config("colonnade", budget=6000)
    got = harness.readings("colonnade.nee", SEED, 0.05, CPU, wl=wl,
                           scenes=scenes, cfg=cfg)
    limit = harness.workload("colonnade.nee")["check"]["limits"]["image_gap"]
    assert got["sound"]["image_gap"] < limit / 10
    assert got["control"]["image_gap"] > 10 * limit


def test_reference_pixel_sums_equal_the_renderer_lanes(scenes):
    """Pixel by pixel against `render_lanes` of the renderer, the same
    lanes: the reference's per-sample path is the renderer's."""
    from rgk_tpu_torch.integrator import path
    from rgk_tpu_torch.scene import config
    from rgkbench.reference import render as ref

    wl = small("box_sphere.nee", width=16, height=16)
    cell = harness.Cell("box_sphere.nee", wl, SEED, CPU, scenes)
    cfg = config.load_config(cell.scene_path)
    scene, meta, _ = config.build_scene(cfg, CPU)
    cam = cfg.get_camera()
    pixels = np.array([0, 17, 100, 255])
    n = 8
    p = torch.as_tensor(pixels).repeat_interleave(n)
    out = path.render_lanes(scene, meta, cfg.settings, cam,
                            (p % 16).int(), (p // 16).int(),
                            torch.arange(n).repeat(len(pixels)), SEED)
    want = out.radiance.double().reshape(len(pixels), n, 3).sum(1).numpy()
    got, rays = ref.pixel_sums(ref.load(cell.scene_path, CPU), pixels, n,
                               SEED)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert rays == int(out.rays)


def test_reference_gradient_steps_match_the_renderer(scenes):
    wl = small("box_sphere.grad", width=16, height=16, multisample=2)
    got = harness.readings("box_sphere.grad", SEED, 0.05, CPU, wl=wl,
                           scenes=scenes)
    lim = harness.workload("box_sphere.grad")["check"]["limits"]
    for key, limit in lim.items():
        assert got["sound"][key] < limit / 10, key
    assert any(got["control"][k] > 3 * lim[k] for k in lim)
    assert any(got["half_batch"][k] > 3 * lim[k] for k in lim)


def test_first_gradient_norms_by_leaf(scenes):
    """grad_gap reads the reference's first gradient from its SGD step:
    (p0 - p1) / lr equals autograd's gradient leaf by leaf."""
    wl = small("box_sphere.grad", width=8, height=8, multisample=1)
    cell = harness.Cell("box_sphere.grad", wl, SEED, CPU, scenes)
    ref = grad_drv.reference_steps(cell, 1, float(wl["lr"]))
    for k, norm in ref["first"].items():
        step = (ref["snaps"][0][k] - ref["snaps"][1][k]) / ref["lr"]
        assert np.linalg.norm(step) == pytest.approx(norm, rel=1e-4,
                                                     abs=1e-9)


@pytest.mark.parametrize("any_hit", [False, True])
def test_culled_sweep_gives_the_brute_sweep_answers(any_hit):
    """The group-culled sweep (scenes above 4096 triangles) against every
    ray x every triangle, bit for bit: a random soup with a duplicate
    triangle (a tie), axis-parallel rays, short intervals and excluded
    ids."""
    from rgkbench.reference.ops import intersect as ix
    from rgkbench.reference.scene.builder import build_tri_pack

    rng = np.random.default_rng(3)
    m, r = 9000, 4000
    c = rng.random((m, 1, 3)) * 10
    v = (c + rng.normal(size=(m, 3, 3)) * 0.4).reshape(-1, 3)
    v = v.astype(np.float32)
    tri = np.arange(m * 3).reshape(m, 3).astype(np.int32)
    tri[1] = tri[0]
    pack = torch.from_numpy(build_tri_pack(v, tri))
    ro = torch.from_numpy(rng.random((r, 3)).astype(np.float32) * 12 - 1)
    rd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(r, 3)).astype(np.float32)), dim=-1)
    rd[:50] = torch.tensor([1.0, 0.0, 0.0])
    t_min = torch.full((r,), 1e-4)
    t_max = torch.full((r,), 30.0)
    t_max[:100] = 2.0
    excl = torch.from_numpy(rng.integers(-1, m, r))
    groups = ix.make_groups(torch.from_numpy(v), torch.from_numpy(tri))
    want = ix.sweep(pack, ro, rd, t_min, t_max, excl, any_hit)
    got = ix.culled_sweep(pack, groups, ro, rd, t_min, t_max, excl, any_hit)
    assert int((want.tri >= 0).sum()) > r // 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)
