"""The bidirectional cell's comparison on the CPU: the plain BDPT
reference (`reference/bdpt.py`) against the renderer's queued BDPT
tracer and its per-sample BDPT path, and the `bdpt` driver's verdict on
a sound run, on its bfloat16 control and on three faults planted in the
timed path.

Tolerances of the pixel-by-pixel comparison, rtol 1e-5 and atol 1e-5 on
a pixel's round sum: the three trace the same lanes through the same
operations, so the eye sums agree to float32 rounding; the splat image
adds the same splats in another order and precision (the renderer in
float32 in the lanes' order, the reference in float64), so a pixel that
gathers n splats may differ by about n float32 roundings of its sum.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, small
from rgkbench import harness

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4099
CELL = "box_sphere.bdpt"
RTOL = ATOL = 1e-5


def test_reference_matches_the_queued_and_per_sample_bdpt(scenes):
    """32x32, 2 spp, reverse 4, depth 4, round 3: every pixel's round sum
    (eye paths plus the splats that land on it)."""
    from rgk_tpu_torch.integrator import path
    from rgk_tpu_torch.scene import config
    from rgkbench.reference import bdpt as ref

    wl = small(CELL, 32, 32, **{"recursion-max": 4})
    cell = harness.Cell(CELL, wl, SEED, CPU, scenes)
    cfg = config.load_config(cell.scene_path)
    s = cfg.settings
    assert (s.xres, s.yres, s.multisample, s.reverse, s.recursion_max) == (
        32, 32, 2, 4, 4)
    scene, meta, _ = config.build_scene(cfg, CPU)
    cam = cfg.get_camera()
    hw, ms, sample0 = 32 * 32, 2, 3 * 2
    pix = torch.arange(hw)
    px, py = (pix % 32).to(torch.int32), (pix // 32).to(torch.int32)

    rad, splat, rays = path.trace_wavefront_queued_bdpt_eager(
        scene, meta, s, cam, px, py, sample0, ms, SEED)
    queued = rad.double() + splat[:-1].double()

    lanes = path.render_lanes(scene, meta, s, cam, px.repeat(ms),
                              py.repeat(ms),
                              torch.arange(ms).repeat_interleave(hw)
                              + sample0, SEED)
    per_sample = (lanes.radiance.double().reshape(ms, hw, 3).sum(0)
                  + path._splat_image(lanes.splat_pix.reshape(-1),
                                      lanes.splat_val.reshape(-1, 3),
                                      hw)[:-1].double())
    assert int(lanes.rays) == int(rays)

    loaded = ref.load(cell.scene_path, CPU)
    eye, eye_rays = ref.pixel_sums(loaded, np.arange(hw), sample0, ms, SEED)
    splats, light_rays = ref.splat_image(loaded, sample0, ms, SEED)
    want = eye + splats
    assert eye_rays + light_rays == int(rays)
    assert np.abs(splats).sum() > 0.05 * np.abs(want).sum()
    np.testing.assert_allclose(queued.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(per_sample.numpy(), want, rtol=RTOL,
                               atol=ATOL)
    # The round at the pixels the driver checks: the same numbers.
    some = np.array([0, 33, 517, 1023])
    np.testing.assert_allclose(ref.round_pixels(loaded, some, sample0, ms,
                                                SEED), want[some],
                               rtol=1e-12)


def _no_splats(monkeypatch):
    from rgk_tpu_torch.integrator import path

    orig = path._splat_image
    monkeypatch.setattr(path, "_splat_image",
                        lambda pix, val, hw: orig(pix, val, hw) * 0.0)


def _no_connections(monkeypatch):
    from rgk_tpu_torch.integrator import path

    orig = path._connect_to_light_vertex

    def connect(*args):
        return orig(*args) * 0.0

    monkeypatch.setattr(path, "_connect_to_light_vertex", connect)


def _other_sample(monkeypatch):
    """Each lane's eye path connects to the light vertices of its next
    sample (the packed rows rolled along the sample axis)."""
    from rgk_tpu_torch.integrator import path

    orig = path._pack_light_vertices

    def pack(lrec, r, n_samples):
        return orig(lrec, r, n_samples).roll(1, dims=1).contiguous()

    monkeypatch.setattr(path, "_pack_light_vertices", pack)


def _run(scenes):
    return harness.run_cell(CELL, SEED, 0.05, False, CPU,
                            wl=small(CELL, 16, 16, pixels=256),
                            scenes=scenes)


def test_sound_bdpt_run_is_correct(scenes):
    out = _run(scenes)
    assert out["correct"], out["checks"]
    assert out["checks"]["image_gap"]["value"] < out["checks"][
        "image_gap"]["limit"] / 10


@pytest.mark.parametrize("fault", [_no_splats, _no_connections,
                                   _other_sample],
                         ids=["no_splats", "no_connections", "other_sample"])
def test_bdpt_fault_is_not_correct(fault, scenes, monkeypatch):
    fault(monkeypatch)
    out = _run(scenes)
    assert not out["correct"], out["checks"]


def test_bdpt_control_reads_over_the_limit(scenes):
    got = harness.readings(CELL, SEED, 0.05, CPU,
                           wl=small(CELL, 16, 16, pixels=256), scenes=scenes)
    limit = harness.workload(CELL)["check"]["limits"]["image_gap"]
    assert got["sound"]["image_gap"] < limit / 10
    assert got["control"]["image_gap"] > 10 * limit


REF = r"""
import sys, torch
sys.path.insert(0, {root!r})
from rgkbench import harness
from rgkbench.reference import bdpt
import conftest
wl = conftest.small("box_sphere.bdpt", 16, 16, **{{"recursion-max": 2}})
path = harness.scene_file("box_sphere.bdpt", wl, {scenes!r})
bdpt.round_pixels(bdpt.load(path, torch.device("cpu")), [3, 40], 0, 2, 9)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_bdpt_reference_loads_no_renderer(tmp_path):
    """The BDPT reference imports neither JAX, nor the JAX package, nor
    the renderer under test."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(__file__),
               OMP_NUM_THREADS="2")
    got = subprocess.run(
        [sys.executable, "-c", REF.format(root=ROOT, scenes=str(tmp_path))],
        capture_output=True, text=True, env=env, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    names = set(eval(got.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "rgk_tpu", "rgk_tpu_torch"}
