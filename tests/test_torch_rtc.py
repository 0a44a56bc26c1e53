"""Line-based `.rtc` configs in rgk_tpu_torch (scene/rtc.py), against
rgk_tpu's ConfigRTC on the CPU: tests/test_rtc_config.py's six cases on
the port, every parsed field equal to the reference's, and a CPU render
of an .rtc scene through both CLIs under the image parity bounds
(rgk_tpu_torch/parity.py).

Tolerances: parsing and the committed arrays are exact; the camera
vectors within atol 1e-6 as in the reference's test; the images under
the parity bounds.
"""

import json
import os

import numpy as np
import pytest

import torch_port_scenes as scenes
from rgk_tpu_torch.driver import cli
from rgk_tpu_torch.io import read_exr
from rgk_tpu_torch.parity import image_parity
from rgk_tpu_torch.scene.config import (Config, ConfigError, build_scene,
                                        load_config)
from rgk_tpu_torch.scene.rtc import ConfigRTC

OBJ = """
mtllib box.mtl
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
vn 0 1 0
usemtl white
f 1//1 2//1 3//1
f 1//1 3//1 4//1
"""

MTL = """
newmtl white
Kd 0.7 0.7 0.7
Ns 10
"""

RTC = """my test scene
box.obj
out.exr
4
64 48
0 2 -5
0 0 0
0 1 0
1.5
# a comment line
L 0 3 0 255 128 0 100 0.5
ms 8
sky 25 51 255 2.0
lens 0.25
focus 3.5
clamp 5.0
russian 0.6
rounds 3
reverse 1
brdf diffuse
thinglass glassy
force_fresnell 1
bogus_option 1
"""


@pytest.fixture
def rtc_dir(tmp_path):
    (tmp_path / "box.obj").write_text(OBJ)
    (tmp_path / "box.mtl").write_text(MTL)
    (tmp_path / "scene.rtc").write_text(RTC)
    return tmp_path


def test_rtc_settings(rtc_dir):
    cfg = load_config(str(rtc_dir / "scene.rtc"))
    assert isinstance(cfg, ConfigRTC)
    s = cfg.settings
    assert s.output_file == "out.exr"
    assert (s.xres, s.yres) == (64, 48)
    assert s.recursion_max == 4
    assert s.multisample == 8
    assert s.clamp == 5.0
    assert s.russian == 0.6
    assert s.rounds == 3
    assert s.reverse == 1
    assert s.force_fresnell is True
    assert s.thinglass == ["glassy"]


def test_rtc_camera(rtc_dir):
    cfg = load_config(str(rtc_dir / "scene.rtc"))
    cam = cfg.get_camera()
    np.testing.assert_allclose(cam.origin.numpy(), [0, 2, -5], atol=1e-6)
    # yview given directly; xview scales by the aspect; the view-screen
    # edges are the view extents times the focus distance.
    focus = 3.5
    ylen = np.linalg.norm(cam.viewscreen_y.numpy())
    xlen = np.linalg.norm(cam.viewscreen_x.numpy())
    assert abs(ylen - 1.5 * focus) < 1e-4
    assert abs(xlen - 1.5 * 64 / 48 * focus) < 1e-4
    assert abs(float(cam.lens_size) - 0.25) < 1e-6
    assert not cam.is_simple
    # The orbit keeps the lookat distance.
    cam2 = cfg.get_camera(0.25)
    d0 = np.linalg.norm(cam.origin.numpy())
    d1 = np.linalg.norm(cam2.origin.numpy())
    assert abs(d0 - d1) < 1e-5


def test_rtc_scene_install(rtc_dir):
    cfg = load_config(str(rtc_dir / "scene.rtc"))
    arrays, meta, builder = build_scene(cfg, "cpu", build_bvh=False)
    assert meta.n_triangles == 2
    assert meta.n_point_lights == 1
    lt = arrays.lights
    np.testing.assert_allclose(lt.point_pos[0].numpy(), [0, 3, 0])
    np.testing.assert_allclose(lt.point_color[0].numpy(),
                               [1.0, 128 / 255, 0.0], atol=1e-6)
    assert float(lt.point_size[0]) == 0.5
    np.testing.assert_allclose(arrays.sky_color.numpy(),
                               [25 / 255, 51 / 255, 1.0], atol=1e-6)
    assert float(arrays.sky_intensity) == 2.0
    cfg.post_check()  # a no-op; must not raise


def test_rtc_default_russian_off(tmp_path):
    # Without a russian line roulette is off, unlike the JSON default.
    txt = "\n".join(RTC.splitlines()[:9]) + "\n"
    (tmp_path / "min.rtc").write_text(txt)
    (tmp_path / "box.obj").write_text(OBJ)
    (tmp_path / "box.mtl").write_text(MTL)
    cfg = load_config(str(tmp_path / "min.rtc"))
    assert cfg.settings.russian == -1.0


@pytest.mark.parametrize("bad", [
    RTC.replace("brdf diffuse", "brdf nonsense"),
    RTC.replace("64 48", "64"),
    RTC.replace("\n1.5\n", "\n150\n"),
    RTC.replace("L 0 3 0 255 128 0 100 0.5", "L 0 3 0 255"),
    "\n".join(RTC.splitlines()[:5]) + "\n",
])
def test_rtc_bad_lines_raise(tmp_path, bad):
    (tmp_path / "bad.rtc").write_text(bad)
    with pytest.raises(ConfigError):
        load_config(str(tmp_path / "bad.rtc"))


def test_rtc_json_content_dispatch(tmp_path):
    """A .rtc file that holds JSON loads as a JSON config."""
    path = tmp_path / "scene.rtc"
    path.write_text(json.dumps(scenes.box_config(res=8, ms=1)))
    cfg = load_config(str(path))
    assert type(cfg) is Config
    assert cfg.settings.xres == 8


def test_rtc_fields_match_reference(rtc_dir):
    """Every field ConfigRTC parses, the camera and the committed scene
    equal rgk_tpu's."""
    from rgk_tpu.scene import config as jconfig

    path = str(rtc_dir / "scene.rtc")
    j, t = jconfig.load_config(path), load_config(path)
    assert type(j).__name__ == type(t).__name__ == "ConfigRTC"
    assert vars(j.settings) == vars(t.settings)
    for f in ("comment", "model_file", "brdf", "_yview", "_focus_plane",
              "_lens_size", "_sky_brightness"):
        assert getattr(j, f) == getattr(t, f), f
    for f in ("_cam_pos", "_cam_lookat", "_cam_up", "_sky_color"):
        np.testing.assert_array_equal(getattr(j, f), getattr(t, f))
    assert len(j.lights) == len(t.lights)
    for a, b in zip(j.lights, t.lights):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for rot in (0.0, 0.3):
        jc, tc = j.get_camera(rot), t.get_camera(rot)
        for f in ("origin", "viewscreen", "viewscreen_x", "viewscreen_y",
                  "cameraleft", "cameraup", "direction"):
            np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                          getattr(tc, f).numpy(), err_msg=f)
        assert (jc.lens_size, jc.xres, jc.yres) == (tc.lens_size, tc.xres,
                                                    tc.yres)
    jarrays, _, _ = jconfig.build_scene(j, build_bvh=False)
    tarrays, _, _ = build_scene(t, "cpu", build_bvh=False)
    for f in ("vertices", "normals", "tri_pack", "sky_color",
              "sky_intensity"):
        np.testing.assert_array_equal(np.asarray(getattr(jarrays, f)),
                                      getattr(tarrays, f).numpy(),
                                      err_msg=f)
    for f in ("diffuse", "specular", "roughness", "emission", "bxdf_type"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jarrays.materials, f)),
            getattr(tarrays.materials, f).numpy(), err_msg=f)


def test_rtc_render_matches_reference(tmp_path):
    """The floor-and-ball .rtc scene (32x24, 2 spp, depth 3) through
    both CLIs on the CPU."""
    from rgk_tpu.driver import cli as jcli

    path = scenes.write_rtc_scene(tmp_path)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert jcli.main([path, "--cpu", "--devices", "1", "-q", "-D",
                      str(ref_dir)]) == 0
    assert cli.main([path, "--cpu", "-q", "-D", str(port_dir)]) == 0
    ref = read_exr(os.path.join(str(ref_dir), "rtc.exr"))
    img = read_exr(os.path.join(str(port_dir), "rtc.exr"))
    assert img.shape == ref.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.mean() > 0.0
    stats = image_parity(img, ref)
    assert stats["ok"], stats
