"""Port parity: the host scene build and the camera of rgk_tpu_torch
against rgk_tpu's.

Tolerance: none for the committed arrays (every field equal bit for
bit and in dtype to scene_from_numpy of the rgk_tpu build, BVH and
cluster arrays included); camera rays rtol 1e-6 / atol 1e-6 (float32
ops in another library).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.scene.camera import pixel_rays as j_pixel_rays
from rgk_tpu_torch.scene import config as tconfig
from rgk_tpu_torch.scene.arrays import SceneArrays, scene_from_numpy
from rgk_tpu_torch.scene.camera import pixel_rays
from rgk_tpu_torch.scene.json_utils import ConfigError

META_FIELDS = ("n_triangles", "n_materials", "n_point_lights",
               "n_areal_tris", "has_bvh", "has_textures", "has_thinglass",
               "has_mix", "has_ltc", "has_envmap", "material_names")


def _renderer_style(tmp_path):
    """Inline scenes in the style of tests/test_renderer.py."""
    base = {
        "output-file": "t.exr", "output-width": 16, "output-height": 16,
        "multisample": 16, "recursion-max": 2, "russian": -1.0,
        "camera": {"position": [0, 2, 0.001], "lookat": [0, 0, 0],
                   "fov": 60},
        "materials": [{"name": "floor", "brdf": "diffuse",
                       "diffuse": [0.5, 0.5, 0.5]}],
        "scene": [{"primitive": "plane", "axis": "Y", "scale": [50, 1, 50],
                   "material": "floor"}],
    }
    point = dict(base, lights=[{"position": [0, 3, 0], "color": [1, 1, 1],
                                "intensity": 2.0}])
    glow = dict(base, materials=base["materials"] + [
        {"name": "glow", "brdf": "diffuse", "emission": [3, 2, 1]}],
        scene=[{"primitive": "plane", "axis": "Y", "scale": [50, 1, 50],
                "material": "glow"}])
    sky = dict(base, sky={"color": [1.0, 0.5, 0.25], "intensity": 2.0},
               scene=[{"primitive": "tri", "translate": [500, 0, 0],
                       "material": "floor"}],
               camera={"position": [0, 0, 0], "lookat": [0, 0, -1],
                       "fov": 40})
    return [scenes.write_config(tmp_path, c, f"r{i}.json")
            for i, c in enumerate((point, glow, sky))]


def _scene_paths(tmp_path, which):
    if which == "box":
        return [scenes.write_config(tmp_path, scenes.box_config())]
    if which in ("box_sphere", "box_sphere_bvh"):
        n_tris = 600 if which == "box_sphere" else 5000
        cfg = scenes.add_sphere(tmp_path, scenes.box_config(), n_tris=n_tris)
        return [scenes.write_config(tmp_path, cfg)]
    if which == "zoo":
        return [scenes.write_config(tmp_path, scenes.zoo_config(tmp_path))]
    return _renderer_style(tmp_path)


@pytest.mark.parametrize("which", ["box", "box_sphere", "renderer", "zoo",
                                   "box_sphere_bvh"])
def test_build_matches_reference(tmp_path, which):
    for path in _scene_paths(tmp_path, which):
        tree, _, jmeta, _ = scenes.jax_build(path)
        arrays, meta, _ = scenes.port_build(path)
        assert isinstance(arrays, SceneArrays)
        scenes.assert_same(arrays, scene_from_numpy(tree, "cpu"))
        for f in META_FIELDS:
            assert getattr(meta, f) == getattr(jmeta, f), f
        if which == "box_sphere":
            assert meta.n_triangles > 600 and not meta.has_bvh
        if which == "box_sphere_bvh":
            assert meta.n_triangles > 4096 and meta.has_bvh


@pytest.mark.parametrize("thin_lens", [False, True])
def test_pixel_rays_match_reference(tmp_path, thin_lens):
    cfg = scenes.box_config(res=24)
    if thin_lens:
        cfg["camera"].update({"lens-size": 0.08, "focus-plane": 3.5})
    path = scenes.write_config(tmp_path, cfg)
    _, _, _, jcfg = scenes.jax_build(path)
    _, _, tcfg = scenes.port_build(path)
    jcam, tcam = jcfg.get_camera(0.25), tcfg.get_camera(0.25)
    assert tcam.is_simple == jcam.is_simple == (not thin_lens)
    for f in ("origin", "viewscreen", "viewscreen_x", "viewscreen_y",
              "cameraleft", "cameraup", "direction"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)))

    rng = np.random.default_rng(5)
    n = 2048
    px = rng.integers(0, 24, n).astype(np.int32)
    py = rng.integers(0, 24, n).astype(np.int32)
    jitter = rng.random((n, 2), dtype=np.float32)
    lens = rng.random((n, 2), dtype=np.float32) if thin_lens else None
    jo, jd = j_pixel_rays(jcam, jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(jitter),
                          None if lens is None else jnp.asarray(lens))
    to, td = pixel_rays(tcam, torch.from_numpy(px), torch.from_numpy(py),
                        torch.from_numpy(jitter),
                        None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_config_rejections(tmp_path):
    """A nested mix is rejected at load, as in the reference; so is a
    line-based .rtc that ends inside its header (ConfigError, as the
    reference's ConfigRTC raises)."""
    cfg = scenes.box_config()
    cfg["materials"] += [
        {"name": "m1", "brdf": "mix", "material1": "white",
         "material2": "red", "amount": 0.5},
        {"name": "m2", "brdf": "mix", "material1": "m1",
         "material2": "red", "amount": 0.5}]
    path = scenes.write_config(tmp_path, cfg)
    with pytest.raises(ConfigError, match="nested mix"):
        tconfig.build_scene(tconfig.load_config(path), "cpu")
    rtc = tmp_path / "scene.rtc"
    rtc.write_text("output-file x.exr\n")
    with pytest.raises(ConfigError, match="Unexpected end"):
        tconfig.load_config(str(rtc))
