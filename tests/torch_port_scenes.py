"""In-repo scenes for the port parity tests (tests/test_torch_*.py).

Each builds a JSON config under a test's tmp_path: the BDPT box of
tools/bdpt_scene.py at reverse 0, the box plus a sphere OBJ from
tools/make_bigscene.py, the procedural colonnade of that tool, and a
"zoo" with every BxDF type, textures, a bump map, an envmap sky, sized
point lights, thin glass and a thin lens.  `jax_build` and `port_build`
commit one config through rgk_tpu and rgk_tpu_torch.  `soup` and
`rays` make the random triangle soups and rays of
tests/test_intersect.py; `assert_same` compares two committed trees
bit for bit.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import torch

from rgk_tpu.scene import config as jconfig
from rgk_tpu_torch.scene import config as tconfig

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_config(tmp_path, cfg, name="scene.json"):
    path = os.path.join(str(tmp_path), name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def box_config(res=16, ms=4, **overrides):
    cfg = tool("bdpt_scene").scene_dict(res=res, ms=ms, reverse=0)
    cfg.update(overrides)
    return cfg


def add_sphere(tmp_path, cfg, n_tris=600, material="white"):
    """Append a make_sphere OBJ (written by _write_obj) to `cfg`."""
    big = tool("make_bigscene")
    verts, nrms, faces = big.make_sphere(n_tris, 0.0, 0.9, 0.6, 0.6)
    big._write_obj(os.path.join(str(tmp_path), "sphere.obj"), verts, nrms,
                   faces)
    cfg["scene"].append({"file": "sphere.obj", "material": material})
    return cfg


def colonnade(tmp_path, n_tris=20000, **overrides):
    """tools/make_bigscene.generate's colonnade (20000 -> 33,960
    triangles) with config overrides; returns the config path."""
    path = tool("make_bigscene").generate(str(tmp_path), n_tris)
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(overrides)
    return write_config(tmp_path, cfg, "colonnade_small.json")


def soup(n_tris, seed, spread=10.0):
    """-> (vertices f32 [3n, 3], tri_vidx i32 [n, 3]) of a random soup."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_tris, 3))
    offsets = rng.normal(0, 0.6, (n_tris, 3, 3))
    verts = (centers[:, None, :] + offsets).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)


def rays(n, seed, spread=12.0):
    """-> (ro, rd) f32 [n, 3], origins in a cube, unit directions."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def assert_same(a, b, name=""):
    """Trees of tensors equal in dtype, shape and bits (float tensors
    are compared as int32 bit patterns: the cluster pack carries ids,
    -1 among them, as NaN-patterned floats); other leaves by ==."""
    if isinstance(a, tuple):
        for f in a._fields:
            assert_same(getattr(a, f), getattr(b, f), f"{name}.{f}")
        return
    if not isinstance(a, torch.Tensor):
        assert a == b, (name, a, b)
        return
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), name


def _png(path, w, h, seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)


def zoo_config(tmp_path, res=8, ms=2):
    d = str(tmp_path)
    _png(os.path.join(d, "tex.png"), 7, 5, 1)
    _png(os.path.join(d, "bump.png"), 6, 9, 2)
    _png(os.path.join(d, "env.png"), 16, 8, 3)
    mats = [
        {"name": "white", "brdf": "diffuse", "diffuse": [0.7, 0.7, 0.7]},
        {"name": "tex", "brdf": "diffuse", "diffuse-texture": "tex.png",
         "bump-map": "bump.png"},
        {"name": "mirror", "brdf": "mirror", "color": [0.9, 0.8, 0.7]},
        {"name": "clear", "brdf": "transparent"},
        {"name": "glass", "brdf": "dielectric", "ior": 1.5,
         "color": [0.9, 1.0, 0.9]},
        {"name": "rough_b", "brdf": "ltc_beckmann", "roughness": 0.3,
         "color": [0.8, 0.6, 0.4]},
        {"name": "rough_g", "brdf": "ltc_ggx", "exponent": 50,
         "specular": [0.5, 0.5, 0.6]},
        {"name": "plastic_b", "brdf": "ltc_beckmann_diffuse",
         "roughness": 0.5, "color": [0.3, 0.3, 0.3],
         "diffuse": [0.2, 0.4, 0.6]},
        {"name": "plastic_g", "brdf": "ltc_ggx_diffuse", "roughness": 0.2,
         "color": [0.4, 0.4, 0.4], "diffuse-texture": "tex.png",
         "no-russian": True},
        {"name": "mixed", "brdf": "mix", "material1": "white",
         "material2": "mirror", "amount": 0.3},
        {"name": "glow", "brdf": "diffuse", "diffuse": [0, 0, 0],
         "emission": [6, 5, 4]},
        {"name": "pane", "brdf": "diffuse", "diffuse": [0.2, 0.8, 0.2]},
    ]
    scene = [{"primitive": "plane", "axis": "Y", "scale": [4, 1, 4],
              "material": "tex", "texture-scale": [2, 2, 1]}]
    for i, m in enumerate(["mirror", "clear", "glass", "rough_b", "rough_g",
                           "plastic_b", "plastic_g", "mixed"]):
        x = -2.1 + 0.6 * i
        scene.append({"primitive": "cube", "scale": [0.4, 0.5, 0.4],
                      "rotate": [0, 20 * i, 0], "translate": [x, 0.25, -0.5],
                      "material": m})
    scene += [
        {"primitive": "plane", "axis": "Y", "scale": [0.6, 1, 0.6],
         "rotate": [0, 0, 180], "translate": [0, 2.5, 0], "material": "glow"},
        {"primitive": "plane", "axis": "Z", "scale": [1.0, 1.0, 1],
         "translate": [0.5, 0.6, 0.8], "material": "pane"},
    ]
    return {
        "output-file": "zoo.exr", "output-width": res, "output-height": res,
        "multisample": ms, "recursion-max": 4, "russian": 0.6,
        "clamp": 50.0, "rounds": 1, "thinglass": ["pane"],
        "camera": {"position": [0.3, 1.4, 3.5], "lookat": [0, 0.4, 0],
                   "fov": 50, "lens-size": 0.05, "focus-plane": 3.0},
        "materials": mats, "scene": scene,
        "lights": [{"position": [1, 2, 1], "intensity": 3.0, "size": 0.2},
                   {"position": [-1, 2.2, 0.5], "intensity": 1.5,
                    "color": [1.0, 0.8, 0.6]}],
        "sky": {"envmap": "env.png", "intensity": 1.5, "rotate": 30},
    }


def jax_build(path):
    """-> (numpy SceneArrays tree, jax SceneArrays, SceneMeta, Config)."""
    cfg = jconfig.load_config(path)
    arrays, meta, _ = jconfig.build_scene(cfg)
    return jax.tree_util.tree_map(np.asarray, arrays), arrays, meta, cfg


def port_build(path, device="cpu"):
    """-> (SceneArrays, SceneMeta, Config) of the port."""
    cfg = tconfig.load_config(path)
    arrays, meta, _ = tconfig.build_scene(cfg, device)
    return arrays, meta, cfg
