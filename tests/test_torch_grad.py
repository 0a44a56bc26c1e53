"""Gradients of rgk_tpu_torch: autograd through the port's renderer
against central finite differences, and against jax.grad of rgk_tpu on
the same scene and parameters, on the CPU.

The scenes are tests/test_grad.py's, inline, plus its mesh-BVH case
with a tools/make_bigscene.py sphere committed with bvh_threshold=8, so
every hit comes from the tree walk (the reference's fixture skips
without its corpus), and the benchmark's colonnade_grad configuration
shrunk to 6,000 triangles at 16x16 (a stone texture, LTC-GGX and
LTC-GGX-diffuse lobes, emissive panels, a sun and a sky, on the BVH).  With a fixed seed and roulette off no sampling
decision depends on a parameter, so the loss is piecewise smooth and
finite differences converge to the analytic gradient.

Tolerances: each finite-difference check as tests/test_grad.py makes it
(eps, rtol per parameter, + 1e-6); the port against rgk_tpu: the loss
within rtol 1e-4, and every leaf's gradient within 2e-3 * max|g_jax| +
1e-6 (both differentiate the same estimator; the float32 sums add in
another order).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch.diff.params import (PARAM_KEYS, apply_params,
                                       extract_params, make_loss_fn,
                                       params_from_numpy)
from rgk_tpu_torch.integrator.path import render_lanes
from rgk_tpu_torch.scene.config import build_scene, load_config

N_LANES = 64
SEED = 3

# Direct areal lighting only: black sky, no point light, depth 1.
NEE_SCENE = {
    "output-file": "t.exr", "output-width": 8, "output-height": 8,
    "multisample": 8, "recursion-max": 1, "russian": -1.0,
    "camera": {"position": [0, 2, 0.001], "lookat": [0, 0, 0], "fov": 50},
    "sky": {"color": [0, 0, 0], "intensity": 0.0},
    "materials": [
        {"name": "floor", "brdf": "diffuse", "diffuse": [0.6, 0.6, 0.6]},
        {"name": "glow", "brdf": "diffuse", "diffuse": [0, 0, 0],
         "emission": [2.0, 1.0, 0.5]},
    ],
    "scene": [
        {"primitive": "plane", "axis": "Y", "scale": [4, 1, 4],
         "material": "floor"},
        {"primitive": "tri", "translate": [0, 1.5, 0],
         "rotate": [0, 0, 180], "scale": [0.5, 1, 0.5], "material": "glow"},
    ],
}

# A textured floor under a point light plus an envmap sky.
TEXEL_SCENE = {
    "output-file": "t.exr", "output-width": 8, "output-height": 8,
    "multisample": 4, "recursion-max": 2, "russian": -1.0,
    "camera": {"position": [0, 0.8, 2.5], "lookat": [0, 0.6, 0], "fov": 70},
    "sky": {"envmap": "env.png", "intensity": 1.0},
    "materials": [
        {"name": "floor", "brdf": "diffuse", "diffuse-texture": "floor.png"},
    ],
    "scene": [
        {"primitive": "plane", "axis": "Y", "scale": [3, 1, 3],
         "material": "floor"},
    ],
    "lights": [{"position": [1, 2, 1], "color": [1, 0.9, 0.8],
                "intensity": 2.0}],
}

# A 1,280-triangle sphere on a floor, committed with a BVH.
MESH_SCENE = {
    "output-file": "t.exr", "output-width": 8, "output-height": 8,
    "multisample": 4, "recursion-max": 2, "russian": -1.0,
    "camera": {"position": [0, 1.0, 2.5], "lookat": [0, 0.3, 0], "fov": 50},
    "sky": {"color": [0.2, 0.25, 0.3], "intensity": 1.0},
    "materials": [
        {"name": "floor", "brdf": "diffuse", "diffuse": [0.5, 0.45, 0.4]},
        {"name": "ball", "brdf": "diffuse", "diffuse": [0.6, 0.3, 0.2]},
    ],
    "scene": [
        {"primitive": "plane", "axis": "Y", "scale": [5, 1, 5],
         "material": "floor"},
        {"file": "sphere.obj", "material": "ball",
         "translate": [0, 0.45, 0], "scale": [0.45, 0.45, 0.45]},
    ],
    "lights": [{"position": [1.5, 2.5, 1.5], "color": [1, 1, 0.9],
                "intensity": 3.0}],
}


def _write(tmp_path_factory, name, cfg_d):
    d = tmp_path_factory.mktemp(name)
    if name == "colonnade":
        from rgkbench import harness

        wl = copy.deepcopy(harness.workload("colonnade.grad"))
        wl["scene"].update({"output-width": 16, "output-height": 16})
        cfg = dict(harness.config("colonnade_grad"), budget=6000)
        return harness.scene_file("colonnade.grad", wl, str(d), cfg)
    if name == "texel":
        from rgk_tpu_torch.io.texture_io import write_png

        rng = np.random.RandomState(7)
        write_png(str(d / "floor.png"), rng.uniform(0.2, 0.9, (4, 4, 3)))
        write_png(str(d / "env.png"), rng.uniform(0.1, 0.8, (4, 8, 3)))
    if name == "mesh":
        big = scenes.tool("make_bigscene")
        big._write_obj(str(d / "sphere.obj"), *big.make_sphere(
            1280, 0.0, 0.0, 0.0, 1.0))
    p = d / "scene.json"
    p.write_text(json.dumps(cfg_d))
    return str(p)


def _lanes(cam):
    """One lane a pixel at sample 0: N_LANES on an 8x8 image."""
    i = np.arange(cam.xres * cam.yres)
    return (torch.from_numpy((i % cam.xres).astype(np.int32)),
            torch.from_numpy((i // cam.xres).astype(np.int32)),
            torch.zeros(i.size, dtype=torch.int64))


class Setup:
    """One scene committed by the port on the CPU, its loss (target 0)
    and parameters, and the gradient at them, computed once."""

    def __init__(self, path, bvh):
        self.path, self.bvh = path, bvh
        self.cfg = load_config(path)
        kw = (dict(build_bvh=True, bvh_threshold=8) if bvh
              else dict(build_bvh=False))
        self.arrays, self.meta, _ = build_scene(self.cfg, "cpu", **kw)
        assert self.meta.has_bvh == bvh
        self.cam = self.cfg.get_camera()
        self.lanes = _lanes(self.cam)
        self.loss_fn = make_loss_fn(
            self.arrays, self.meta, self.cfg.settings, self.cam,
            *self.lanes, SEED, torch.zeros(self.lanes[0].shape[0], 3))
        self.params = extract_params(self.arrays)
        self.loss = self.loss_fn(self.params)
        self.grad = dict(zip(self.params, torch.autograd.grad(
            self.loss, list(self.params.values()), allow_unused=True)))

    def g(self, key):
        g = self.grad[key]
        return (torch.zeros_like(self.params[key]) if g is None else g)

    def fd_check(self, key, idx, eps, rtol):
        g_val = float(self.g(key).reshape(-1)[idx])
        flat = self.params[key].detach().double().reshape(-1).clone()

        def loss_at(v):
            p2 = dict(self.params)
            arr = flat.clone()
            arr[idx] = v
            p2[key] = arr.reshape(self.params[key].shape).float()
            with torch.no_grad():
                return float(self.loss_fn(p2))

        v0 = float(flat[idx])
        fd = (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
        assert np.isfinite(g_val)
        if abs(fd) < 1e-7 and abs(g_val) < 1e-7:
            return
        assert abs(g_val - fd) <= rtol * max(abs(fd), abs(g_val)) + 1e-6, (
            key, idx, g_val, fd)


_SCENES = {"grad": (scenes.GRAD_SCENE, False), "nee": (NEE_SCENE, False),
           "texel": (TEXEL_SCENE, False), "mesh": (MESH_SCENE, True),
           "colonnade": (None, True)}


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cfg_d, bvh = _SCENES[name]
            cache[name] = Setup(_write(tmp_path_factory, name, cfg_d), bvh)
        return cache[name]

    return get


# (scene, parameter, flat index, eps, rtol), as tests/test_grad.py.
FD_CASES = [
    ("grad", "mat_diffuse", 0, 1e-3, 0.03),
    ("grad", "mat_emission", 3, 1e-3, 0.03),   # "glow", red
    ("grad", "light_intensity", 0, 1e-3, 0.03),
    ("grad", "sky_intensity", 0, 1e-3, 0.03),
    # LTC interpolation is piecewise multilinear: stay inside a cell.
    ("grad", "mat_roughness", 2, 2e-4, 0.08),
    ("grad", "mat_specular", 6, 1e-3, 0.05),
    ("nee", "mat_emission", 3, 1e-3, 0.03),
    ("nee", "mat_emission", 4, 1e-3, 0.03),
    ("mesh", "mat_diffuse", 3, 1e-3, 0.03),    # the sphere, red
    ("mesh", "light_intensity", 0, 1e-3, 0.03),
]


@pytest.mark.parametrize("scene,key,idx,eps,rtol", FD_CASES)
def test_grad_matches_finite_differences(setups, scene, key, idx, eps, rtol):
    s = setups(scene)
    if scene == "nee":
        # Through the direct-lighting pathway the gradient is nonzero.
        assert abs(float(s.g(key).reshape(-1)[idx])) > 1e-7
    s.fd_check(key, idx, eps, rtol)


def _texel_slice(arrays, tex_id):
    off, w, h = (int(v) for v in arrays.textures.desc[tex_id])
    return 3 * off, 3 * (off + w * h)


@pytest.mark.parametrize("which", ["floor", "envmap"])
def test_grad_texel(setups, which):
    """The strongest texel of the floor texture (through the diffuse
    fetch) and of the envmap (through the sky escape)."""
    s = setups("texel")
    sky_tex = int(s.arrays.sky_tex)
    assert sky_tex >= 0
    tex = sky_tex if which == "envmap" else (0 if sky_tex != 0 else 1)
    lo, hi = _texel_slice(s.arrays, tex)
    g = s.g("texels").reshape(-1)
    assert float(g[lo:hi].abs().max()) > 1e-7, f"no gradient reaches {which}"
    idx = lo + int(g[lo:hi].abs().argmax())
    s.fd_check("texels", idx, 1e-3, 0.03)


def test_nee_emission_follows_params(setups):
    """Scaling mat_emission through apply_params scales the NEE-lit
    pixels: the areal rows' emission columns follow the materials, and
    the committed scene is not written."""
    s = setups("nee")
    before = s.arrays.lights.areal_rows.clone()

    def render(params):
        with torch.no_grad():
            return render_lanes(apply_params(s.arrays, params), s.meta,
                                s.cfg.settings, s.cam, *s.lanes, SEED,
                                differentiable=True).radiance.numpy()

    base = render(s.params)
    assert base.max() > 1e-4
    p2 = dict(s.params)
    p2["mat_emission"] = s.params["mat_emission"] * 2.0
    doubled = render(p2)
    lit = base.max(axis=-1) > 1e-4
    np.testing.assert_allclose(doubled[lit], 2.0 * base[lit], rtol=1e-5)
    assert torch.equal(s.arrays.lights.areal_rows, before)


def test_optimizer_step_reduces_loss(setups):
    """One torch.optim.SGD step on every parameter lowers the loss."""
    s = setups("grad")
    params = extract_params(s.arrays)
    opt = torch.optim.SGD(list(params.values()), lr=0.05)
    opt.zero_grad()
    l0 = s.loss_fn(params)
    l0.backward()
    opt.step()
    with torch.no_grad():
        l1 = s.loss_fn(params)
    assert float(l1) < float(l0.detach())
    assert torch.equal(s.arrays.materials.diffuse,
                       extract_params(s.arrays)["mat_diffuse"].detach())


def test_gradients_are_finite_everywhere(setups):
    """Every leaf of every scene gets a finite gradient (no NaN from a
    masked-out lane)."""
    for name in _SCENES:
        s = setups(name)
        for k in PARAM_KEYS:
            assert bool(torch.isfinite(s.g(k)).all()), (name, k)


@pytest.mark.parametrize("scene", sorted(_SCENES))
def test_grad_matches_reference(setups, scene):
    """rgk_tpu's jax.grad and the port's autograd on the same scene and
    parameters (rgk_tpu's extract_params through params_from_numpy)."""
    import jax
    import jax.numpy as jnp

    from rgk_tpu.diff import params as jparams
    from rgk_tpu.scene import config as jconfig

    s = setups(scene)
    cfg = jconfig.load_config(s.path)
    kw = (dict(build_bvh=True, bvh_threshold=8) if s.bvh
          else dict(build_bvh=False))
    arrays, meta, _ = jconfig.build_scene(cfg, **kw)
    px, py, si = (jnp.asarray(x.numpy()) for x in s.lanes)
    loss_fn = jparams.make_loss_fn(
        arrays, meta, cfg.settings, cfg.get_camera(), px, py,
        si.astype(jnp.uint32), jnp.uint32(SEED),
        jnp.zeros((px.shape[0], 3), jnp.float32))
    jp = jparams.extract_params(arrays)
    jl, jg = jax.value_and_grad(loss_fn)(jp)

    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    tl = s.loss_fn(tp)
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()),
                                          allow_unused=True)))
    jl = float(jl)
    assert jl > 0.0
    if scene == "colonnade":   # texels, LTC lobes, panels, sun and sky
        assert all(np.abs(np.asarray(jg[k])).max() > 0 for k in PARAM_KEYS)
    assert abs(float(tl.detach()) - jl) <= 1e-4 * abs(jl), (float(tl), jl)
    for k in PARAM_KEYS:
        want = np.asarray(jg[k], np.float64)
        got = (np.zeros_like(want) if tg[k] is None
               else tg[k].double().numpy())
        tol = 2e-3 * float(np.abs(want).max(initial=0.0)) + 1e-6
        assert np.abs(got - want).max(initial=0.0) <= tol, (
            k, np.abs(got - want).max(), tol)


def test_flat_plain_record_under_autograd_is_the_sweeps():
    """With rays that carry a gradient, flat_plain recomputes the
    winner's record from its row: the same bits as the sweep without
    autograd, a gradient into the rays, and no [R, M] plane saved."""
    from rgk_tpu_torch.ops.flat_intersect import flat_plain
    from rgk_tpu_torch.scene.builder import build_tri_pack

    verts, tris = scenes.soup(300, seed=5)
    pack = torch.zeros(300, 13)
    pack[:, :12] = torch.from_numpy(build_tri_pack(verts, tris))
    ro, rd = (torch.from_numpy(x) for x in scenes.rays(2000, seed=6))
    args = (torch.full((2000,), 0.01), torch.full((2000,), 1e4),
            torch.full((2000,), -1, dtype=torch.int32))
    plain = flat_plain(pack, ro, rd, *args)
    rdg = rd.clone().requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        got = flat_plain(pack, ro, rdg, *args)
    assert (plain[1] >= 0).float().mean() > 0.05
    for a, b in zip(got, plain):
        assert torch.equal(a.detach(), b)
    assert max(saved) <= 2000 * 13
    (g,) = torch.autograd.grad(got[0].sum() + got[2].sum(), rdg)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
