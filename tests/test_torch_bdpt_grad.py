"""BDPT gradients of rgk_tpu_torch (`reverse > 0`) on the CPU: autograd
through the port's per-sample path against central differences and
against jax.grad of rgk_tpu on the same inputs.

The scene is tests/test_torch_bdpt.py's 16x16 box at reverse 2, 4 spp,
plus a point light and a sky, so that every checked leaf (the point
light's intensity, the sky's) reaches the image.  256 lanes at pixels
and samples drawn with numpy (seed 3); the target is 0.8 x the image at
the starting parameters, so the loss is small and a central difference
resolves the smaller gradients in float32.  Roulette is off, so no
sampling decision depends on a material parameter.

A dropped connection's or splat's lane may hold a light vertex at a
miss's far point, where the geometry term is not finite.  rgk_tpu masks
only the product (rgk_tpu/integrator/path.py:521-524), so its gradients
are NaN there; the port swaps the dropped lanes' inputs for a finite
stand-in first (`path._finite_ends`), which leaves every kept lane's
value, and so every image, as it was.  At full width a second source
shows: the disc warp's sqrt of a sample that the lobe choice rescaled
to exactly 0, whose infinite derivative meets a dropped lobe's zero
gradient; the port's warp has a finite derivative there and the same
bits.

Tolerances, as tests/test_torch_grad.py's: each central difference at
eps 1e-3, rtol 0.03 (+ 1e-6); against rgk_tpu the loss within rtol
1e-4, and each leaf's gradient within 2e-3 * max|g_jax| + 1e-6 on the
entries where rgk_tpu's is finite.
"""

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch.diff.params import (PARAM_KEYS, extract_params,
                                       make_loss_fn, params_from_numpy)
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.ops import warps

N_LANES = 256
SEED = 3
OVERRIDES = dict(
    sky={"color": [0.3, 0.3, 0.4], "intensity": 1.0},
    lights=[{"position": [-0.8, 1.2, 0.8], "color": [1.0, 0.9, 0.8],
             "intensity": 10.0}])


def _unguarded(keep, lv, other):
    """`path._finite_ends` as if absent: the reference's computation."""
    return lv, other


class Setup:
    """The box committed by the port on the CPU, its lanes, the loss
    against 0.8 x the starting image, and the gradient, computed once."""

    def __init__(self, tmp_path):
        cfg = scenes.box_config(res=16, ms=4, reverse=2, **OVERRIDES)
        self.path = scenes.write_config(tmp_path, cfg, "bdpt_grad.json")
        self.arrays, self.meta, self.cfg = scenes.port_build(self.path)
        self.cam = self.cfg.get_camera()
        rng = np.random.default_rng(SEED)
        self.px = rng.integers(0, 16, N_LANES).astype(np.int32)
        self.py = rng.integers(0, 16, N_LANES).astype(np.int32)
        self.si = (np.arange(N_LANES) % 4).astype(np.int64)
        self.lanes = tuple(torch.from_numpy(x)
                           for x in (self.px, self.py, self.si))
        with torch.no_grad():
            start = tpath.render_lanes(
                self.arrays, self.meta, self.cfg.settings, self.cam,
                *self.lanes, SEED, differentiable=True).radiance
        self.target = (0.8 * start).numpy()
        self.loss_fn = make_loss_fn(
            self.arrays, self.meta, self.cfg.settings, self.cam,
            *self.lanes, SEED, torch.from_numpy(self.target))
        self.params = extract_params(self.arrays)
        self.loss, self.grad = self.value_and_grad(self.params)

    def value_and_grad(self, params):
        loss = self.loss_fn(params)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return float(loss.detach()), {
            k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(params, grads)}

    def fd(self, key, idx, eps):
        flat = self.params[key].detach().double().reshape(-1).clone()

        def loss_at(v):
            p2 = dict(self.params)
            arr = flat.clone()
            arr[idx] = v
            p2[key] = arr.reshape(self.params[key].shape).float()
            with torch.no_grad():
                return float(self.loss_fn(p2))

        v0 = float(flat[idx])
        return (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return Setup(tmp_path_factory.mktemp("bdpt_grad"))


@pytest.fixture(scope="module")
def reference(setup):
    """rgk_tpu's jax.value_and_grad on the same scene, lanes, target and
    parameters -> (loss, {leaf: numpy gradient})."""
    import jax
    import jax.numpy as jnp

    from rgk_tpu.diff import params as jparams
    from rgk_tpu.scene import config as jconfig

    cfg = jconfig.load_config(setup.path)
    arrays, meta, _ = jconfig.build_scene(cfg)
    loss_fn = jparams.make_loss_fn(
        arrays, meta, cfg.settings, cfg.get_camera(), jnp.asarray(setup.px),
        jnp.asarray(setup.py), jnp.asarray(setup.si.astype(np.uint32)),
        jnp.uint32(SEED), jnp.asarray(setup.target))
    jp = jparams.extract_params(arrays)
    jl, jg = jax.value_and_grad(loss_fn)(jp)
    return float(jl), {k: np.asarray(jg[k], np.float64) for k in PARAM_KEYS}


def test_every_leaf_gradient_is_finite(setup):
    for k in PARAM_KEYS:
        assert bool(torch.isfinite(setup.grad[k]).all()), k
    assert float(setup.grad["mat_diffuse"].abs().max()) > 0.0


# (parameter, flat index): mat_emission 12 is the "glow" row's red.
FD_CASES = [("mat_diffuse", 0), ("mat_emission", 12),
            ("light_intensity", 0), ("sky_intensity", 0)]


@pytest.mark.parametrize("key,idx", FD_CASES)
def test_grad_matches_finite_differences(setup, key, idx):
    eps, rtol = 1e-3, 0.03
    g = float(setup.grad[key].reshape(-1)[idx])
    fd = setup.fd(key, idx, eps)
    assert abs(g) > 1e-4, (key, g)
    assert abs(g - fd) <= rtol * max(abs(fd), abs(g)) + 1e-6, (key, g, fd)


def test_loss_matches_reference(setup, reference):
    jl = reference[0]
    assert jl > 0.0
    assert abs(setup.loss - jl) <= 1e-4 * abs(jl), (setup.loss, jl)


def test_grad_matches_reference_where_finite(setup, reference):
    params = params_from_numpy(
        {k: setup.params[k].detach().numpy() for k in PARAM_KEYS}, "cpu")
    _, grads = setup.value_and_grad(params)
    for k in PARAM_KEYS:
        want = reference[1][k]
        got = grads[k].double().numpy()
        ok = np.isfinite(want)
        tol = 2e-3 * float(np.abs(want[ok]).max(initial=0.0)) + 1e-6
        assert np.abs(got - want)[ok].max(initial=0.0) <= tol, (
            k, np.abs(got - want)[ok].max(), tol)


def test_reference_gradient_is_not_finite(setup, reference):
    """The hazard (ROADMAP.md section 3): rgk_tpu's masked connection
    gives NaN gradients on these inputs; the port's are finite, so the
    port does not match it."""
    bad = [k for k in PARAM_KEYS if not np.isfinite(reference[1][k]).all()]
    assert "mat_diffuse" in bad and "mat_emission" in bad, bad
    for k in bad:
        assert bool(torch.isfinite(setup.grad[k]).all()), k


def test_unguarded_connection_gives_nan_in_the_port(setup, monkeypatch):
    """Without the stand-in the port's gradient is NaN as the
    reference's, and the loss is the same: the repair is what makes the
    gradient finite, and it moves no value."""
    monkeypatch.setattr(tpath, "_finite_ends", _unguarded)
    loss, grads = setup.value_and_grad(extract_params(setup.arrays))
    assert loss == setup.loss
    assert not bool(torch.isfinite(grads["mat_diffuse"]).all())


def test_repair_leaves_images_bit_equal(setup, monkeypatch):
    """The queued BDPT tracer (radiance, splat image, rays) and the
    per-sample path (radiance, splats) give the same bits with the
    stand-in as without it."""
    px, py = (torch.from_numpy(x) for x in (setup.px, setup.py))
    args = (setup.arrays, setup.meta, setup.cfg.settings, setup.cam)

    def run():
        queued = tpath.trace_wavefront_queued_bdpt(*args, px, py, 0, 4, 42)
        lanes = tpath.render_lanes(*args, *setup.lanes, 42)
        return (*queued, lanes.radiance, lanes.splat_pix, lanes.splat_val)

    repaired = run()
    monkeypatch.setattr(tpath, "_finite_ends", _unguarded)
    plain = run()
    assert float(repaired[1].sum()) > 0.0
    for a, b in zip(repaired, plain):
        assert torch.equal(a, b)


def test_disc_warp_is_the_reference_with_a_finite_gradient_at_zero():
    """warps.to_disc_uniform on samples with exact zeros in the radial
    coordinate: bit for bit the same formula with torch.sqrt, within rtol
    1e-6 / atol 1e-6 of rgk_tpu's (sin and cos of another library, as
    tests/test_torch_bdpt.py holds the warps), and its gradient finite
    there (sqrt's is infinite: 0 x inf = NaN on a dropped lobe)."""
    import jax.numpy as jnp

    from rgk_tpu.ops import warps as jwarps

    rng = np.random.default_rng(41)
    u = rng.random((4096, 2), dtype=np.float32)
    u[::7, 0] = 0.0
    t = torch.from_numpy(u)
    got = warps.to_disc_uniform(t)
    r, a = torch.sqrt(t[:, 0]), t[:, 1] * warps.TWO_PI
    assert torch.equal(got, torch.stack([r * torch.sin(a),
                                         r * torch.cos(a)], dim=-1))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jwarps.to_disc_uniform(jnp.asarray(u))),
        rtol=1e-6, atol=1e-6)
    x = torch.from_numpy(u).requires_grad_(True)
    dropped = torch.where(torch.from_numpy(u[:, :1] > 0.5),
                          warps.to_hemisphere_cosine_z(x), 0.0)
    (g,) = torch.autograd.grad(dropped.sum(), [x])
    assert bool(torch.isfinite(g).all())
