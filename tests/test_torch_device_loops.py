"""The port's device loops on the CPU: the per-sample path's runner
(`integrator/graph.py` `LaneGraph`), the gradient step as one call
(`diff/graph.py` `make_value_and_grad`), and the bound on the queued
loop's iterations.  On the CPU each runner runs the body it captures on
a card, eagerly, on its static buffers.

Contracts:
* `LaneGraph.trace` equals `render_lanes` (the eager per-sample path)
  bit for bit, NEE and BDPT, on a flat and a BVH scene, through one
  runner for two calls that differ in pixels, samples and seed; and
  rgk_tpu's `render_lanes` within tests/test_torch_slice.py's tolerance
  (rtol 1e-4 / atol 1e-5 on >= 99% of lanes, rays within 0.5%);
* `make_value_and_grad` equals `torch.autograd.grad` of
  `make_loss_fn(...)(params)` bit for bit, and rgk_tpu's
  `jax.value_and_grad` within tests/test_torch_grad.py's
  `test_grad_matches_reference` tolerance (loss rtol 1e-4, each leaf
  within 2e-3 * max|g_jax| + 1e-6), for two parameter values through
  one runner;
* a queued block ends within `n_samples * depth` iterations (each step
  restarts an idle lane that has samples left, and a sample ends within
  `depth` steps), with and without roulette, NEE and BDPT; stepping
  exactly that many times with no read of the end test gives the state
  of reading it before every step, bit for bit (all but the bounce
  counters of dead lanes, which no output reads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.diff import params as jparams
from rgk_tpu.integrator import path as jpath
from rgk_tpu.scene import config as jconfig
from rgk_tpu_torch.diff.graph import make_value_and_grad
from rgk_tpu_torch.diff.params import (PARAM_KEYS, extract_params,
                                       make_loss_fn, params_from_numpy)
from rgk_tpu_torch.integrator import graph
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.scene import config as tconfig

RES, MS, N_LANES = 16, 4, 192


def _box(tmp_path, bvh, reverse, russian=None):
    cfg = scenes.box_config(res=RES, ms=MS, reverse=reverse)
    if bvh:
        cfg = scenes.add_sphere(tmp_path, cfg, n_tris=5000)
    if russian is not None:
        cfg["russian"] = russian
    return scenes.write_config(tmp_path, cfg, "box.json")


def _lanes(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, RES, N_LANES).astype(np.int32),
            rng.integers(0, RES, N_LANES).astype(np.int32),
            rng.integers(0, 3 * MS, N_LANES).astype(np.int64))


def _assert_lanes_close(port, ref, port_rays, ref_rays):
    close = np.isclose(port, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(port_rays - ref_rays) <= 0.005 * ref_rays
    assert ref.mean() > 0.0


@pytest.mark.timeout(300)
@pytest.mark.parametrize("bvh", [False, True], ids=["flat", "bvh"])
@pytest.mark.parametrize("reverse", [0, 2], ids=["nee", "bdpt"])
def test_lane_runner_equals_render_lanes(tmp_path, bvh, reverse):
    """Two calls through one LaneGraph (other pixels, samples and seed)
    against render_lanes bit for bit; the first against rgk_tpu's."""
    path = _box(tmp_path, bvh, reverse)
    arrays, meta, cfg = scenes.port_build(path)
    assert meta.has_bvh == bvh
    s, cam = cfg.settings, cfg.get_camera()
    runner = graph.LaneGraph(arrays, meta, s, cam, N_LANES)
    for seed in (42, 7):
        px, py, si = _lanes(seed)
        args = (torch.from_numpy(px), torch.from_numpy(py),
                torch.from_numpy(si), seed)
        got = [t.clone() for t in runner.trace(*args, cam)]
        want = tpath.render_lanes(arrays, meta, s, cam, *args)
        assert got[0].shape == (N_LANES, 3)
        assert got[2].shape == (N_LANES, reverse)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    _, jarrays, jmeta, jcfg = scenes.jax_build(path)
    px, py, si = _lanes(42)
    ref = jpath.render_lanes(jarrays, jmeta, jcfg.settings, jcfg.get_camera(),
                             jnp.asarray(px), jnp.asarray(py),
                             jnp.asarray(si.astype(np.uint32)),
                             jnp.uint32(42))
    first = tpath.render_lanes(arrays, meta, s, cam, torch.from_numpy(px),
                               torch.from_numpy(py), torch.from_numpy(si), 42)
    _assert_lanes_close(first.radiance.numpy(), np.asarray(ref.radiance),
                        int(first.rays), int(ref.rays))


def _grad_case(tmp_path, bvh):
    """tests/test_grad.py's scene (8x8, 64 lanes, seed 3, black target),
    committed flat or with a BVH (threshold 8)."""
    path = scenes.write_config(tmp_path, scenes.GRAD_SCENE)
    kw = (dict(build_bvh=True, bvh_threshold=8) if bvh
          else dict(build_bvh=False))
    cfg = tconfig.load_config(path)
    arrays, meta, _ = tconfig.build_scene(cfg, "cpu", **kw)
    assert meta.has_bvh == bvh
    i = np.arange(64)
    lanes = ((i % 8).astype(np.int32), (i // 8).astype(np.int32),
             np.zeros(64, np.int64))
    return path, kw, cfg, arrays, meta, lanes


def _scaled(params, f):
    """The parameters with albedo, emission and intensities times f."""
    out = dict(params)
    for k in ("mat_diffuse", "mat_emission", "light_intensity",
              "sky_intensity"):
        out[k] = params[k].detach() * f
    return out


@pytest.mark.timeout(300)
@pytest.mark.parametrize("bvh", [False, True], ids=["flat", "bvh"])
def test_value_and_grad_equals_autograd(tmp_path, bvh):
    """Two parameter values through one make_value_and_grad runner:
    bit-equal to autograd of make_loss_fn, and within the reference
    tolerance of rgk_tpu's jax.value_and_grad."""
    path, kw, cfg, arrays, meta, lanes = _grad_case(tmp_path, bvh)
    t_lanes = [torch.from_numpy(x) for x in lanes]
    target = torch.zeros(64, 3)
    args = (arrays, meta, cfg.settings, cfg.get_camera(), *t_lanes, 3,
            target)
    fn = make_value_and_grad(*args)
    loss_fn = make_loss_fn(*args)

    jcfg = jconfig.load_config(path)
    jarrays, jmeta, _ = jconfig.build_scene(jcfg, **kw)
    jloss = jparams.make_loss_fn(
        jarrays, jmeta, jcfg.settings, jcfg.get_camera(),
        *(jnp.asarray(x) for x in lanes[:2]),
        jnp.asarray(lanes[2].astype(np.uint32)), jnp.uint32(3),
        jnp.zeros((64, 3), jnp.float32))
    base = jparams.extract_params(jarrays)

    for f in (1.0, 1.3):
        jp = {k: v * f if k in ("mat_diffuse", "mat_emission",
                                "light_intensity", "sky_intensity") else v
              for k, v in base.items()}
        params = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   "cpu")
        loss, grads = fn(params)
        loss, grads = loss.clone(), {k: None if g is None else g.clone()
                                     for k, g in grads.items()}
        want_l = loss_fn(params)
        want = torch.autograd.grad(want_l, list(params.values()),
                                   allow_unused=True)
        assert torch.equal(loss, want_l.detach())
        for k, w in zip(params, want):
            assert (grads[k] is None) == (w is None), k
            if w is not None:
                assert torch.equal(grads[k], w), k

        jl, jg = jax.value_and_grad(jloss)(jp)
        jl = float(jl)
        assert jl > 0.0
        assert abs(float(loss) - jl) <= 1e-4 * abs(jl), (float(loss), jl)
        for k in PARAM_KEYS:
            want_j = np.asarray(jg[k], np.float64)
            got = (np.zeros_like(want_j) if grads[k] is None
                   else grads[k].double().numpy())
            tol = 2e-3 * float(np.abs(want_j).max(initial=0.0)) + 1e-6
            assert np.abs(got - want_j).max(initial=0.0) <= tol, k


@pytest.mark.timeout(300)
def test_value_and_grad_leaves_are_its_own(tmp_path):
    """The runner copies the parameters into its own leaves: the
    caller's tensors and the scene are not written, and the caller's
    leaves get no .grad."""
    _, _, cfg, arrays, meta, lanes = _grad_case(tmp_path, False)
    fn = make_value_and_grad(arrays, meta, cfg.settings, cfg.get_camera(),
                             *(torch.from_numpy(x) for x in lanes), 3,
                             torch.zeros(64, 3))
    params = _scaled(extract_params(arrays), 0.5)
    before = {k: v.clone() for k, v in params.items()}
    diffuse = arrays.materials.diffuse.clone()
    loss, grads = fn(params)
    assert float(loss) > 0.0 and grads["mat_diffuse"] is not None
    for k, v in params.items():
        assert torch.equal(v, before[k]) and v.grad is None, k
    assert torch.equal(arrays.materials.diffuse, diffuse)


def _walk(arrays, meta, s, cam, px, py, seed, steps=None):
    """The queued eye walk of one block from the split pieces: the end
    test read before every step, or (`steps`) that many steps with no
    read.  -> (state, iterations that found the loop live)."""
    su = tpath._setup(arrays, meta, s)
    inp = tpath._queued_inputs(px, py, cam.xres, 4, MS, seed)
    q = tpath._queued_init(inp)
    if int(s.reverse) > 0:
        lpack, _, rays = tpath._light_phase(arrays, meta, s, su, cam, inp,
                                            MS, 1)
        inp = inp._replace(lpack=lpack)
        q = q._replace(rays=rays)
    n = 0
    while (bool(tpath._queued_live(q, inp)) if steps is None
           else n < steps):
        q = tpath._queued_step(arrays, meta, s, su, cam, inp, q, 1)
        n += 1
    return q, n


@pytest.mark.timeout(300)
@pytest.mark.parametrize("russian", [None, 0.6], ids=["no_rr", "rr"])
@pytest.mark.parametrize("reverse", [0, 2], ids=["nee", "bdpt"])
def test_queued_iterations_within_bound(tmp_path, russian, reverse):
    """A block's iterations (the runner's count, and the split loop's)
    are at most n_samples * depth; n_samples * depth steps with no read
    give the read-every-step state bit for bit."""
    arrays, meta, cfg = scenes.port_build(_box(tmp_path, False, reverse,
                                               russian))
    s, cam = cfg.settings, cfg.get_camera()
    assert (float(s.russian) > 0.0) == (russian is not None)
    bound = MS * int(s.recursion_max)
    pix = torch.arange(RES * RES)
    px, py = (pix % RES).to(torch.int32), (pix // RES).to(torch.int32)
    graph.reset_stats()
    graph.QueuedGraph(arrays, meta, s, cam, RES * RES, MS).block(
        px, py, 4, 11, cam)
    st = graph.read_stats()
    assert 0 < st["iterations"] <= bound and st["overshoot"] == 0
    read, n = _walk(arrays, meta, s, cam, px, py, 11)
    assert n == st["iterations"]
    blind, _ = _walk(arrays, meta, s, cam, px, py, 11, steps=bound)
    # A step on a dead state moves only the dead lanes' bounce counters.
    for f in read._fields:
        if f != "bounce":
            assert torch.equal(getattr(blind, f), getattr(read, f)), f
