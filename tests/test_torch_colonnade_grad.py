"""The colonnade's inverse-rendering step (the benchmark's `colonnade.grad`
cell) on the CPU against the plain reference (`rgkbench/reference/`),
shrunk: the `colonnade_grad` configuration at 6,000 triangles (a BVH
scene on the port's side), 48x27 at 1 spp.

Contracts:
* on seeded random parameters (texels, diffuse, specular, roughness,
  emission, the sun and the sky), the port's `make_loss_fn` loss equals
  the reference's, and every leaf's gradient equals the reference's
  within the cell's limits; every leaf the scene uses gets a finite,
  non-zero gradient;
* the cell's readings through the harness read sound against the
  reference, and its control and half-batch fault do not;
* an SGD step of each leaf whose seeded loss is smooth lowers the loss
  by what its gradient predicts;
* a run with `texels` detached in the port, or with the BxDF backward's
  LTC lanes zeroed, reads `correct` false;
* the texel gather (`textures._Gather`) gives plain indexing's forward
  and gradient bit for bit; a render dispatches plain indexing's ops
  and image, and the box's gradient step makes no texture lookup;
* the gradient step's probe stamps the texel backward (`tex_bwd_ns`,
  part of `grad_bwd_ns`) and counts the textured lookups
  (`tex_fetches`).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rgk_tpu_torch.diff import graph as dgraph
from rgk_tpu_torch.diff import params as dparams
from rgk_tpu_torch.integrator import graph, path
from rgk_tpu_torch.ops import bxdf, textures
from rgk_tpu_torch.ops import vecmath as vm
from rgk_tpu_torch.scene import arrays
from rgk_tpu_torch.scene import config as tconfig
from rgkbench import harness
from rgkbench.drivers import grad as grad_drv
from rgkbench.reference import render as ref
from rgkbench.reference.diff import params as rparams
from rgkbench.reference.integrator import path as rpath
from rgkbench.tests.conftest import small, small_config

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234
CELL = "colonnade.grad"
LIMITS = harness.workload(CELL)["check"]["limits"]
USED = ("texels", "mat_diffuse", "mat_specular", "mat_roughness",
        "mat_emission", "light_color", "light_intensity", "sky_color",
        "sky_intensity")
LTC_TYPES = (arrays.BSDF_LTC_BECKMANN, arrays.BSDF_LTC_GGX,
             arrays.BSDF_LTC_BECKMANN_DIFFUSE, arrays.BSDF_LTC_GGX_DIFFUSE)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return str(tmp_path_factory.mktemp("scenes"))


def _wl():
    return small(CELL, width=48, height=27, multisample=1)


def _cfg():
    return small_config("colonnade_grad", budget=6000)


def _driver():
    return harness.load_module("drivers", "grad_scaled")


def _random_values(params, seed):
    """Seeded random parameters, by leaf, as float32 numpy arrays: albedos,
    roughness and the sun's and sky's colours drawn afresh, the texels,
    emission and intensities scaled."""
    g = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        a = v.detach().numpy().astype(np.float64)
        if k in ("mat_diffuse", "mat_specular"):
            a = g.uniform(0.1, 0.8, a.shape)
        elif k == "mat_roughness":
            a = g.uniform(0.08, 0.5, a.shape)
        elif k in ("light_color", "sky_color"):
            a = g.uniform(0.5, 1.0, a.shape)
        else:
            a = a * g.uniform(0.6, 1.4, a.shape)
        out[k] = a.astype(np.float32)
    return out


def _loss_and_grads(loss_fn, params):
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {k: None if g is None else g.double().numpy()
             for k, g in zip(params, grads)}
    return float(loss.detach()), grads


@pytest.fixture(scope="module")
def both(scenes):
    """The port's and the reference's loss and gradients at one set of
    seeded random parameters, on the cell's lanes and target."""
    drv = _driver()
    cell = harness.Cell(CELL, _wl(), SEED, CPU, scenes, _cfg())
    cfg = tconfig.load_config(cell.scene_path)
    scene, meta, _ = tconfig.build_scene(cfg, CPU)
    cam = cfg.get_camera()
    assert scene.tri_pack.shape[0] > 4096 and meta.has_textures
    (px, py, si), target = drv.loop_inputs(
        scene, meta, cfg.settings, cam, cell.wl, SEED, path.render_lanes,
        dparams.extract_params, dparams.apply_params)
    values = _random_values(dparams.extract_params(scene), SEED)
    port = _loss_and_grads(
        dparams.make_loss_fn(scene, meta, cfg.settings, cam, px, py, si,
                             SEED, target),
        dparams.params_from_numpy(values, CPU))
    settings, rscene, rmeta, rcam = ref.load(cell.scene_path, CPU)
    (rpx, rpy, rsi), rtarget = drv.loop_inputs(
        rscene, rmeta, settings, rcam, cell.wl, SEED, rpath.render_lanes,
        rparams.extract_params, rparams.apply_params)
    want = _loss_and_grads(
        rparams.make_loss_fn(rscene, rmeta, settings, rcam, rpx, rpy, rsi,
                             SEED, rtarget),
        rparams.params_from_numpy(values, CPU))
    return port, want


def test_loss_equals_the_reference(both):
    (loss, _), (want, _) = both
    assert want > 0
    assert abs(loss - want) / want < LIMITS["loss_gap"]


def test_every_leaf_gradient_equals_the_reference(both):
    (_, grads), (_, want) = both
    for k in USED:
        assert grads[k] is not None and want[k] is not None, k
        assert np.isfinite(grads[k]).all(), k
        assert np.linalg.norm(grads[k]) > 0 and np.linalg.norm(want[k]) > 0, k
    gap = grad_drv._leaf_gap(grads, want, USED)
    assert gap < LIMITS["grad_gap"], gap


def test_harness_readings_are_sound(scenes):
    got = harness.readings(CELL, SEED, 0.05, CPU, wl=_wl(), scenes=scenes,
                           cfg=_cfg())
    for k, limit in LIMITS.items():
        assert got["sound"][k] < limit, (k, got["sound"])
    assert any(got["control"][k] > limit for k, limit in LIMITS.items())
    assert any(got["half_batch"][k] > limit for k, limit in LIMITS.items())


# The leaves whose seeded loss is smooth: each moves what a lane's path
# carries, never where it goes.  Roughness moves the LTC-sampled
# direction, and the marble's diffuse and specular move its lobe choice
# and the rescaled sample behind its direction; the hit found along the
# moved direction is detached, so their gradients leave that change out
# (PERF.md §6).  The sun's intensity (20,000) moves by less than its
# float32 spacing at these rates.
DESCENDING = ("texels", "mat_emission", "light_color", "sky_color",
              "sky_intensity")


@pytest.fixture(scope="module")
def descent(scenes):
    """The port's loss on the shrunk cell's lanes and target, at the
    configuration's parameters, and its gradient there."""
    drv = _driver()
    cell = harness.Cell(CELL, _wl(), SEED, CPU, scenes, _cfg())
    cfg = tconfig.load_config(cell.scene_path)
    scene, meta, _ = tconfig.build_scene(cfg, CPU)
    cam = cfg.get_camera()
    (px, py, si), target = drv.loop_inputs(
        scene, meta, cfg.settings, cam, cell.wl, SEED, path.render_lanes,
        dparams.extract_params, dparams.apply_params)
    loss_fn = dparams.make_loss_fn(scene, meta, cfg.settings, cam, px, py,
                                   si, SEED, target)
    params = dparams.extract_params(scene)
    loss = loss_fn(params)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True)))
    return loss_fn, params, float(loss.detach()), grads


@pytest.mark.parametrize("leaf", DESCENDING)
def test_sgd_step_of_a_smooth_leaf_lowers_the_loss(descent, leaf):
    """An SGD step of one leaf alone, at box_sphere.grad's rate 0.05,
    lowers the loss by what its gradient predicts, lr |g|^2, within 10%."""
    loss_fn, params, loss0, grads = descent
    g = grads[leaf]
    lr = 0.05
    with torch.no_grad():
        loss1 = float(loss_fn(dict(params, **{leaf: params[leaf] - lr * g})))
    predicted = -lr * float((g.double() ** 2).sum())
    assert predicted < 0 and loss1 < loss0
    assert abs((loss1 - loss0) - predicted) <= 0.1 * abs(predicted), (
        loss1 - loss0, predicted)


def _detached_texels(orig):
    def apply(scene, params):
        return orig(scene, dict(params, texels=params["texels"].detach()))
    return apply


class _ZeroLanes(torch.autograd.Function):
    """Identity whose backward zeroes the masked lanes' gradient."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        mask, = ctx.saved_tensors
        return torch.where(mask[..., None], 0.0, g), None


def _ltc_lanes(mat_pack, mat_id):
    kind = vm.take_rows(mat_pack, mat_id)[..., 12].to(torch.int32)
    return sum(kind == t for t in LTC_TYPES).bool()


def _ltc_zeroed_eval(orig):
    def eval_(scene, mat_pack, mat_id, *args, **kw):
        f = orig(scene, mat_pack, mat_id, *args, **kw)
        return _ZeroLanes.apply(f, _ltc_lanes(mat_pack, mat_id))
    return eval_


def _ltc_zeroed_sample(orig):
    def sample(scene, mat_pack, mat_id, *args, **kw):
        d, thr, leak = orig(scene, mat_pack, mat_id, *args, **kw)
        ltc = _ltc_lanes(mat_pack, mat_id)
        return _ZeroLanes.apply(d, ltc), _ZeroLanes.apply(thr, ltc), leak
    return sample


@pytest.mark.parametrize("fault", ["texels_detached", "ltc_backward_zeroed"])
def test_planted_fault_is_not_correct(fault, scenes, monkeypatch):
    if fault == "texels_detached":
        monkeypatch.setattr(dparams, "apply_params",
                            _detached_texels(dparams.apply_params))
    else:
        monkeypatch.setattr(bxdf, "eval_bxdf",
                            _ltc_zeroed_eval(bxdf.eval_bxdf))
        monkeypatch.setattr(bxdf, "sample_bxdf",
                            _ltc_zeroed_sample(bxdf.sample_bxdf))
    out = harness.run_cell(CELL, SEED, 0.05, False, CPU, wl=_wl(),
                           scenes=scenes, cfg=_cfg())
    assert not out["correct"], out["checks"]


@pytest.fixture
def one_thread():
    """The CPU's accumulate adds a repeated index's rows with atomics
    across threads, so plain indexing's own gradient is bit-stable on one
    thread only."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_texel_gather_is_plain_indexing_bit_for_bit(one_thread):
    """Forward and gradient against plain indexing, with a gradient of 0
    on 40% of the lanes (as `torch.where` gives an untextured lane),
    most of them on one texel: their rows go past the table."""
    g = torch.Generator().manual_seed(7)
    texels = torch.rand(1000, 3, generator=g)
    idx = torch.randint(0, 1000, (20000,), generator=g)
    dead = torch.rand(20000, generator=g) < 0.4
    idx = torch.where(dead & (torch.rand(20000, generator=g) < 0.9), 3, idx)
    upstream = torch.randn(20000, 3, generator=g)
    upstream[dead] = 0.0
    upstream[:100, 1] = 0.0   # a zero component alone keeps the lane
    upstream[100:120] = -0.0
    a = texels.clone().requires_grad_(True)
    b = texels.clone().requires_grad_(True)
    want = a[idx]
    got = textures._Gather.apply(b, idx)
    assert torch.equal(got, want)
    (ga,) = torch.autograd.grad(want, a, upstream)
    (gb,) = torch.autograd.grad(got, b, upstream)
    assert gb.shape == ga.shape and torch.equal(ga, gb)
    # Through `_fetch`: the Function under autograd, and without a
    # gradient the same values with nothing recorded.
    w = torch.tensor(40)
    ix, iy = torch.randint(-2, 42, (2, 300), generator=g)
    fetched = textures._fetch(b, torch.tensor(0), w, w // 2, ix, iy)
    assert fetched.grad_fn.name().endswith("_GatherBackward")
    with torch.no_grad():
        plain = textures._fetch(b, torch.tensor(0), w, w // 2, ix, iy)
    assert plain.grad_fn is None and torch.equal(plain, fetched.detach())


def test_texel_gradient_of_a_lookup_equals_plain_indexing(one_thread):
    """`resolve_color`'s texel gradient (a third of the lanes untextured)
    against the same lookup with the gather replaced by plain
    indexing."""
    from rgk_tpu_torch.scene.arrays import TextureAtlas

    g = torch.Generator().manual_seed(11)
    atlas = TextureAtlas(texels=torch.rand(64 * 32 + 16 * 16, 3,
                                           generator=g),
                         desc=torch.tensor([[0, 64, 32], [2048, 16, 16]],
                                           dtype=torch.int32))
    n = 5000
    tex_id = torch.randint(-1, 2, (n,), generator=g, dtype=torch.int32)
    uv = torch.rand(n, 2, generator=g) * 3 - 1
    solid = torch.rand(n, 3, generator=g)
    up = torch.randn(n, 3, generator=g)

    def texel_grad():
        t = atlas.texels.clone().requires_grad_(True)
        out = textures.resolve_color(atlas._replace(texels=t), tex_id,
                                     solid, uv)
        return torch.autograd.grad(out, t, up)[0]

    got = texel_grad()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(textures._Gather, "apply",
                   lambda texels, idx: texels[idx])
        want = texel_grad()
    assert float(want.abs().sum()) > 0 and torch.equal(got, want)


class _Ops(TorchDispatchMode):
    """The aten ops a block of code dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _plain_fetch(texels, offset, w, h, ix, iy):
    """The texel fetch as plain indexing, without the Function."""
    ix = torch.minimum(torch.clamp(ix, min=0), w - 1)
    iy = torch.minimum(torch.clamp(iy, min=0), h - 1)
    return texels[(offset + iy * w + ix).long()]


def _refuse(*args, **kw):
    raise AssertionError("the box's step made a texture lookup")


def test_renders_and_the_box_step_keep_plain_ops(scenes, monkeypatch):
    """A render of the textured scene dispatches the same ops and gives
    the same image, bit for bit, as with the fetch as plain indexing;
    the box's gradient step makes no texture lookup at all."""
    cell = harness.Cell(CELL, _wl(), SEED, CPU, scenes, _cfg())
    cfg = tconfig.load_config(cell.scene_path)
    scene, meta, _ = tconfig.build_scene(cfg, CPU)
    px, py, si = grad_drv.lanes(cfg.get_camera(), 1, CPU)

    def render():
        with _Ops() as rec:
            out = path.render_lanes(scene, meta, cfg.settings,
                                    cfg.get_camera(), px, py, si, SEED)
        return out.radiance, rec.ops

    got, ops = render()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(textures, "_fetch", _plain_fetch)
        want, plain_ops = render()
    assert float(got.sum()) > 0 and torch.equal(got, want)
    assert "aten.index.Tensor" in plain_ops and ops == plain_ops
    monkeypatch.setattr(textures, "resolve_color", _refuse)
    box = harness.Cell("box_sphere.grad", small("box_sphere.grad", width=8,
                                                height=8, multisample=1),
                       SEED, CPU, scenes)
    bcfg = tconfig.load_config(box.scene_path)
    bscene, bmeta, _ = tconfig.build_scene(bcfg, CPU)
    assert not bmeta.has_textures
    bx, by, bs = grad_drv.lanes(bcfg.get_camera(), 1, CPU)
    fn = dgraph.make_value_and_grad(bscene, bmeta, bcfg.settings,
                                    bcfg.get_camera(), bx, by, bs, SEED,
                                    torch.zeros(bx.shape[0], 3))
    loss, grads = fn(dparams.extract_params(bscene))
    assert float(loss) > 0 and grads["texels"] is None


def test_gradient_step_stamps_the_texel_backward(scenes):
    drv = _driver()
    cell = harness.Cell(CELL, _wl(), SEED, CPU, scenes, _cfg())
    cfg = tconfig.load_config(cell.scene_path)
    scene, meta, _ = tconfig.build_scene(cfg, CPU)
    cam = cfg.get_camera()
    (px, py, si), target = drv.loop_inputs(
        scene, meta, cfg.settings, cam, cell.wl, SEED, path.render_lanes,
        dparams.extract_params, dparams.apply_params)
    fn = dgraph.make_value_and_grad(scene, meta, cfg.settings, cam, px, py,
                                    si, SEED, target)
    graph.reset_stats()
    fn(dparams.extract_params(scene))
    st = graph.read_stats()
    assert st["grad_steps"] == 1
    assert st["tex_bwd_ns"] > 0 and st["grad_bwd_ns"] > st["tex_bwd_ns"]
    assert st["bxdf_bwd_ns"] == 0    # the plain BxDF on the CPU
    # Each textured lookup is one lane of a colour lookup with a texture:
    # at most the lanes x the bounces' two lookups (diffuse, specular).
    lanes = px.shape[0]
    assert 0 < st["tex_fetches"] <= 2 * lanes * (
        int(cfg.settings.recursion_max) + 1)
    # Outside a step nothing is stamped or counted.
    graph.reset_stats()
    loss_fn = dparams.make_loss_fn(scene, meta, cfg.settings, cam, px, py,
                                   si, SEED, target)
    params = dparams.extract_params(scene)
    torch.autograd.grad(loss_fn(params), [params["texels"]])
    st = graph.read_stats()
    assert st["tex_bwd_ns"] == st["tex_fetches"] == 0
