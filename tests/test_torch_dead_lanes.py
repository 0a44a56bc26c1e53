"""A dead lane's extension query has an empty window (`path._extend_path`
asks (0, -1) where `alive` is False), so it gets the no-hit record
instead of re-tracing its stale ray.  On the CPU, on a flat box and on
the box with a 5,000-triangle sphere (a BVH scene):

* `flat_plain` and `intersect_bvh` return the no-hit record (t BIG,
  tri -1, barycentrics 0) for every ray whose window is empty, closest
  and any hit, and the same hits as before for the others;
* one queued NEE step and one per-sample bounce give the same state,
  sample radiance, radiance and ray count, bit for bit, as the same
  step with every extension query asking (0, RAY_FAR) (the call before
  the empty window), from states where dead lanes' stale rays hit;
* a gradient step (roulette on, so lanes die at hits) gives the same
  loss and gradients bit for bit, all finite.
"""

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch.diff.params import extract_params, make_loss_fn
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.ops import flat_intersect as fi
from rgk_tpu_torch.ops import intersect as isect
from rgk_tpu_torch.ops import sampler as smp

RES = 16
ROULETTE = {"recursion-max": 8, "russian": 0.74}


@pytest.fixture(scope="module", params=[False, True], ids=["flat", "bvh"])
def box(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("dead_bvh" if request.param else "dead")
    cfg = scenes.box_config(res=RES, ms=1, **ROULETTE)
    if request.param:
        cfg = scenes.add_sphere(d, cfg, n_tris=5000)
    arrays, meta, c = scenes.port_build(scenes.write_config(d, cfg))
    assert meta.has_bvh == request.param
    return arrays, meta, c.settings, c.get_camera()


class Unmasked:
    """`isect.make_intersector` whose closest queries ask (t_min,
    RAY_FAR) whatever window they are given, and count the lanes whose
    given window was empty but that hit something."""

    def __init__(self, monkeypatch):
        self.dead_hits = 0
        orig = isect.make_intersector

        def make(meta):
            query = orig(meta)

            def unmasked(scene, ro, rd, t_min, t_max, exclude=None,
                         any_hit=False):
                if any_hit:
                    return query(scene, ro, rd, t_min, t_max,
                                 exclude=exclude, any_hit=True)
                dead = ~(t_max > t_min)
                hit = query(scene, ro, rd, t_min, tpath.RAY_FAR,
                            exclude=exclude)
                self.dead_hits += int((hit.valid & dead).sum())
                return hit

            return unmasked

        monkeypatch.setattr(isect, "make_intersector", make)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want):
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(_bits(a), _bits(b)), name


def _pixels():
    pix = torch.arange(RES * RES)
    return (pix % RES).to(torch.int32), (pix // RES).to(torch.int32)


@pytest.mark.parametrize("any_hit", [False, True])
def test_empty_windows_get_the_no_hit_record(box, any_hit):
    arrays, meta, _, _ = box
    ro, rd = (torch.from_numpy(a) for a in scenes.rays(4096, seed=3,
                                                       spread=2.0))
    ro = ro + torch.tensor([0.0, 1.2, 0.0])
    n = ro.shape[0]
    t_min = torch.full((n,), 1e-3)
    far = torch.full((n,), 100.0)
    empty = torch.from_numpy(np.random.default_rng(4).random(n) < 0.6)
    bounds = torch.stack([t_min, torch.full((n,), -1.0),
                          torch.full((n,), float("nan"))])
    t_max = torch.where(empty, bounds[torch.arange(n) % 3, torch.arange(n)],
                        far)
    query = isect.make_intersector(meta)
    got = query(arrays, ro, rd, t_min, t_max, any_hit=any_hit)
    full = query(arrays, ro, rd, t_min, far, any_hit=any_hit)
    assert bool(full.valid[empty].float().mean() > 0.5)
    assert bool((got.t[empty] == np.float32(fi.BIG)).all())
    assert bool((got.tri[empty] == -1).all())
    assert not bool(got.bary_b[empty].any() or got.bary_c[empty].any())
    keep = ~empty
    for a, b in zip(got, full):
        assert torch.equal(a[keep], b[keep])


def _queued_state(arrays, meta, s, cam, steps):
    su = tpath._setup(arrays, meta, s)
    px, py = _pixels()
    inp = tpath._queued_inputs(px, py, cam.xres, 0, 1, 42)
    q = tpath._queued_init(inp)
    for _ in range(steps):
        q = tpath._queued_step(arrays, meta, s, su, cam, inp, q, 1)
    return inp, q


def test_queued_step_is_unchanged(box, monkeypatch):
    arrays, meta, s, cam = box
    inp, q = _queued_state(arrays, meta, s, cam, steps=3)
    assert 0 < int(q.alive.sum()) < RES * RES
    su = tpath._setup(arrays, meta, s)
    want = tpath._queued_step(arrays, meta, s, su, cam, inp, q, 1)
    unmasked = Unmasked(monkeypatch)
    su = tpath._setup(arrays, meta, s)
    got = tpath._queued_step(arrays, meta, s, su, cam, inp, q, 1)
    assert unmasked.dead_hits > 0
    _assert_same(got, want)


def test_lane_bounce_is_unchanged(box, monkeypatch):
    arrays, meta, s, cam = box
    px, py = _pixels()
    ctx = smp.SampleCtx(seed=42, pixel=py.long() * RES + px.long(),
                        sample=torch.zeros(RES * RES, dtype=torch.int64),
                        mode=1, n_set=1)
    su = tpath._setup(arrays, meta, s)
    f, q = tpath._lane_init(arrays, meta, s, su, cam, ctx, px, py)
    for bounce in range(3):
        q = tpath._lane_bounce(arrays, meta, s, su, f, q, bounce)
    assert 0 < int(q.alive.sum()) < RES * RES
    want = tpath._lane_bounce(arrays, meta, s, su, f, q, 3)
    unmasked = Unmasked(monkeypatch)
    su = tpath._setup(arrays, meta, s)
    got = tpath._lane_bounce(arrays, meta, s, su, f, q, 3)
    assert unmasked.dead_hits > 0
    _assert_same(got, want)


def test_gradient_step_is_unchanged(box, monkeypatch):
    arrays, meta, s, cam = box
    px, py = _pixels()
    loss_fn = make_loss_fn(arrays, meta, s, cam, px, py,
                           torch.zeros(RES * RES, dtype=torch.int64), 3,
                           torch.full((RES * RES, 3), 0.1))

    def step():
        params = extract_params(arrays)
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), grads

    want = step()
    unmasked = Unmasked(monkeypatch)
    got = step()
    assert unmasked.dead_hits > 0
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert bool(torch.isfinite(got[0]))
    moved = 0
    for a, b in zip(got[1], want[1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(_bits(a), _bits(b))
            assert bool(torch.isfinite(a).all())
            moved += int(a.count_nonzero())
    assert moved > 0
