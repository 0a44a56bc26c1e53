"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a small size, once for each fault a cell can have (one card:
there is no exchange between chips to leave out)."""

import pytest
import torch

from conftest import small
from rgkbench import harness

CPU = torch.device("cpu")
SEED = 987654321


def _run(name, scenes, wl):
    return harness.run_cell(name, SEED, 0.05, False, CPU, wl=wl,
                            scenes=scenes)


def test_sound_runs_are_correct(scenes):
    assert _run("box_sphere.nee", scenes, small("box_sphere.nee"))["correct"]
    assert _run("box_sphere.grad", scenes,
                small("box_sphere.grad", multisample=2))["correct"]


def _unchanged_round(orig):
    def round_(self, round_idx, monitor=None):
        acc = self._acc_dev.clone()
        orig(self, round_idx, monitor)
        self._acc_dev.copy_(acc)
    return round_


def _half_round(orig):
    def round_(self, round_idx, monitor=None):
        acc = self._acc_dev.clone()
        orig(self, round_idx, monitor)
        half = (acc.shape[0] - 1) // 2
        self._acc_dev[half:] = acc[half:]
    return round_


def _altered_step(orig):
    def step(*args, **kw):
        q = args[-2] if len(args) >= 8 else kw["q"]
        new = orig(*args, **kw)
        return new._replace(
            radiance=q.radiance + (new.radiance - q.radiance) * 1.01)
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_render_fault_is_not_correct(fault, scenes, monkeypatch):
    from rgk_tpu_torch.driver.render import RenderDriver
    from rgk_tpu_torch.integrator import path

    if fault == "altered":
        monkeypatch.setattr(path, "_queued_step",
                            _altered_step(path._queued_step))
    else:
        wrap = _unchanged_round if fault == "unchanged" else _half_round
        monkeypatch.setattr(RenderDriver, "render_round",
                            wrap(RenderDriver.render_round))
    out = _run("box_sphere.nee", scenes, small("box_sphere.nee"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_grad_fault_is_not_correct(fault, scenes, monkeypatch):
    from rgk_tpu_torch.diff import graph as dgraph

    call = dgraph.ValueAndGrad.__call__
    if fault == "unchanged":
        def broken(self, params):
            loss, grads = call(self, params)
            return loss, {k: None if g is None else torch.zeros_like(g)
                          for k, g in grads.items()}
        monkeypatch.setattr(dgraph.ValueAndGrad, "__call__", broken)
    elif fault == "altered":
        def broken(self, params):
            loss, grads = call(self, params)
            return loss * 1.01, grads
        monkeypatch.setattr(dgraph.ValueAndGrad, "__call__", broken)
    else:
        orig = dgraph.make_loss_fn

        def half(scene, meta, settings, cam, px, py, si, seed, target,
                 *args):
            n = px.shape[0] // 2
            return orig(scene, meta, settings, cam, px[:n], py[:n], si[:n],
                        seed, target[:n], *args)
        monkeypatch.setattr(dgraph, "make_loss_fn", half)
    out = _run("box_sphere.grad", scenes, small("box_sphere.grad",
                                                multisample=2))
    assert not out["correct"], out["checks"]
