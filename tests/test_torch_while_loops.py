"""The reference's device `while_loop`s in the port, on the CPU: the
per-sample path split into `path._lane_init` / `_lane_live` /
`_lane_bounce` / `_lane_finish` (what `graph.LaneGraph` runs on the card
as one CUDA graph with a conditional WHILE node), and the WHILE graph's
wrapper (`ops/graph_while.py`).  The card's side is in
tests/test_torch_cuda.py and `chip_smoke.py` phases 20-21.

Contracts:
* the split per-sample path against rgk_tpu's `render_lanes`, with
  `differentiable` False (the reference's `while_loop`) and True (its
  `lax.scan`): per-lane radiance within rtol 1e-4 / atol 1e-5 on >= 99%
  of lanes, rays within 0.5% (tests/test_torch_device_loops.py's
  tolerance), on the box with roulette (russian 0.6, recursion-max 12),
  the same box bidirectional, and an open scene under a sky (escapes);
* the split loop runs bounces while `_lane_live` holds and stops at the
  first bounce where it does not: every bounce it runs starts from a
  live state, the state after the last is not live, and the radiance,
  rays and splats equal the all-bounce route's bit for bit (a dead lane
  adds nothing); `LaneGraph` on the CPU runs as many bounces;
* the WHILE graph's entry points take CUDA tensors only, nothing builds
  one without a card, and the plain loop runs prologue, bodies while the
  flag holds, then epilogue.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.integrator import path as jpath
from rgk_tpu_torch.integrator import graph
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.ops import graph_while as gw

RES, MS = 16, 2


def _config(tmp_path, case):
    if case == "sky":
        cfg = dict(scenes.GRAD_SCENE, **{
            "output-width": RES, "output-height": RES, "multisample": MS,
            "recursion-max": 6, "russian": 0.6})
    else:
        cfg = scenes.box_config(res=RES, ms=MS, russian=0.6,
                                **{"recursion-max": 12})
        cfg["reverse"] = 2 if case == "bdpt" else 0
    return scenes.write_config(tmp_path, cfg, f"{case}.json")


def _lanes():
    """Every pixel x MS samples, sample-outer."""
    pix = np.arange(RES * RES)
    px = np.tile(pix % RES, MS).astype(np.int32)
    py = np.tile(pix // RES, MS).astype(np.int32)
    return px, py, np.repeat(np.arange(MS), RES * RES).astype(np.int64)


def _port_lanes(arrays, meta, s, cam, differentiable, seed=5):
    px, py, si = (torch.from_numpy(a) for a in _lanes())
    with torch.no_grad():
        return tpath.render_lanes(arrays, meta, s, cam, px, py, si, seed,
                                  differentiable=differentiable)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["while", "scan"])
@pytest.mark.parametrize("case", ["box_rr", "bdpt", "sky"])
def test_split_path_matches_reference(tmp_path, case, differentiable):
    path = _config(tmp_path, case)
    arrays, meta, cfg = scenes.port_build(path)
    s, cam = cfg.settings, cfg.get_camera()
    got = _port_lanes(arrays, meta, s, cam, differentiable)
    _, jarrays, jmeta, jcfg = scenes.jax_build(path)
    px, py, si = _lanes()
    ref = jpath.render_lanes(jarrays, jmeta, jcfg.settings, jcfg.get_camera(),
                             jnp.asarray(px), jnp.asarray(py),
                             jnp.asarray(si.astype(np.uint32)), jnp.uint32(5),
                             differentiable=differentiable)
    port, want = got.radiance.numpy(), np.asarray(ref.radiance)
    close = np.isclose(port, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(int(got.rays) - int(ref.rays)) <= 0.005 * int(ref.rays)
    assert want.mean() > 0.0
    if case == "bdpt":
        assert got.splat_pix.shape == (RES * RES * MS, 2)
        pix_same = (got.splat_pix.numpy() == np.asarray(ref.splat_pix)).mean()
        assert pix_same >= 0.99, pix_same


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", ["box_rr", "bdpt", "sky"])
def test_split_loop_stops_at_first_dead_bounce(tmp_path, case, monkeypatch):
    arrays, meta, cfg = scenes.port_build(_config(tmp_path, case))
    s, cam = cfg.settings, cfg.get_camera()
    depth = int(s.recursion_max)
    seen = []
    bounce_fn = tpath._lane_bounce

    def counted(scene, meta_, settings, su, f, q, bounce):
        seen.append((int(q.bounce), bool(q.alive.any()), int(bounce)))
        nxt = bounce_fn(scene, meta_, settings, su, f, q, bounce)
        seen.append((int(nxt.bounce), bool(nxt.alive.any()), None))
        return nxt

    monkeypatch.setattr(tpath, "_lane_bounce", counted)
    early = _port_lanes(arrays, meta, s, cam, False)
    runs = seen[0::2]
    n = len(runs)
    # Every bounce run started live, at its own index, and the state
    # after the last is the first one that is not.
    assert [r[0] for r in runs] == [r[2] for r in runs] == list(range(n))
    assert all(alive for _, alive, _ in runs)
    last_bounce, last_alive, _ = seen[-1]
    assert last_bounce == n and not (last_bounce < depth and last_alive)
    if case != "sky":  # roulette ends every path before the last bounce
        assert 1 < n < depth and not last_alive
    seen.clear()
    full = _port_lanes(arrays, meta, s, cam, True)
    assert len(seen) == 2 * depth
    for a, b in zip(early, full):
        assert torch.equal(a, b)
    monkeypatch.setattr(tpath, "_lane_bounce", bounce_fn)
    graph.reset_stats()
    px, py, si = (torch.from_numpy(a) for a in _lanes())
    runner = graph.LaneGraph(arrays, meta, s, cam, px.shape[0])
    got = runner.trace(px, py, si, 5, cam)
    assert graph.read_stats()["lane_bounces"] == n
    for a, b in zip(got, early):
        assert torch.equal(a, b)


def test_while_graph_takes_cuda_tensors_only():
    flag = torch.ones((), dtype=torch.bool)
    runs = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="runs on the card"):
        gw.WhileGraph(None, flag, runs)
    meta_flag = torch.ones((), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CPU flag"):
        gw.run_plain(lambda: None, meta_flag)


def test_no_while_graph_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA device"):
        gw.driver_version()
    with pytest.raises(RuntimeError, match="CUDA device"):
        gw.node_count(None)


def test_run_plain_order_and_count():
    """The plain loop runs the prologue, the body while the flag holds
    (read before every body), then the epilogue, and returns the bodies
    run."""
    flag = torch.ones((), dtype=torch.bool)
    x = torch.zeros((), dtype=torch.int64)
    order = []

    def body():
        x.add_(1)
        flag.copy_(x < 5)
        order.append("body")

    n = gw.run_plain(body, flag, prologue=lambda: order.append("pro"),
                     epilogue=lambda: order.append("epi"))
    assert n == 5 and int(x) == 5
    assert order == ["pro"] + ["body"] * 5 + ["epi"]
    flag.fill_(False)
    assert gw.run_plain(body, flag) == 0 and int(x) == 5
