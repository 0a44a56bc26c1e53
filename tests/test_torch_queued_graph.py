"""The queued loop split into the reference's init / cond / body
(`integrator/path.py` `_QueuedState`, `_QueuedInputs`, `_queued_step`,
`_queued_live`) and the block runner's buffer discipline
(`integrator/graph.py` `QueuedGraph`), on the CPU.

Contracts:
* the split loop against rgk_tpu's queued tracers
  (`trace_wavefront_queued`, `trace_wavefront_queued_bdpt`): per-lane
  radiance within rtol 1e-4 / atol 1e-5 on >= 99% of lanes and equal ray
  counts (the tolerance of tests/test_torch_slice.py; the port has never
  been bit-equal to the reference on the CPU, whose XLA kernels round
  some operations otherwise), the BDPT splat image as
  tests/test_torch_bdpt.py holds it;
* reading the end test every k steps, plus steps past the end, gives
  the k = 1 state bit for bit (a step past the end changes no output);
* one runner's static buffers reused for blocks that differ in pixels,
  first sample and seed give what the plain loop gives, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.integrator import path as jpath
from rgk_tpu_torch.driver.render import RenderDriver
from rgk_tpu_torch.integrator import graph
from rgk_tpu_torch.integrator import path as tpath

RES, MS = 16, 4


def _pane(cfg):
    """A tinted thin-glass pane between the emitter and the floor."""
    cfg["materials"].append({"name": "pane_thinglass", "brdf": "diffuse",
                             "diffuse": [0.35, 0.55, 0.9]})
    cfg["scene"].append({"primitive": "plane", "axis": "Y",
                         "scale": [1.2, 1, 1.2], "rotate": [0, 0, 180],
                         "translate": [0, 2.0, 0],
                         "material": "pane_thinglass"})
    cfg["thinglass"] = ["thinglass"]
    cfg["tint-thinglass"] = True
    return cfg


def _config(tmp_path, case):
    reverse = 2 if case == "bdpt" else 0
    cfg = scenes.box_config(res=RES, ms=MS, reverse=reverse)
    if case == "sphere":
        cfg = scenes.add_sphere(tmp_path, cfg, n_tris=5000)
    if case == "glass":
        cfg = _pane(cfg)
    return scenes.write_config(tmp_path, cfg, f"{case}.json")


def _pixels(n=RES * RES, first=0):
    pix = np.arange(first, first + n)
    return (pix % RES).astype(np.int32), (pix // RES).astype(np.int32)


def _split_walk(arrays, meta, s, cam, px, py, sample0, seed, k=1,
                extra=0):
    """The queued eye walk from the split pieces (BDPT with its light
    phase): `k` steps between two reads of the end test, as the graph
    runner replays them, then `extra` steps past the end.  -> (state,
    splat image or None)."""
    su = tpath._setup(arrays, meta, s)
    inp = tpath._queued_inputs(px, py, cam.xres, sample0, MS, seed)
    q = tpath._queued_init(inp)
    splat = None
    if int(s.reverse) > 0:
        lpack, splat, rays = tpath._light_phase(arrays, meta, s, su, cam, inp,
                                                MS, 1)
        inp = inp._replace(lpack=lpack)
        q = q._replace(rays=rays)
    while bool(tpath._queued_live(q, inp)):
        for _ in range(k):
            q = tpath._queued_step(arrays, meta, s, su, cam, inp, q, 1)
    for _ in range(extra):
        q = tpath._queued_step(arrays, meta, s, su, cam, inp, q, 1)
    return q, splat


def _assert_lanes_close(port, ref):
    close = np.isclose(port, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert ref.mean() > 0.0


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", ["flat", "sphere", "glass", "bdpt"])
def test_split_loop_matches_reference(tmp_path, case):
    """NEE on the flat box, on the box plus a 5000-triangle sphere (a
    BVH scene), with tint-thinglass, and BDPT at reverse 2: the split
    loop against rgk_tpu's queued tracer at 16x16, 4 spp."""
    path = _config(tmp_path, case)
    _, jarrays, jmeta, jcfg = scenes.jax_build(path)
    arrays, meta, cfg = scenes.port_build(path)
    assert meta.has_bvh == (case == "sphere")
    assert meta.has_thinglass == (case == "glass")
    px, py = _pixels()
    tracer = (jpath.trace_wavefront_queued_bdpt if case == "bdpt"
              else jpath.trace_wavefront_queued)
    ref = tracer(jarrays, jmeta, jcfg.settings, jcfg.get_camera(),
                 jnp.asarray(px), jnp.asarray(py), 0, MS, 42,
                 sampler_mode=1)
    q, splat = _split_walk(arrays, meta, cfg.settings, cfg.get_camera(),
                           torch.from_numpy(px), torch.from_numpy(py), 0,
                           42)
    _assert_lanes_close(q.radiance.numpy(), np.asarray(ref[0]))
    assert int(q.rays) == int(ref[-1])
    if case == "bdpt":
        _assert_lanes_close(splat[:-1].numpy(), np.asarray(ref[1])[:-1])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", ["flat", "bdpt"])
def test_end_test_every_k_steps(tmp_path, case):
    """k in {1, 3, 8}, plus 5 steps past the end: the state's outputs
    equal k = 1's bit for bit."""
    arrays, meta, cfg = scenes.port_build(_config(tmp_path, case))
    cam = cfg.get_camera()
    px, py = (torch.from_numpy(a) for a in _pixels(96, first=40))
    one, splat = _split_walk(arrays, meta, cfg.settings, cam, px, py, 4, 7)
    for k in (1, 3, 8):
        q, sk = _split_walk(arrays, meta, cfg.settings, cam, px, py, 4, 7,
                            k=k, extra=5)
        for f in ("radiance", "rays", "ro", "rd", "contribution", "s",
                  "alive", "sample_rad"):
            assert torch.equal(getattr(q, f), getattr(one, f)), (k, f)
        if case == "bdpt":
            assert torch.equal(sk, splat)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", ["flat", "sphere", "bdpt"])
def test_runner_buffers_reused_across_blocks(tmp_path, case):
    """One QueuedGraph on the CPU traces two blocks that differ in
    pixels, first sample and seed into the same static buffers; each
    block's outputs equal the plain loop's (`*_eager`) bit for bit, and
    a fresh runner's."""
    arrays, meta, cfg = scenes.port_build(_config(tmp_path, case))
    s, cam = cfg.settings, cfg.get_camera()
    eager = (tpath.trace_wavefront_queued_bdpt_eager if case == "bdpt"
             else tpath.trace_wavefront_queued_eager)
    blocks = [(*(torch.from_numpy(a) for a in _pixels(64, first)), s0, seed)
              for first, s0, seed in ((0, 0, 42), (150, 12, 7))]
    runner = graph.QueuedGraph(arrays, meta, s, cam, 64, MS)
    for px, py, s0, seed in blocks:
        got = [t.clone() for t in runner.trace(px, py, s0, seed, cam)]
        fresh = graph.QueuedGraph(arrays, meta, s, cam, 64, MS).trace(
            px, py, s0, seed, cam)
        want = eager(arrays, meta, s, cam, px, py, s0, MS, seed)
        assert len(got) == len(want) == (3 if case == "bdpt" else 2)
        for a, b, c in zip(got, fresh, want):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.timeout(300)
def test_driver_round_equals_plain_loop(tmp_path):
    """A driver round on the CPU (its runner, three blocks, the last one
    padded) accumulates what the plain loop gives block by block; the
    runner's counters add up (one step per iteration, none past the
    end)."""
    arrays, meta, cfg = scenes.port_build(_config(tmp_path, "flat"))
    s, cam = cfg.settings, cfg.get_camera()
    graph.reset_stats()
    drv = RenderDriver(s, arrays, meta, cam, chunk_lanes=100)
    drv.render_round(1)
    st = graph.read_stats()
    acc = torch.zeros_like(drv._acc_dev)
    rays = 0
    for px, py, pix in zip(drv._px, drv._py, drv._pix_idx):
        rad, n = tpath.trace_wavefront_queued_eager(arrays, meta, s, cam, px,
                                                    py, MS, MS, 42)
        acc.index_add_(0, pix, rad)
        rays += int(n)
    assert torch.equal(drv._acc_dev, acc) and int(drv._rays_dev) == rays
    assert st["blocks"] == 3 and st["runners"] == 1
    assert st["steps"] == st["iterations"] > 0 and st["overshoot"] == 0
    assert st["replays"] == st["captures"] == 0
