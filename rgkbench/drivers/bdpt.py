"""The `bdpt` window: progressive bidirectional rounds through the CLI's
driver, judged on one round rendered after the window.

Set-up and the window are `drivers/render.py`'s: `setup` loads and
builds the cell's scene as `driver/cli.py` does, builds `RenderDriver`
(halton sampler, `--seed` as the root seed, the cell's `chunk_lanes`,
so blocks of `chunk_lanes // multisample` pixels) and renders
`warmup_rounds` rounds, which build the kernels and capture the block's
graph (the light phase as the WHILE graph's prologue, the eye step with
its connections as its body); without `render.setup`'s refusal of
`reverse` > 0.  The window is `render.window`: `render_round(r)` and
`fetch_accumulation()` round by round until `--seconds` have passed.
The ray counter counts the light subpaths' extension rays and the eye
paths', as RGKrt counts them.

The comparison.  A round's splats land anywhere on the screen, so no
set of pixels can be checked without the light subpaths of every pixel
of the round, and the window's hundreds of rounds are too many to trace
again.  So the judge renders one more round after the window, round
`r` = the next, through the same driver and runner: it zeroes the
driver's device accumulator in place (the accumulation graph keeps its
address), calls `render_round(r)` and `fetch_accumulation()`, and reads
that round's own image.  The plain reference (`reference/bdpt.py`)
then traces the light subpaths of every (pixel, sample) of round `r`
for the splat image, and the eye paths with their connections at
`check.pixels` pixels drawn from the seed, one in each tile of a square
grid (`render.check_pixels`).  `image_gap` is sum |port - reference| /
sum |reference| over those pixels' channels, compared with
`check.limits.image_gap`.  The control is the reference with every
float32 result rounded to bfloat16 (`reference/lowp.py`).

The traced run adds to `render.window`'s CUDA events around each round
the graph counters (`graph.read_stats()`) read before and after the
window: their difference is `graph_window`, which the `bdpt.*` metrics
read; and one block of the same pixels through the eager queued BDPT
loop (`trace_wavefront_queued_bdpt_eager`) in a profiler window for the
device's busy time and the breakdown.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from rgkbench import profiling
from rgkbench.drivers import render


def setup(cell):
    from rgk_tpu_torch.driver.render import RenderDriver
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.scene.config import build_scene, load_config

    wl = cell.wl
    cfg = load_config(cell.scene_path)
    scene, meta, builder = build_scene(cfg, cell.device)
    cam = cfg.get_camera()
    cfg.post_check()
    drv = RenderDriver(cfg.settings, scene, meta, cam, seed=cell.seed,
                       sampler_mode=render.MODE_HALTON,
                       chunk_lanes=int(wl["chunk_lanes"]))
    drv.render_round(0)
    drv.fetch_accumulation()
    r, t0 = 1, time.perf_counter()
    while (r < int(wl["warmup_rounds"]) or time.perf_counter() - t0
           < float(wl.get("warmup_seconds", 0))):
        drv.render_round(r)
        drv.fetch_accumulation()
        r += 1
    st = dict(cell=cell, drv=drv, scene=scene, meta=meta, next_round=r,
              build_s=sum(builder.timings.values()), capture_ms=None,
              triangles=int(scene.tri_pack.shape[0]))
    if cell.device.type == "cuda":
        st["capture_ms"] = graph.read_stats()["capture_ms"]
    return st


def window(st, seconds: float, trace: bool) -> dict:
    from rgk_tpu_torch.integrator import graph

    counted = trace and st["cell"].device.type == "cuda"
    before = graph.read_stats() if counted else None
    out = render.window(st, seconds, trace)
    if counted:
        after = graph.read_stats()
        out["rec"]["graph_window"] = {k: after[k] - before[k] for k in after}
    return out


def _eager_block(st):
    """A function that traces block 0 of the next round through the
    eager queued BDPT loop."""
    from rgk_tpu_torch.integrator import path

    drv = st["drv"]
    px, py = render._first_block(st)
    sample0 = st["next_round"] * drv.ms

    def run():
        return path.trace_wavefront_queued_bdpt_eager(
            drv.scene, drv.meta, drv.settings, drv.camera, px, py, sample0,
            drv.ms, drv.seed, drv.sampler_mode)

    return run


def trace(st) -> dict:
    prof = profiling.profile(_eager_block(st))
    return dict(build_s=st["build_s"], capture_ms=st["capture_ms"],
                triangles=st["triangles"], kernels=prof["kernels"],
                busy_s=prof["busy_s"], traced_window_s=prof["window_s"],
                breakdown=prof["breakdown"])


def judged_round(st) -> dict:
    """One round rendered after the window through the same driver, read
    alone (module doc), then the program's state freed.  -> the round's
    image f32 [H*W, 3] on the host, its first sample and samples a
    pixel."""
    drv = st.pop("drv")
    r = st["next_round"]
    drv._acc_dev.zero_()
    drv.render_round(r)
    drv.fetch_accumulation()
    cam = drv.camera
    got = dict(image=drv.acc.sum.reshape(cam.xres * cam.yres, 3),
               xres=cam.xres, yres=cam.yres, sample0=r * drv.ms,
               samples=drv.ms)
    st.pop("scene")
    st.pop("meta")
    del drv
    gc.collect()
    if st["cell"].device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def compare(cell, got, dtype=torch.float32) -> dict:
    """image_gap of the judged round `got` against the plain reference
    run in `dtype` (module doc)."""
    from rgkbench.reference import bdpt as ref
    from rgkbench.reference import lowp

    pixels = render.check_pixels(got["xres"], got["yres"],
                                 int(cell.wl["check"]["pixels"]), cell.seed)
    with lowp.precision(dtype):
        loaded = ref.load(cell.scene_path, cell.device)
        want = ref.round_pixels(loaded, pixels, got["sample0"],
                                got["samples"], cell.seed, render.MODE_HALTON)
    port = got["image"][pixels]
    return {"image_gap": float(np.abs(port - want).sum()
                               / max(np.abs(want).sum(), 1e-30))}


def judge(st) -> dict:
    cell = st["cell"]
    gaps = compare(cell, judged_round(st))
    lim = cell.wl["check"]["limits"]
    return {k: {"value": v, "limit": lim[k]} for k, v in gaps.items()}


def readings(st, control: bool = True) -> dict:
    """The numbers against the reference and, with `control`, against
    its control."""
    cell = st["cell"]
    got = judged_round(st)
    out = {"sound": compare(cell, got)}
    if control:
        out["control"] = compare(cell, got, torch.bfloat16)
    return out
