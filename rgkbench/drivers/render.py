"""The `render` window: progressive rounds through the CLI's driver.

Set-up loads and builds the cell's scene as `driver/cli.py` does,
builds `RenderDriver` (halton sampler, `--seed` as the root seed, the
cell's `chunk_lanes`) and renders `warmup_rounds` rounds, which
build the kernels and capture the block's graph, and then rounds until
`warmup_seconds` have passed since the first ended: on the colonnade
the same block runs ~9% slower for the first seconds of most processes
(up to ~17 s), while the card's copy and matrix-product speeds stay
the same (PERF.md).  The window then calls `render_round(r)` and
`fetch_accumulation()` round by round, the CLI's `_render_frame_loop`
without its EXR write, until `--seconds` have passed; a round's wall
time ends in the fetch's copy to the host.  Unidirectional scenes
without thin glass only: the reference refuses the others.

The comparison takes the accumulation of every round rendered, warm-up
rounds included, at `check.pixels` pixels drawn from the seed, one in
each of as many tiles of a square grid over the screen (`check_pixels`),
and the plain reference's sums of the same samples of those pixels:
`image_gap` is sum |port - reference| / sum |reference| over the
pixels' channels.  The control is the reference with every float32
result rounded to bfloat16 (`reference/lowp.py`).

The traced run adds CUDA events around each round (its block launch to
its fetch), the graph counters before and after the window, and one
block of the same pixels through the eager queued loop
(`trace_wavefront_queued_eager`, the route on which the profiler sees
every kernel): once with its ray queries counted, once
in a profiler window that opens with a warm-up step.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from rgkbench import profiling

MODE_HALTON = 1


def setup(cell):
    from rgk_tpu_torch.driver.render import RenderDriver
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.scene.config import build_scene, load_config

    wl = cell.wl
    cfg = load_config(cell.scene_path)
    if int(cfg.settings.reverse) > 0:
        raise ValueError(f"{cell.name}: the render driver compares "
                         f"unidirectional renders only")
    scene, meta, builder = build_scene(cfg, cell.device)
    cam = cfg.get_camera()
    cfg.post_check()
    drv = RenderDriver(cfg.settings, scene, meta, cam, seed=cell.seed,
                       sampler_mode=MODE_HALTON,
                       chunk_lanes=int(wl["chunk_lanes"]))
    drv.render_round(0)
    drv.fetch_accumulation()
    r, t0 = 1, time.perf_counter()
    while (r < int(wl["warmup_rounds"]) or time.perf_counter() - t0
           < float(wl.get("warmup_seconds", 0))):
        drv.render_round(r)
        drv.fetch_accumulation()
        r += 1
    st = dict(cell=cell, drv=drv, scene=scene, meta=meta,
              next_round=r,
              build_s=sum(builder.timings.values()),
              capture_ms=None, triangles=int(scene.tri_pack.shape[0]))
    if cell.device.type == "cuda":
        st["capture_ms"] = graph.read_stats()["capture_ms"]
    return st


def _iterations():
    from rgk_tpu_torch.integrator import graph

    return graph.read_stats()["iterations"]


def window(st, seconds: float, trace: bool) -> dict:
    drv = st["drv"]
    cuda = st["cell"].device.type == "cuda"
    it0 = _iterations() if trace and cuda else None
    rays0 = drv.stats.rays
    times, events = [], []
    r = st["next_round"]
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if trace and cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        drv.render_round(r)
        drv.fetch_accumulation()
        if trace and cuda:
            ev[1].record()
            events.append(ev)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        r += 1
        if t1 - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    st["next_round"] = r
    rays = drv.stats.rays - rays0
    out = {"attempted": len(times), "failed": 0,
           "mrays_per_s": rays / window_s / 1e6,
           "round_p95_ms": float(np.percentile(times, 95)) * 1e3}
    if trace and cuda:
        torch.cuda.synchronize()
        out["rec"] = dict(
            rounds=len(times), window_s=window_s,
            iterations=_iterations() - it0,
            round_event_ms=[a.elapsed_time(b) for a, b in events])
    return out


def _first_block(st):
    drv, cam = st["drv"], st["drv"].camera
    n = min(drv.block, cam.xres * cam.yres)
    pix = torch.arange(n, device=st["cell"].device)
    return ((pix % cam.xres).to(torch.int32),
            (pix // cam.xres).to(torch.int32))


def _eager_block(st):
    """A function that traces block 0 of the next round through the
    eager queued loop."""
    from rgk_tpu_torch.integrator import path

    drv = st["drv"]
    px, py = _first_block(st)
    sample0 = st["next_round"] * drv.ms

    def run():
        return path.trace_wavefront_queued_eager(drv.scene, drv.meta, drv.settings, drv.camera, px, py,
                      sample0, drv.ms, drv.seed, drv.sampler_mode)

    return run


def trace(st) -> dict:
    run = _eager_block(st)
    queries, out = profiling.count_queries(run)
    prof = profiling.profile(run)
    return dict(build_s=st["build_s"], capture_ms=st["capture_ms"],
                triangles=st["triangles"], queries=queries,
                block_rays=int(out[-1]), steps=queries["closest"],
                kernels=prof["kernels"], busy_s=prof["busy_s"],
                traced_window_s=prof["window_s"],
                breakdown=prof["breakdown"])


def port_answers(st) -> dict:
    """What the window produced, read once it has closed: the host
    accumulation and the samples a pixel.  Frees the program's state."""
    drv = st.pop("drv")
    cam = drv.camera
    hw = cam.xres * cam.yres
    samples = drv.stats.rounds * drv.ms
    got = dict(image=drv.acc.sum.reshape(hw, 3), xres=cam.xres,
               yres=cam.yres, samples=samples)
    st.pop("scene")
    st.pop("meta")
    del drv
    gc.collect()
    if st["cell"].device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def check_pixels(xres: int, yres: int, n: int, seed: int) -> np.ndarray:
    """`n` flat pixel indices drawn from `seed`, spread over the screen:
    the screen cut into a g x g grid of tiles (g = ceil(sqrt(n))), `n`
    of the tiles drawn, one pixel drawn inside each."""
    g = int(np.ceil(np.sqrt(n)))
    if g > min(xres, yres):
        raise ValueError(f"{n} check pixels need a screen of {g}x{g}")
    rng = np.random.default_rng(seed)
    tiles = np.sort(rng.choice(g * g, size=n, replace=False))
    tx, ty = tiles % g, tiles // g
    x0, x1 = tx * xres // g, (tx + 1) * xres // g
    y0, y1 = ty * yres // g, (ty + 1) * yres // g
    x = x0 + (rng.random(n) * (x1 - x0)).astype(np.int64)
    y = y0 + (rng.random(n) * (y1 - y0)).astype(np.int64)
    return np.sort(y * xres + x)


def compare(cell, got, dtype=torch.float32) -> dict:
    """image_gap of the port's answers `got` against the plain reference
    run in `dtype` (module doc)."""
    from rgkbench.reference import lowp
    from rgkbench.reference import render as ref

    pixels = check_pixels(got["xres"], got["yres"],
                          int(cell.wl["check"]["pixels"]), cell.seed)
    with lowp.precision(dtype):
        loaded = ref.load(cell.scene_path, cell.device)
        sums, _ = ref.pixel_sums(loaded, pixels, got["samples"], cell.seed,
                                 MODE_HALTON)
    port = got["image"][pixels]
    return {"image_gap": float(np.abs(port - sums).sum()
                               / max(np.abs(sums).sum(), 1e-30))}


def judge(st) -> dict:
    cell = st["cell"]
    gaps = compare(cell, port_answers(st))
    lim = cell.wl["check"]["limits"]
    return {k: {"value": v, "limit": lim[k]} for k, v in gaps.items()}


def readings(st, control: bool = True) -> dict:
    """The numbers against the reference and, with `control`, against
    its control."""
    cell = st["cell"]
    got = port_answers(st)
    out = {"sound": compare(cell, got)}
    if control:
        out["control"] = compare(cell, got, torch.bfloat16)
    return out
