"""The `grad_scaled` window: the `grad` driver's loop, trace, comparison
and readings (`drivers/grad.py`), with a target that scales any leaves.

The target is the scene rendered with each leaf named in the workload's
`target_scale` multiplied by its factor (`grad` scales the diffuse
albedo alone), every pixel x multisample lanes, `--seed` as the
sampler's seed; the reference builds its own target the same way from
its own scene.  Everything else is `grad`'s: the first `first_steps`
steps of step-then-SGD in set-up, the closed loop of steps in the
window with one loss read a step, the eager step and profiler window of
the traced run (which adds the atlas's texel count to its record), and
the five numbers of the comparison (`grad.gaps`).

The comparison adds a sixth number, `texel_grad_gap`: the first step's
`texels` gradient as the step returned it, against the reference's
first gradient, element by element: |g - g_ref| / |g_ref| over the whole
table.  `grad_gap` weighs each leaf against the median leaf's norm, and
the texel table's gradient (~1e-3 in norm on the colonnade, spread over
786,432 texels) is a few hundredths of the median: a port that left
the texels out would read under `grad_gap`'s limit, which the other
leaves' lanes at triangle edges set (PERF.md §2).  The gradient is read
as returned, not as SGD applied it: at the cell's rate most texels move
by less than one float32 spacing.
"""

from __future__ import annotations

import numpy as np
import torch

from rgkbench.drivers import grad
from rgkbench.drivers.grad import window  # noqa: F401 (the driver's)


def loop_inputs(scene, meta, settings, cam, wl, seed, render_lanes,
                extract_params, apply_params):
    """(lanes, target) of the loss: the target rendered with the leaves
    of `wl["target_scale"]` scaled, by the given renderer's functions."""
    dev = scene.tri_pack.device
    px, py, si = grad.lanes(cam, int(settings.multisample), dev)
    scaled = extract_params(scene)
    with torch.no_grad():
        for key, factor in wl["target_scale"].items():
            scaled[key] = scaled[key] * float(factor)
        target = render_lanes(apply_params(scene, scaled), meta, settings,
                              cam, px, py, si, seed,
                              differentiable=True).radiance
    return (px, py, si), target


def setup(cell):
    from rgk_tpu_torch.diff import graph as dgraph
    from rgk_tpu_torch.diff import params as dparams
    from rgk_tpu_torch.integrator import graph, path
    from rgk_tpu_torch.scene.config import build_scene, load_config

    wl = cell.wl
    cfg = load_config(cell.scene_path)
    scene, meta, builder = build_scene(cfg, cell.device)
    cam = cfg.get_camera().to(cell.device)
    cfg.post_check()
    (px, py, si), target = loop_inputs(
        scene, meta, cfg.settings, cam, wl, cell.seed, path.render_lanes,
        dparams.extract_params, dparams.apply_params)
    step = dgraph.make_value_and_grad(scene, meta, cfg.settings, cam, px, py,
                                      si, cell.seed, target)
    params = dparams.extract_params(scene)
    lr = float(wl["lr"])
    snaps, losses = [grad._host(params)], []
    for i in range(int(wl["first_steps"])):
        loss, grads = step(params)
        losses.append(float(loss))
        if i == 0:   # None where no gradient reaches the texels
            g = grads["texels"]
            texels_grad = (np.zeros(params["texels"].shape) if g is None
                           else g.detach().cpu().double().numpy())
        grad.sgd(params, grads, lr)
        snaps.append(grad._host(params))
    st = dict(cell=cell, step=step, params=params, lr=lr, losses=losses,
              snaps=snaps, texels_grad=texels_grad,
              build_s=sum(builder.timings.values()),
              loss_fn=dparams.make_loss_fn(scene, meta, cfg.settings, cam,
                                           px, py, si, cell.seed, target),
              capture_ms=None)
    if cell.device.type == "cuda":
        st["capture_ms"] = graph.read_stats()["capture_ms"]
    return st


def trace(st) -> dict:
    """`grad.trace`, and the texels of the atlas, which the texel
    backward's roofline counts (`metrics/grad.tex_bwd_roofline.py`)."""
    rec = grad.trace(st)
    rec["texels"] = int(st["params"]["texels"].shape[0])
    return rec


def reference_steps(cell, n_steps: int, lr: float, dtype=torch.float32,
                    keep=None, start=None):
    """`grad.reference_steps` with this driver's target."""
    from rgkbench.reference import lowp
    from rgkbench.reference import render as ref
    from rgkbench.reference.diff import params as rparams
    from rgkbench.reference.integrator import path as rpath

    def low():
        return lowp.precision(dtype)

    with low():
        settings, scene, meta, cam = ref.load(cell.scene_path, cell.device)
        (px, py, si), target = loop_inputs(
            scene, meta, settings, cam, cell.wl, cell.seed,
            rpath.render_lanes, rparams.extract_params, rparams.apply_params)
    if keep is not None:
        px, py, si, target = px[keep], py[keep], si[keep], target[keep]
    loss_fn = rparams.make_loss_fn(scene, meta, settings, cam, px, py,
                                   si, cell.seed, target)
    params = rparams.extract_params(scene)
    seen = []   # each step's texels gradient, as the walk computes it
    params["texels"].register_hook(seen.append)
    out = grad._reference_walk(loss_fn, params, n_steps, lr, low)
    out["texels_grad"] = seen[0].detach().cpu().double().numpy()
    if start is not None:
        out["window"] = grad._reference_walk(
            loss_fn, rparams.params_from_numpy(start, cell.device), 1, lr,
            low)
    return out


def port_answers(st) -> dict:
    """`grad.port_answers`, and the first step's texels gradient."""
    got = grad.port_answers(st)
    got["texels_grad"] = st["texels_grad"]
    return got


def gaps(got: dict, ref: dict) -> dict:
    """`grad.gaps`, and `texel_grad_gap` (module doc)."""
    out = grad.gaps(got, ref)
    want = ref["texels_grad"]
    out["texel_grad_gap"] = float(
        np.linalg.norm(got["texels_grad"] - want)
        / max(float(np.linalg.norm(want)), 1e-30))
    return out


def judge(st) -> dict:
    cell = st["cell"]
    got = port_answers(st)
    ref = reference_steps(cell, len(got["losses"]), got["lr"],
                          start=got["window"]["snaps"][0])
    lim = cell.wl["check"]["limits"]
    return {k: {"value": v, "limit": lim[k]} for k, v in gaps(got, ref).items()}


def readings(st, control: bool = True) -> dict:
    """`grad.readings` with this driver's target: the sound numbers, and
    with `control` those of the bfloat16 control, of half the lanes left
    out and of the port's losses altered by 1%."""
    cell = st["cell"]
    got = port_answers(st)
    n, lr, start = len(got["losses"]), got["lr"], got["window"]["snaps"][0]
    ref = reference_steps(cell, n, lr, start=start)
    if not control:
        return {"sound": gaps(got, ref)}
    low = reference_steps(cell, n, lr, torch.bfloat16, start=start)
    r = int(cell.wl["scene"]["output-width"]) * int(
        cell.wl["scene"]["output-height"]) * int(cell.wl["scene"]["multisample"])
    half = reference_steps(cell, n, lr, keep=slice(0, r // 2), start=start)
    altered = dict(got, losses=[x * 1.01 for x in got["losses"]],
                   window=dict(got["window"], losses=[
                       x * 1.01 for x in got["window"]["losses"]]))
    return {"sound": gaps(got, ref), "control": gaps(low, ref),
            "half_batch": gaps(half, ref), "altered": gaps(altered, ref)}
