"""The `grad` window: the inverse-rendering user's loop, a gradient step
and a plain SGD update, step after step.

Set-up loads the cell's scene, renders the target with the diffuse
albedo scaled by `target_diffuse_scale` (every pixel x multisample
lanes, `--seed` as the sampler's seed), builds
`diff.graph.make_value_and_grad`'s step over the same lanes (one CUDA
graph on the card) and drives it through the first `first_steps` steps
of the loop: step, then p -= lr * g for every leaf with a gradient.
The window runs the same loop on the same objects until `--seconds`
have passed; the step's lanes and seed are baked into its graph, so
each step differs from the last by its parameters.

The comparison follows the first three steps with the plain reference,
from its own scene build and its own target, and then, once the window
has closed, one more step of the same graph on the parameters the
window left (a timed step, at the parameters it received):
* `loss_gap`: the largest of the three steps' |loss - reference| /
  |reference|;
* `grad_gap`: the first gradient as SGD applied it, (p0 - p1) / lr, by
  the worst leaf: | |g| - |g_ref| | over the larger of |g_ref| of that
  leaf and the median leaf's;
* `change_gap`: the same of p3 - p0 after three steps, over the leaves
  whose reference gradient is at least a thousandth of the median
  leaf's (a leaf with no gradient moves by round-off alone);
* `window_loss_gap`, `window_grad_gap`: the step after the window, its
  loss and its gradient as SGD applied it, against the reference's step
  from the same parameters (the one number the reference takes from the
  program's state: where the window left the parameters).
The control is the reference with every float32 result rounded to
bfloat16 (`reference/lowp.py`).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from rgkbench import profiling

MODE_HALTON = 1


def lanes(cam, ms: int, dev):
    """Every pixel x `ms` samples, sample-outer: (px, py, sample)."""
    pix = torch.arange(cam.xres * cam.yres, device=dev)
    px = (pix % cam.xres).to(torch.int32).repeat(ms)
    py = (pix // cam.xres).to(torch.int32).repeat(ms)
    si = torch.arange(ms, device=dev).repeat_interleave(cam.xres * cam.yres)
    return px, py, si


def loop_inputs(scene, meta, settings, cam, wl, seed, render_lanes,
                extract_params, apply_params):
    """(lanes, target) of the loss: the target rendered with the diffuse
    albedo scaled, by the given renderer's functions."""
    dev = scene.tri_pack.device
    px, py, si = lanes(cam, int(settings.multisample), dev)
    scaled = extract_params(scene)
    with torch.no_grad():
        scaled["mat_diffuse"] = (scaled["mat_diffuse"]
                                 * float(wl["target_diffuse_scale"]))
        target = render_lanes(apply_params(scene, scaled), meta, settings,
                              cam, px, py, si, seed,
                              differentiable=True).radiance
    return (px, py, si), target


def sgd(params, grads, lr: float) -> None:
    with torch.no_grad():
        for k, g in grads.items():
            if g is not None:
                params[k] -= lr * g


def _host(params):
    return {k: v.detach().cpu().double().numpy().copy()
            for k, v in params.items()}


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
    snaps, losses = [_host(params)], []
    for _ in range(int(wl["first_steps"])):
        loss, grads = step(params)
        losses.append(float(loss))
        sgd(params, grads, lr)
        snaps.append(_host(params))
    st = dict(cell=cell, step=step, params=params, lr=lr, losses=losses,
              snaps=snaps, build_s=sum(builder.timings.values()),
              loss_fn=dparams.make_loss_fn(scene, meta, cfg.settings, cam,
                                           px, py, si, cell.seed, target),
              capture_ms=None)
    if cell.device.type == "cuda":
        st["capture_ms"] = graph.read_stats()["capture_ms"]
    return st


def window(st, seconds: float, trace: bool) -> dict:
    step, params, lr = st["step"], st["params"], st["lr"]
    cuda = st["cell"].device.type == "cuda"
    events = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    n = bad = 0
    t_start = time.perf_counter()
    while True:
        if trace and cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        loss, grads = step(params)
        sgd(params, grads, lr)
        if trace and cuda:
            ev[1].record()
            events.append(ev)
        n += 1
        # One sync a step: the host reads the loss, as a user's loop
        # that logs it does.
        bad += not bool(torch.isfinite(loss))
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    out = {"attempted": n, "failed": bad,
           "step_ms": window_s / n * 1e3,
           "step_peak_gib": (torch.cuda.max_memory_reserved() / 2 ** 30
                             if cuda else 0.0)}
    if trace and cuda:
        torch.cuda.synchronize()
        out["rec"] = dict(window_s=window_s, steps_in_window=n,
                          step_event_ms=[a.elapsed_time(b)
                                         for a, b in events])
    return out


def trace(st) -> dict:
    """An eager step on the window's last parameters, after one that
    warms the allocator: CUDA events around its forward and its
    backward, then one profiler window."""
    loss_fn, params = st["loss_fn"], st["params"]
    leaves = list(params.values())
    torch.autograd.grad(loss_fn(params), leaves, allow_unused=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    loss = loss_fn(params)
    ev[1].record()
    torch.autograd.grad(loss, leaves, allow_unused=True)
    ev[2].record()
    torch.cuda.synchronize()

    def eager_step():
        with torch.enable_grad():
            torch.autograd.grad(loss_fn(params), leaves, allow_unused=True)

    prof = profiling.profile(eager_step)
    return dict(build_s=st["build_s"], capture_ms=st["capture_ms"],
                fwd_ms=ev[0].elapsed_time(ev[1]),
                bwd_ms=ev[1].elapsed_time(ev[2]),
                kernels=prof["kernels"], busy_s=prof["busy_s"],
                traced_window_s=prof["window_s"],
                breakdown=prof["breakdown"])


def port_answers(st) -> dict:
    """The first steps' losses and parameter snapshots, and one more
    step of the window's loop on the parameters the window left; frees
    the program's state."""
    params, lr = st["params"], st["lr"]
    start = _host(params)
    loss, grads = st["step"](params)
    sgd(params, grads, lr)
    got = dict(losses=st["losses"], snaps=st["snaps"], lr=lr,
               window=dict(losses=[float(loss)],
                           snaps=[start, _host(params)]))
    for key in ("step", "params", "loss_fn"):
        st.pop(key)
    gc.collect()
    if st["cell"].device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def _reference_walk(loss_fn, params, n_steps: int, lr: float, low):
    """`n_steps` steps of the loop on the reference's `loss_fn` from
    `params`: the loss and its gradient inside `low`, the SGD update
    outside it, as the harness applies it to both sides."""
    snaps, losses, first = [_host(params)], [], None
    for _ in range(n_steps):
        with low():
            loss = loss_fn(params)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = dict(zip(params, grads))
        if first is None:
            first = {k: 0.0 if g is None else float(g.norm())
                     for k, g in grads.items()}
        losses.append(float(loss.detach()))
        sgd(params, grads, lr)
        snaps.append(_host(params))
    return dict(losses=losses, snaps=snaps, lr=lr, first=first)


def reference_steps(cell, n_steps: int, lr: float, dtype=torch.float32,
                    keep=None, start=None):
    """The reference's losses and parameter snapshots over the first
    `n_steps` steps of the same loop, and with `start` (parameters as
    host arrays by leaf) its one step from those under "window".
    `dtype` bfloat16 runs the reference's renderer as the control
    (`reference/lowp.py`).  `keep` (a fault of the tests and the control
    script) takes the loss's mean over that slice of the lanes only."""
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
    out = _reference_walk(loss_fn, rparams.extract_params(scene), n_steps,
                          lr, low)
    if start is not None:
        out["window"] = _reference_walk(
            loss_fn, rparams.params_from_numpy(start, cell.device), 1, lr,
            low)
    return out


def _leaf_gap(got: dict, ref: dict, keys) -> float:
    """Worst leaf's | |a| - |b| | over max(|b|, the median leaf's |b|)."""
    norms = {k: (float(np.linalg.norm(got[k])), float(np.linalg.norm(ref[k])))
             for k in keys}
    med = float(np.median([b for _, b in norms.values()]))
    return max(abs(a - b) / max(b, med, 1e-30) for a, b in norms.values())


def _loss_gap(got: dict, ref: dict) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got["losses"], ref["losses"]))


def _grad_gap(got: dict, ref: dict, lr: float, keys) -> float:
    """The first step's gradient as SGD applied it, (p0 - p1) / lr, by
    the worst leaf."""
    g_port = {k: (got["snaps"][0][k] - got["snaps"][1][k]) / lr for k in keys}
    g_ref = {k: (ref["snaps"][0][k] - ref["snaps"][1][k]) / lr for k in keys}
    return _leaf_gap(g_port, g_ref, keys)


def gaps(got: dict, ref: dict) -> dict:
    """The numbers of the module doc: the port's first steps and its step
    after the window, `got`, against the reference's `ref`."""
    lr = got["lr"]
    keys = list(ref["first"])
    med = float(np.median(list(ref["first"].values())))
    moving = [k for k in keys if ref["first"][k] >= 1e-3 * med]
    last = len(ref["snaps"]) - 1
    d_port = {k: got["snaps"][last][k] - got["snaps"][0][k] for k in moving}
    d_ref = {k: ref["snaps"][last][k] - ref["snaps"][0][k] for k in moving}
    return {"loss_gap": _loss_gap(got, ref),
            "grad_gap": _grad_gap(got, ref, lr, keys),
            "change_gap": _leaf_gap(d_port, d_ref, moving),
            "window_loss_gap": _loss_gap(got["window"], ref["window"]),
            "window_grad_gap": _grad_gap(got["window"], ref["window"], lr,
                                         keys)}


def judge(st) -> dict:
    cell = st["cell"]
    got = port_answers(st)
    ref = reference_steps(cell, len(got["losses"]), got["lr"],
                          start=got["window"]["snaps"][0])
    lim = cell.wl["check"]["limits"]
    return {k: {"value": v, "limit": lim[k]} for k, v in gaps(got, ref).items()}


def readings(st, control: bool = True) -> dict:
    """The numbers against the reference, of its bfloat16 control and of
    two faults: the reference with half the lanes left out (the mean
    over the rest), and the port's losses altered by 1%.  A state left
    unchanged reads 1 in `change_gap` by its definition.  Without
    `control`, the first alone."""
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
