"""Per-pixel debug tracing, the `-d X Y` diagnostics (port of
rgk_tpu/integrator/debug.py).

The wavefront integrator is replayed one bounce at a time for a single
(pixel, sample) lane on the scene's device, printing the intersection,
shading frame, material decision and path-termination state at every
vertex.  Each bounce is the tracers' own extension step
(`path._extend_path`), so its queries go through the scene's
intersection route (K1 or K2 on the card).
"""

from __future__ import annotations

import torch

from ..ops import sampler as smp
from ..scene.camera import pixel_rays
from . import path as path_mod


def trace_pixel_debug(scene, meta, settings, cam, x: int, y: int,
                      sample: int = 0, seed: int = 42,
                      sampler_mode: int = 1, printer=print) -> list:
    """Trace one sample of pixel (x, y), printing per-bounce state.

    Returns the list of per-bounce record dicts (also printed via
    `printer`)."""
    su = path_mod._setup(scene, meta, settings)
    dev = scene.tri_pack.device
    cam = cam.to(dev)

    px = torch.tensor([x], dtype=torch.int32, device=dev)
    py = torch.tensor([y], dtype=torch.int32, device=dev)
    ctx = smp.SampleCtx(
        seed=int(seed) & 0xFFFFFFFF,
        pixel=torch.tensor([y * cam.xres + x], dtype=torch.int64, device=dev),
        sample=torch.tensor([sample], dtype=torch.int64, device=dev),
        mode=sampler_mode, n_set=su.n_set)

    jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
    lens = None if cam.is_simple else smp.sample_2d(ctx, smp.DIM_LENS)
    ro, rd = pixel_rays(cam, px, py, jitter, lens_sample=lens)

    printer(f"[debug {x},{y} s{sample}] camera ray o={_v(ro)} d={_v(rd)}")

    state = dict(ro=ro, rd=rd,
                 last_tri=torch.full((1,), -1, dtype=torch.int32, device=dev),
                 contribution=torch.ones((1, 3), dtype=torch.float32,
                                         device=dev),
                 alive=torch.ones((1,), dtype=torch.bool, device=dev))

    records = []
    names = meta.material_names
    for bounce in range(su.depth):
        contrib = state["contribution"]
        new, sp, _, act, _, sky_mask = path_mod._extend_path(
            scene, meta, settings, su, ctx, state["ro"], state["rd"],
            state["last_tri"], contrib, state["alive"], bounce, su.russian,
            path_mod.TAG_EYE)
        rec = {
            "bounce": bounce,
            "sky": bool(sky_mask[0]),
            "hit": bool(act[0]),
            "tri": int(sp.tri[0]),
            "pos": _a(sp.pos),
            "face_n": _a(sp.face_n),
            "light_n": _a(sp.light_n),
            "uv": _a(sp.uv),
            "mat_id": int(sp.mat_id[0]),
            "contribution_in": _a(contrib),
            "contribution_out": _a(new["contribution"]),
            "next_dir": _a(new["rd"]),
            "alive_after": bool(new["alive"][0]),
        }
        records.append(rec)
        if rec["sky"]:
            printer(f"  b{bounce}: escaped to sky; dir={_v(state['rd'])}")
            break
        if not rec["hit"]:
            printer(f"  b{bounce}: no usable hit; terminating")
            break
        mname = (names[rec["mat_id"]]
                 if rec["mat_id"] < len(names) else f"#{rec['mat_id']}")
        printer(f"  b{bounce}: tri {rec['tri']} mat '{mname}' "
                f"p={_v(sp.pos)} n={_v(sp.light_n)} uv={_v(sp.uv)}")
        printer(f"      contribution {_v(contrib)} -> "
                f"{_v(new['contribution'])}; next d={_v(new['rd'])}; "
                f"alive={rec['alive_after']}")
        state = new
        if not rec["alive_after"]:
            printer(f"      path terminated (russian roulette / cutoff / "
                    f"light leak) after vertex {bounce + 1}")
            break
    return records


def _a(t):
    return t[0].detach().cpu().tolist()


def _v(t):
    vals = t[0].detach().cpu().reshape(-1).tolist()
    return "(" + ", ".join(f"{float(v):.4g}" for v in vals) + ")"
