"""Thin-glass ordered hit lists and the tint filter (port of
rgk_tpu/ops/thinglass.py).

The intersectors skip thin-glass triangles (column 12 of `tri_pack`),
so glass never blocks a ray.  The `tint-thinglass` extension filters
light by the panes a segment crosses: `collect_thinglass` lists the
crossings of each ray in ascending t, and `apply_thinglass` walks them,
skips repeats within the scene epsilon, and multiplies by the pane's
diffuse color on each entering crossing.

The list is a dense [R, G] plane sweep over `scene.glass_pack`, the
glass subset, with G in the tens (panes are few), in plain PyTorch: the
reference computes it in plain jnp too, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from . import vecmath as vm

_BIG = 3.4e38
_PARALLEL_EPS = 1e-9


def _column(x):
    """A scalar or [R] bound as something that broadcasts over [R, G]."""
    if isinstance(x, torch.Tensor) and x.dim():
        return x[:, None]
    return x


def collect_thinglass(scene, ro, rd, t_min, t_max, k_max: int = 4):
    """Ordered thin-glass crossings per ray.

    ro, rd f32 [R, 3]; t_min, t_max scalars or [R].  Returns (ts f32
    [R, K], tris int32 [R, K]) in ascending t, K = k_max; empty slots
    hold 3.4e38 / -1.  A ray crossing more than k_max panes keeps the
    nearest k_max.  Each step takes the smallest t above the last one;
    `argmin` picks the first glass row among equal t, as the reference
    does, and a second pane at exactly the same t is not listed."""
    pack = scene.glass_pack                    # [G, 12]
    n = pack[:, 0:3]
    rddn = rd @ n.T                            # [R, G]
    rodn = ro @ n.T + pack[:, 3][None, :]
    safe = torch.abs(rddn) > _PARALLEL_EPS
    t = -rodn / torch.where(safe, rddn, 1.0)
    px = ro[:, 0:1] + t * rd[:, 0:1]
    py = ro[:, 1:2] + t * rd[:, 1:2]
    pz = ro[:, 2:3] + t * rd[:, 2:3]
    beta = (pack[:, 4][None, :] + px * pack[:, 5][None, :]
            + py * pack[:, 6][None, :] + pz * pack[:, 7][None, :])
    gamma = (pack[:, 8][None, :] + px * pack[:, 9][None, :]
             + py * pack[:, 10][None, :] + pz * pack[:, 11][None, :])
    ok = (safe & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (t > _column(t_min)) & (t < _column(t_max)))
    t = torch.where(ok, t, _BIG)

    ids = scene.glass_ids
    ts, tris = [], []
    cur = torch.full(t.shape[:1], -float("inf"), dtype=t.dtype,
                     device=t.device)
    for _ in range(k_max):
        later = torch.where(t > cur[:, None], t, _BIG)
        tk, ik = torch.min(later, dim=1)   # first index among ties
        found = tk < _BIG
        ts.append(torch.where(found, tk, _BIG))
        tris.append(torch.where(found, ids[ik], -1).to(torch.int32))
        cur = torch.where(found, tk, cur)
    return torch.stack(ts, dim=1), torch.stack(tris, dim=1)


def apply_thinglass(scene, radiance, ts, tris, rd, tint: bool = False):
    """Walk the crossings in ascending t, skip a repeat within the scene
    epsilon of the last counted one, and on each entering crossing
    (dot(N, rd) >= 0 with the triangle's geometric normal) multiply by
    its material's diffuse color when `tint` is set.  Without `tint`
    the radiance passes through unchanged, as in the reference's live
    code."""
    eps = scene.epsilon
    ct = torch.full(ts.shape[:1], -1.0, dtype=ts.dtype, device=ts.device)
    out = radiance
    for k in range(ts.shape[1]):
        tk = ts[:, k]
        trik = tris[:, k]
        listed = trik >= 0
        valid = listed & (tk > ct + eps)
        ct = torch.where(valid, tk, ct)
        if tint:
            tri = torch.clamp(trik, min=0).long()
            entering = vm.dot(scene.tri_normal[tri], rd) >= 0.0
            color = scene.materials.diffuse[scene.tri_meta[tri, 3].long()]
            out = torch.where((valid & entering)[..., None], out * color, out)
    return out
