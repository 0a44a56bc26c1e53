"""Ray-triangle queries of the plain reference: every ray against every
triangle, in blocks of rays; above `FLAT_MAX_TRIANGLES` triangles every
ray against every triangle of each group of `GROUP` whose padded box it
crosses (`culled_sweep`, the same answers).

The test is the renderer's definition (Badouel's, on the coefficient
rows of `tri_pack` [M, 13] that the reference's own scene build makes):
a hit needs a plane crossing with |rd.n| > 1e-9, both barycentrics >= 0
with their sum <= 1, t inside the open window (t_min, t_max) and an id
other than the lane's `exclude`.  A
closest query returns the least t, the least id among equal t; an any
query returns tri 0 where some row is hit, else -1.

Gradients: the sweep runs without one.  On a scene of at most
`FLAT_MAX_TRIANGLES` triangles a closest hit's t and barycentrics are
recomputed from the winner's row with the rays' gradient, so the hit
point is differentiated along the ray; above it hits are detached, as
the renderer defines them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import vecmath as vm

BIG = 3.4e38
FLAT_MAX_TRIANGLES = 4096
_PARALLEL_EPS = 1e-9
# Bytes of [rays, M] float planes one block keeps live.
BLOCK_BYTES = 4 << 30
_PLANES = 12


class Hit(NamedTuple):
    t: torch.Tensor        # f32 [R]; BIG when no hit
    tri: torch.Tensor      # int32 [R]; -1 when no hit
    bary_b: torch.Tensor   # f32 [R]
    bary_c: torch.Tensor   # f32 [R]

    @property
    def valid(self):
        return self.tri >= 0


def _lanes(x, r: int, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        return torch.full((r,), x, dtype=dtype, device=device)
    return x.to(dtype).expand(r).contiguous()


def _test(rows, ro, rd):
    """(t, beta, gamma, parallel-safe) of rays ro, rd [r, 3] (or [r, 1,
    3]) against coefficient rows [M, 13] (or [r, 13]), column by column
    so that no [r, M, 3] tensor is made."""
    (nx, ny, nz, d, b0, bvx, bvy, bvz, g0, gvx, gvy,
     gvz) = rows[..., :12].unbind(-1)
    ox, oy, oz = ro.unbind(-1)
    dx, dy, dz = rd.unbind(-1)
    rddn = dx * nx + dy * ny + dz * nz
    safe = torch.abs(rddn) > _PARALLEL_EPS
    t = -(ox * nx + oy * ny + oz * nz + d) / torch.where(safe, rddn, 1.0)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    beta = b0 + px * bvx + py * bvy + pz * bvz
    gamma = g0 + px * gvx + py * gvy + pz * gvz
    return t, beta, gamma, safe


def sweep(tri_pack, ro, rd, t_min, t_max, exclude, any_hit=False) -> Hit:
    """Every ray [R, 3] against every row of `tri_pack`, no gradient."""
    r, m = ro.shape[0], tri_pack.shape[0]
    dev = ro.device
    t_out = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    b_out = torch.zeros(r, dtype=torch.float32, device=dev)
    c_out = torch.zeros(r, dtype=torch.float32, device=dev)
    if r == 0 or m == 0:
        return Hit(t_out, tri_out, b_out, c_out)
    ids = torch.arange(m, device=dev)[None]
    step = max(1, BLOCK_BYTES // (m * 4 * _PLANES))
    with torch.no_grad():
        for s in range(0, r, step):
            e = min(r, s + step)
            t, beta, gamma, safe = _test(tri_pack, ro[s:e, None],
                                         rd[s:e, None])
            ok = (safe & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1)
                  & (t > t_min[s:e, None]) & (t < t_max[s:e, None])
                  & (ids != exclude[s:e, None]))
            t_sel = torch.where(ok, t, BIG)
            best, idx = t_sel.min(dim=1, keepdim=True)
            found = best[:, 0] < BIG
            if any_hit:
                tri_out[s:e] = torch.where(found, 0, -1).to(torch.int32)
                t_out[s:e] = best[:, 0]
                continue
            # The least id among the rows at the least t.
            idx = torch.where(ok & (t_sel == best), ids, m).amin(dim=1)
            idx = torch.clamp(idx, max=m - 1)[:, None]
            t_out[s:e] = best[:, 0]
            tri_out[s:e] = torch.where(found, idx[:, 0], -1).to(torch.int32)
            b_out[s:e] = torch.where(found, beta.gather(1, idx)[:, 0], 0.0)
            c_out[s:e] = torch.where(found, gamma.gather(1, idx)[:, 0], 0.0)
    return Hit(t_out, tri_out, b_out, c_out)


def _record(tri_pack, ro, rd, hit: Hit) -> Hit:
    """A closest hit's t and barycentrics recomputed from the winner's
    row with the rays' gradient."""
    found = hit.tri >= 0
    rows = tri_pack[torch.clamp(hit.tri, min=0).long()]
    t, beta, gamma, _ = _test(rows, ro, rd)
    return Hit(torch.where(found, t, hit.t), hit.tri,
               torch.where(found, beta, hit.bary_b),
               torch.where(found, gamma, hit.bary_c))


GROUP = 256          # triangles of a group, in Morton order of centroids
PAIRS = 1 << 16      # (ray, group) pairs tested at once
RAYS = 1 << 13       # rays slab-tested against every group box at once


def _spread(x):
    """10-bit ints -> every third bit (Morton interleave)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


class Groups(NamedTuple):
    ids: torch.Tensor     # int64 [G, GROUP] triangle ids, -1 padding
    lo: torch.Tensor      # f32 [G, 3] padded group box
    hi: torch.Tensor


def make_groups(vertices, tri_vidx) -> Groups:
    """Triangles in groups of GROUP by the Morton code of their
    centroids, with each group's box padded by 1e-4 of the scene's
    extent, so that no rounding in the slab test drops a hit."""
    v = vertices[tri_vidx.long()]                      # [M, 3, 3]
    tlo, thi = v.amin(1), v.amax(1)
    wlo, whi = tlo.amin(0), thi.amax(0)
    ext = torch.clamp(whi - wlo, min=1e-12)
    q = ((tlo + thi) * 0.5 - wlo) / ext
    q = torch.clamp((q * 1023).long(), 0, 1023)
    code = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) | _spread(q[:, 2])
    order = torch.argsort(code)
    m = order.shape[0]
    g = -(-m // GROUP)
    ids = torch.full((g * GROUP,), -1, dtype=torch.int64, device=v.device)
    ids[:m] = order
    ids = ids.reshape(g, GROUP)
    big = torch.finfo(torch.float32).max
    member = (ids >= 0)[..., None]
    lo = torch.where(member, tlo[ids.clamp(min=0)], big).amin(1)
    hi = torch.where(member, thi[ids.clamp(min=0)], -big).amax(1)
    pad = 1e-4 * float(ext.max())
    return Groups(ids=ids, lo=lo - pad, hi=hi + pad)


def culled_sweep(tri_pack, groups: Groups, ro, rd, t_min, t_max, exclude,
                 any_hit=False) -> Hit:
    """`sweep`'s answers, testing only the triangles of the groups whose
    box the ray's interval crosses."""
    r, dev = ro.shape[0], ro.device
    m = tri_pack.shape[0]
    # A hit's t > t_min >= 0, so the bits of t order as the floats do:
    # (t bits << 32) | id is least at the least t, then the least id.
    none = torch.iinfo(torch.int64).max
    key = torch.full((r,), none, dtype=torch.int64, device=dev)
    inv = 1.0 / torch.where(torch.abs(rd) > 1e-20, rd,
                            torch.where(rd >= 0, 1e-20, -1e-20))
    with torch.no_grad():
        for s in range(0, r, RAYS):
            e = min(r, s + RAYS)
            t0 = (groups.lo[None] - ro[s:e, None]) * inv[s:e, None]
            t1 = (groups.hi[None] - ro[s:e, None]) * inv[s:e, None]
            tn = torch.minimum(t0, t1).amax(-1)
            tf = torch.maximum(t0, t1).amin(-1)
            cross = ((tf >= tn) & (tf >= t_min[s:e, None])
                     & (tn <= t_max[s:e, None]))
            ray, grp = torch.nonzero(cross, as_tuple=True)
            ray = ray + s
            for p in range(0, ray.shape[0], PAIRS):
                pr, pg = ray[p:p + PAIRS], grp[p:p + PAIRS]
                ids = groups.ids[pg]                           # [P, GROUP]
                rows = tri_pack[ids.clamp(min=0)]
                t, beta, gamma, safe = _test(rows, ro[pr, None], rd[pr, None])
                t = t.contiguous()
                ok = (safe & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1)
                      & (t > t_min[pr, None]) & (t < t_max[pr, None])
                      & (ids >= 0) & (ids != exclude[pr, None]))
                k = (t.view(torch.int32).long() << 32) | ids.clamp(min=0)
                key.scatter_reduce_(0, pr, torch.where(ok, k, none).amin(1),
                                    "amin")
    found = key < none
    t_out = torch.where(found, (key >> 32).int().view(torch.float32), BIG)
    if any_hit:
        return Hit(t_out, torch.where(found, 0, -1).to(torch.int32),
                   torch.zeros_like(t_out), torch.zeros_like(t_out))
    win = torch.where(found, key & 0xFFFFFFFF, 0)
    _, b_w, c_w, _ = _test(tri_pack[win], ro, rd)
    return Hit(t_out, torch.where(found, win, -1).to(torch.int32),
               torch.where(found, b_w, 0.0), torch.where(found, c_w, 0.0))


def make_intersector(meta):
    """The query routine the reference's integrator calls for every
    extension and shadow ray (a trace makes one, and its triangle groups
    once)."""
    cache = {}

    def query(scene, ro, rd, t_min, t_max, exclude=None,
              any_hit: bool = False) -> Hit:
        r, dev = ro.shape[0], ro.device
        pack = scene.tri_pack
        args = (ro.detach(), rd.detach(),
                _lanes(t_min, r, torch.float32, dev).detach(),
                _lanes(t_max, r, torch.float32, dev).detach(),
                _lanes(-1 if exclude is None else exclude, r, torch.int64,
                       dev), any_hit)
        if pack.shape[0] > FLAT_MAX_TRIANGLES:
            if "groups" not in cache:
                cache["groups"] = make_groups(scene.vertices, scene.tri_vidx)
            hit = culled_sweep(pack, cache["groups"], *args)
        else:
            hit = sweep(pack, *args)
        graded = (torch.is_grad_enabled()
                  and (ro.requires_grad or rd.requires_grad))
        if any_hit or pack.shape[0] > FLAT_MAX_TRIANGLES or not graded:
            return hit
        return _record(pack, ro, rd, hit)

    return query


def visibility(scene, intersect_fn, a, b, eps_mult: float = 20.0,
               active=None):
    """Mutual visibility of points a, b: occluded iff any hit in
    (eps*20, |b-a| - eps*20), traced from b toward a.  Inactive lanes
    (`active` False) get an empty interval."""
    d = a - b
    dist = vm.length(d)
    rd = d / dist[..., None]
    eps = scene.epsilon * eps_mult
    t_far = dist - eps
    if active is not None:
        t_far = torch.where(active, t_far, -1.0)
    hit = intersect_fn(scene, b, rd, eps, t_far, any_hit=True)
    return ~hit.valid
