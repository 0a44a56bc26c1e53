"""Ray-scene intersection front end (port of rgk_tpu/ops/intersect.py).

`make_intersector` returns the routine the integrator calls for every
extension and shadow ray:
* flat scenes (at most 4096 triangles): the flat sweep
  (`ops/flat_intersect.py`), which dispatches on the tensors' device:
  the CUDA kernel K1 for a CUDA tensor, its plain version for a CPU
  tensor;
* BVH scenes (`meta.has_bvh`): on a CUDA tensor the cluster kernel K2
  through its front end (`ops/cluster_intersect.py`), or the binned
  pipeline K3 + K4 (`ops/binned_intersect.py`) as `RGK_BINNED` asks
  (`binned_mode`, read once, when the routine is made: a routine keeps
  its route, and so does a CUDA graph captured around it); on a CPU
  tensor `intersect_bvh`, the reference's own non-TPU route, whatever
  `RGK_BINNED` says.
This module alone reads `RGK_BINNED`.
Hit records are (t, tri, bary_b, bary_c); the barycentric weight of
vertex A is 1 - b - c.

Gradients: the kernels' outputs carry none, and BVH scenes' hits are
detached on either device (as the reference's `intersect_bvh`).  On a
flat scene, under autograd with rays that carry a gradient, the sweep
(K1 on the card, `flat_plain` on the CPU) picks the winner without one
and t and the barycentrics are recomputed from its row in torch ops, so
on either device autograd differentiates the hit point along the ray,
as the reference's `intersect_brute` does (a parameter that moves a
ray, such as the roughness of a glossy bounce, keeps that term).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from . import vecmath as vm
from .binned_intersect import intersect_clusters_binned
from .cluster_intersect import intersect_clusters
from .flat_intersect import intersect_flat

BIG = 3.4e38
_PARALLEL_EPS = 1e-9


class Hit(NamedTuple):
    t: torch.Tensor        # f32 [R]; BIG when no hit
    tri: torch.Tensor      # int32 [R]; -1 when no hit
    bary_b: torch.Tensor   # f32 [R]
    bary_c: torch.Tensor   # f32 [R]

    @property
    def valid(self):
        return self.tri >= 0


def _lanes(x, r: int, dtype, device) -> torch.Tensor:
    """A scalar or [R] argument as a contiguous [R] tensor."""
    if not isinstance(x, torch.Tensor):
        return torch.full((r,), x, dtype=dtype, device=device)
    return x.to(dtype).expand(r).contiguous()


def _pack_test(pack_rows, ro, rd, t_min, t_max):
    """Badouel test for per-lane gathered coefficient rows [..., 13]
    (shared hit point p = ro + t*rd; col 12 = thin glass)."""
    n = pack_rows[..., 0:3]
    d = pack_rows[..., 3]
    rddn = vm.dot(rd, n)
    safe = torch.abs(rddn) > _PARALLEL_EPS
    t = -(vm.dot(ro, n) + d) / torch.where(safe, rddn, 1.0)
    p = ro + t[..., None] * rd
    beta = pack_rows[..., 4] + vm.dot(p, pack_rows[..., 5:8])
    gamma = pack_rows[..., 8] + vm.dot(p, pack_rows[..., 9:12])
    ok = (safe & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (t > t_min) & (t < t_max) & (pack_rows[..., 12] < 0.5))
    return ok, t, beta, gamma


def intersect_bvh(scene, ro, rd, t_min, t_max, exclude=None,
                  any_hit: bool = False, leaf_size: int = 4) -> Hit:
    """Stackless skip-link traversal of the leaf-4 BVH (scene/bvh.py),
    the plain route for BVH scenes on the CPU (port of
    rgk_tpu/ops/intersect.py intersect_bvh).

    Every lane walks its own cursor in a host loop: slab-test the node
    against (t_min, min(best t, t_max)), test a hit leaf's slots, then
    descend (inner hit) or follow the skip link.  Within a leaf a slot
    wins only with a strictly smaller t, so the first found keeps a tie,
    as in the reference.  Finished lanes leave the live set.  Hits are
    detached: traversal is not differentiated."""
    ro, rd = ro.detach(), rd.detach()
    r, dev = ro.shape[0], ro.device
    t_min = _lanes(t_min, r, torch.float32, dev).detach()
    t_max = _lanes(t_max, r, torch.float32, dev).detach()
    exclude = _lanes(-1 if exclude is None else exclude, r, torch.int32, dev)
    bvh = scene.bvh
    node_min, node_max = bvh.node_min, bvh.node_max
    first, count, skip = (bvh.node_meta[:, i].long() for i in range(3))
    prim_idx = bvh.prim_idx.long()
    pack = scene.tri_pack
    n_nodes = first.shape[0]
    k = torch.arange(leaf_size, device=dev)

    inv_d = 1.0 / torch.where(torch.abs(rd) > 1e-20, rd,
                              torch.where(rd >= 0, 1e-20, -1e-20))
    out_t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    out_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    out_b = torch.zeros(r, dtype=torch.float32, device=dev)
    out_c = torch.zeros(r, dtype=torch.float32, device=dev)

    lane = torch.arange(r, device=dev)
    node = torch.zeros(r, dtype=torch.int64, device=dev)
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    bb = torch.zeros(r, dtype=torch.float32, device=dev)
    bc = torch.zeros(r, dtype=torch.float32, device=dev)
    ro_l, rd_l, inv_l, tmin, tmax, excl = ro, rd, inv_d, t_min, t_max, exclude

    while lane.numel():
        t0 = (node_min[node] - ro_l) * inv_l
        t1 = (node_max[node] - ro_l) * inv_l
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        cap = torch.minimum(best_t, tmax)
        hit_box = (tf >= tn) & (tf >= tmin) & (tn <= cap)
        cnt = count[node]

        lf = torch.nonzero(hit_box & (cnt > 0)).flatten()
        if lf.numel():
            slots = torch.clamp(first[node[lf], None] + k, 0,
                                prim_idx.shape[0] - 1)
            pid = prim_idx[slots]                          # [L, leaf]
            ok, t, beta, gamma = _pack_test(
                pack[pid], ro_l[lf, None], rd_l[lf, None], tmin[lf, None],
                cap[lf, None])
            ok = ok & (k < cnt[lf, None]) & (pid != excl[lf, None])
            t_sel = torch.where(ok, t, BIG)
            j = torch.argmin(t_sel, dim=1, keepdim=True)   # first of the min
            win = ok.gather(1, j)[:, 0]
            sel = lf[win]
            best_t[sel] = t_sel.gather(1, j)[win, 0]
            best_tri[sel] = pid.gather(1, j)[win, 0].to(torch.int32)
            bb[sel] = beta.gather(1, j)[win, 0]
            bc[sel] = gamma.gather(1, j)[win, 0]

        node = torch.where(hit_box & (cnt == 0), first[node], skip[node])
        done = node >= n_nodes
        if any_hit:
            done = done | (best_tri >= 0)
        fin = torch.nonzero(done).flatten()
        if fin.numel():
            ids = lane[fin]
            out_t[ids] = best_t[fin]
            out_tri[ids] = best_tri[fin]
            out_b[ids] = bb[fin]
            out_c[ids] = bc[fin]
            keep = torch.nonzero(~done).flatten()
            (lane, node, best_t, best_tri, bb, bc, ro_l, rd_l, inv_l, tmin,
             tmax, excl) = (x[keep] for x in (
                 lane, node, best_t, best_tri, bb, bc, ro_l, rd_l, inv_l,
                 tmin, tmax, excl))
    found = out_tri >= 0
    return Hit(t=torch.where(found, out_t, BIG), tri=out_tri, bary_b=out_b,
               bary_c=out_c)


def binned_mode(meta) -> str:
    """The route of a scene's queries on a CUDA tensor, from `RGK_BINNED`
    now: "any" sends any-hit queries through the binned pipeline and
    closest-hit queries through K2; "all" sends both through the binned
    pipeline; any other value (default "off") is K2 only.  A flat scene
    has one route: "off"."""
    return os.environ.get("RGK_BINNED", "off") if meta.has_bvh else "off"


def make_intersector(meta):
    """The intersection routine for a committed scene (module doc), its
    route (`binned_mode`) read now."""
    if meta.has_bvh:
        mode = binned_mode(meta)

        def tree(scene, ro, rd, t_min, t_max, exclude=None,
                 any_hit: bool = False) -> Hit:
            if ro.device.type == "cpu":
                return intersect_bvh(scene, ro, rd, t_min, t_max,
                                     exclude=exclude, any_hit=any_hit)
            binned = mode == "all" or (mode == "any" and any_hit)
            fn = intersect_clusters_binned if binned else intersect_clusters
            r, dev = ro.shape[0], ro.device
            # Detached as on the CPU route: the front ends recompute the
            # record from ro and rd, and hits take no gradient.
            return Hit(*fn(
                scene.clusters, scene.tri_pack, ro.detach().contiguous(),
                rd.detach().contiguous(), _lanes(t_min, r, torch.float32, dev),
                _lanes(t_max, r, torch.float32, dev),
                _lanes(-1 if exclude is None else exclude, r, torch.int32,
                       dev), any_hit=any_hit))

        return tree

    def flat(scene, ro, rd, t_min, t_max, exclude=None,
             any_hit: bool = False) -> Hit:
        r, dev = ro.shape[0], ro.device
        return Hit(*intersect_flat(
            scene.tri_pack, ro.contiguous(), rd.contiguous(),
            _lanes(t_min, r, torch.float32, dev),
            _lanes(t_max, r, torch.float32, dev),
            _lanes(-1 if exclude is None else exclude, r, torch.int32, dev),
            any_hit=any_hit))

    return flat


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
