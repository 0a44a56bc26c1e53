"""Ray-scene intersection front end (port of rgk_tpu/ops/intersect.py).

`make_intersector` returns the routine the integrator calls for every
extension and shadow ray.  For the flat scenes of this slice that is
the flat sweep (`ops/flat_intersect.py`), which dispatches on the
tensors' device: the CUDA kernel for a CUDA tensor, its plain version
for a CPU tensor.  Hit records are (t, tri, bary_b, bary_c); the
barycentric weight of vertex A is 1 - b - c.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.builder import FLAT_MAX_TRIANGLES
from . import vecmath as vm
from .flat_intersect import intersect_flat


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


def make_intersector(meta):
    """The intersection routine for a committed scene."""
    if meta.n_triangles > FLAT_MAX_TRIANGLES:
        raise NotImplementedError(
            "scenes above the flat-sweep size need the cluster-BVH kernel "
            "K2 (rgk_tpu/ops/pallas_cluster.py), which is not ported yet")

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
