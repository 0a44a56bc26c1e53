"""Light selection over prefix-sum power tables (port of
rgk_tpu/ops/lights.py).

Point vs areal class by total power, then the light within the class:
point lights by intensity*4pi, emissive triangles by area*emission.
`kind` 0 = point ("full sphere"), 1 = areal ("hemisphere").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import vecmath as vm
from . import warps

LIGHT_POINT = 0
LIGHT_AREAL = 1


class LightSample(NamedTuple):
    kind: torch.Tensor       # int32 [...]
    pos: torch.Tensor        # f32 [...,3]
    color: torch.Tensor      # f32 [...,3]
    intensity: torch.Tensor  # f32 [...]
    size: torch.Tensor       # f32 [...]
    normal: torch.Tensor     # f32 [...,3]
    valid: torch.Tensor      # bool [...]

    def directional_factor(self, v):
        """1 for point lights; max(0, dot(v, normal)) for areal."""
        cos = torch.clamp(vm.dot(v, self.normal), min=0.0)
        return torch.where(self.kind == LIGHT_POINT, 1.0, cos)


def _pick(cum, q, n):
    """First index with cum >= q (searchsorted side="left"), clamped."""
    idx = torch.searchsorted(cum, q.contiguous(), right=False)
    return torch.clamp(idx, 0, n - 1)


def sample_light(scene, choice2, tri2) -> LightSample:
    """Pick one light per lane.  choice2 [...,2]: x picks the class and
    the point light, y the emissive triangle; tri2 [...,2]: uniform
    point on the chosen triangle."""
    lt = scene.lights
    total_point = lt.total_point_power
    total_areal = lt.total_areal_power
    total = total_point + total_areal
    valid = total > 0.0

    q = choice2[..., 0] * total
    choose_point = q < total_point
    # q is already uniform on [0, total_point) given the class choice.
    p_idx = _pick(lt.point_cum, q, lt.point_pos.shape[0])
    q2 = choice2[..., 1] * total_areal
    a_idx = _pick(lt.areal_cum, q2, lt.areal_tri.shape[0])

    # One row fetch per class, as the reference's: the point pack is
    # (pos, color, intensity, size).
    point_pack = torch.cat([lt.point_pos, lt.point_color,
                            lt.point_intensity[:, None],
                            lt.point_size[:, None]], dim=1)
    prow = vm.take_rows(point_pack, p_idx)
    arow = vm.take_rows(lt.areal_rows, a_idx)
    tri_pos = warps.to_triangle_uniform(tri2, arow[..., 0:3],
                                        arow[..., 3:6], arow[..., 6:9])
    p_pos = prow[..., 0:3]
    cp = choose_point[..., None]
    return LightSample(
        kind=torch.where(choose_point, LIGHT_POINT, LIGHT_AREAL).to(torch.int32),
        pos=torch.where(cp, p_pos, tri_pos),
        color=torch.where(cp, prow[..., 3:6], arow[..., 12:15]),
        intensity=torch.where(choose_point, prow[..., 6], 1.0),
        size=torch.where(choose_point, prow[..., 7], 0.0),
        # Areal: vertex A's shading normal, as in the reference.
        normal=torch.where(cp, vm.safe_normalize(p_pos), arow[..., 9:12]),
        valid=valid.expand(choose_point.shape),
    )


def offset_sphere_light(light: LightSample, areal2) -> LightSample:
    """Point lights of size > 0 move by size * uniform-sphere(areal2),
    their normal along that offset (reference TracePath)."""
    sdir = warps.to_sphere_uniform(areal2)
    is_point = (light.kind == LIGHT_POINT)[..., None]
    return light._replace(
        pos=torch.where(is_point, light.pos + light.size[..., None] * sdir,
                        light.pos),
        normal=torch.where(is_point, vm.safe_normalize(sdir), light.normal))
