"""Scene arrays as torch tensors (port of rgk_tpu/scene/arrays.py).

The committed scene is a NamedTuple of tensors on one device; static
facts live in `SceneMeta`.  Fields and layouts are the reference's, so
a scene built here equals one built by `rgk_tpu` field by field.

No acceleration structure and no thin-glass subset: the reference's
queries sweep `tri_pack` (ops/intersect.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

# BxDF type enum (dispatch indices for ops/bxdf.py), as in the reference.
BSDF_DIFFUSE = 0
BSDF_MIRROR = 1
BSDF_TRANSPARENT = 2
BSDF_DIELECTRIC = 3
BSDF_LTC_BECKMANN = 4
BSDF_LTC_GGX = 5
BSDF_LTC_BECKMANN_DIFFUSE = 6
BSDF_LTC_GGX_DIFFUSE = 7
BSDF_MIX = 8

BSDF_NAMES = {
    "diffuse": BSDF_DIFFUSE,
    "diffusecosine": BSDF_DIFFUSE,
    "mirror": BSDF_MIRROR,
    "transparent": BSDF_TRANSPARENT,
    "dielectric": BSDF_DIELECTRIC,
    "ltc_beckmann": BSDF_LTC_BECKMANN,
    "ltc_ggx": BSDF_LTC_GGX,
    "ltc_beckmann_diffuse": BSDF_LTC_BECKMANN_DIFFUSE,
    "ltc_ggx_diffuse": BSDF_LTC_GGX_DIFFUSE,
    "mix": BSDF_MIX,
}


class MaterialTable(NamedTuple):
    bxdf_type: torch.Tensor     # int32 [NM]
    emission: torch.Tensor      # f32 [NM,3]
    diffuse: torch.Tensor       # f32 [NM,3]
    diffuse_tex: torch.Tensor   # int32 [NM], -1 = solid color
    specular: torch.Tensor      # f32 [NM,3]
    specular_tex: torch.Tensor  # int32 [NM]
    bump_tex: torch.Tensor      # int32 [NM]
    roughness: torch.Tensor     # f32 [NM]
    ior: torch.Tensor           # f32 [NM]
    mix_m1: torch.Tensor        # int32 [NM] (self when not a mix)
    mix_m2: torch.Tensor        # int32 [NM]
    mix_amt: torch.Tensor       # f32 [NM]
    no_russian: torch.Tensor    # bool [NM]


class TextureAtlas(NamedTuple):
    texels: torch.Tensor  # f32 [N, 3] flat texel pool (>= 1 row)
    desc: torch.Tensor    # int32 [T, 3] = (offset, width, height)


class LightTable(NamedTuple):
    point_pos: torch.Tensor        # f32 [P,3]
    point_color: torch.Tensor      # f32 [P,3]
    point_intensity: torch.Tensor  # f32 [P]
    point_size: torch.Tensor       # f32 [P]
    point_cum: torch.Tensor        # f32 [P] inclusive prefix of power
    areal_tri: torch.Tensor        # int32 [K] emissive triangle ids
    areal_cum: torch.Tensor        # f32 [K] inclusive prefix of weight
    areal_rows: torch.Tensor       # f32 [K,15] (va, vb, vc, n_a, emission)
    total_point_power: torch.Tensor  # f32 []
    total_areal_power: torch.Tensor  # f32 []


class SceneArrays(NamedTuple):
    vertices: torch.Tensor    # f32 [V,3]
    normals: torch.Tensor     # f32 [V,3]
    tangents: torch.Tensor    # f32 [V,3]
    uvs: torch.Tensor         # f32 [V,2]
    tri_vidx: torch.Tensor    # int32 [M,3]
    tri_mat: torch.Tensor     # int32 [M]
    tri_normal: torch.Tensor  # f32 [M,3] geometric plane normal
    # Badouel rows (n.xyz, d, b0, bv.xyz, g0, gv.xyz), the operand of
    # every query (ops/intersect.py).
    tri_pack: torch.Tensor    # f32 [M,12]
    tri_meta: torch.Tensor    # int32 [M,4] = (v0, v1, v2, material)
    tri_shade: torch.Tensor   # f32 [M,24] per-corner normals, uvs, tangents
    ltc_rows: torch.Tensor    # f32 [2*64*64, 10] LTC fit tables
    materials: MaterialTable
    textures: TextureAtlas
    lights: LightTable
    sky_color: torch.Tensor      # f32 [3]
    sky_intensity: torch.Tensor  # f32 []
    sky_rotate: torch.Tensor     # f32 [] (degrees)
    sky_tex: torch.Tensor        # int32 [] (< 0: constant color)
    epsilon: torch.Tensor        # f32 [] dynamic scene epsilon
    world_min: torch.Tensor      # f32 [3]
    world_max: torch.Tensor      # f32 [3]


@dataclass(frozen=True)
class SceneMeta:
    """Static facts about a committed scene.  The has_* flags let the
    integrator skip code paths the scene cannot reach."""
    n_triangles: int
    n_materials: int
    n_point_lights: int
    n_areal_tris: int
    has_textures: bool
    has_mix: bool = True
    has_ltc: bool = True
    has_envmap: bool = True
    material_names: tuple = ()


def f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def i32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.int32)).to(device)
