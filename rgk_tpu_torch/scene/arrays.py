"""Scene arrays as torch tensors (port of rgk_tpu/scene/arrays.py).

The committed scene is a NamedTuple of tensors on one device; static
facts live in `SceneMeta`.  Fields and layouts are the reference's, so
a scene built here equals one built by `rgk_tpu` field by field.

Scenes above 4096 triangles also carry `bvh` (the leaf-4 skip-link
BVH that `ops/intersect.intersect_bvh` walks on the CPU) and `clusters`
(the chunk tree the cluster kernel K2 walks on the card); flat scenes
carry the reference's one-node placeholders.  The chunk size is the
Python int `ClusterArrays.chunk_halves`; the reference's `half_meta`,
whose shape carries it under jit, is kept so the arrays compare one to
one.

`glass_pack` / `glass_ids` hold the thin-glass subset: the Badouel
rows of the triangles whose material is thin glass and their ids in
`tri_pack`'s order, or one row that never hits (d = 1, n = 0, id -1)
when the scene has none.  `ops/thinglass.py` sweeps them for the
`tint-thinglass` extension.

Left out of the port, and ignored by `scene_from_numpy`: `pack_mp`, the
TPU flat kernel's sublane-padded pack; the CUDA flat sweep reads
`tri_pack` [M, 13] directly.
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
    is_thinglass: torch.Tensor  # bool [NM]


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


class BVHArrays(NamedTuple):
    """Flattened 2-wide BVH (scene/bvh.py), one row per node in DFS
    pre-order."""
    node_min: torch.Tensor   # f32 [NN,3]
    node_max: torch.Tensor   # f32 [NN,3]
    node_meta: torch.Tensor  # int32 [NN,3] = (first, count, skip)
    prim_idx: torch.Tensor   # int32 [M] leaf slot -> triangle id


class ClusterArrays(NamedTuple):
    """Two-level chunk structure (scene/clusters.py) read by the cluster
    kernel K2 (ops/cluster_intersect.py): u16 fixed-point node boxes,
    one leaf bit per node, eight per-octant link tables and the
    coefficient-major chunk pack."""
    boxes_q: torch.Tensor    # int32 [3*NC] quantized node AABBs
    leaf_bits: torch.Tensor  # int32 [ceil(NC/32)] leaf flags, 32 a word
    # int32 [8*ns, 128], ns = ceil(NC/128) rounded up to 8: octant o's
    # table is rows o*ns .. (o+1)*ns, node n at flat index n of it,
    # packed (hit << 16) | miss as unsigned 16-bit fields.
    links: torch.Tensor
    pack: torch.Tensor       # f32 [T*16, 128] coefficient-major tiles
    scene_lo: torch.Tensor   # f32 [3] quantization frame origin
    scene_step: torch.Tensor  # f32 [3] quantization step per axis
    half_meta: torch.Tensor  # int32 [chunk_halves] (the reference's shape)
    chunk_halves: int        # chunk size in 64-triangle halves


class SceneArrays(NamedTuple):
    vertices: torch.Tensor    # f32 [V,3]
    normals: torch.Tensor     # f32 [V,3]
    tangents: torch.Tensor    # f32 [V,3]
    uvs: torch.Tensor         # f32 [V,2]
    tri_vidx: torch.Tensor    # int32 [M,3]
    tri_mat: torch.Tensor     # int32 [M]
    tri_normal: torch.Tensor  # f32 [M,3] geometric plane normal
    # Badouel rows (n.xyz, d, b0, bv.xyz, g0, gv.xyz, thin-glass flag),
    # the operand of the flat sweep (ops/flat_intersect.py).
    tri_pack: torch.Tensor    # f32 [M,13]
    tri_meta: torch.Tensor    # int32 [M,4] = (v0, v1, v2, material)
    tri_shade: torch.Tensor   # f32 [M,24] per-corner normals, uvs, tangents
    glass_pack: torch.Tensor  # f32 [G,12] Badouel rows of thin-glass tris
    glass_ids: torch.Tensor   # int32 [G] their tri_pack ids (-1: none)
    ltc_rows: torch.Tensor    # f32 [2*64*64, 10] LTC fit tables
    materials: MaterialTable
    textures: TextureAtlas
    lights: LightTable
    bvh: BVHArrays
    clusters: ClusterArrays
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
    has_thinglass: bool
    has_bvh: bool = False
    has_mix: bool = True
    has_ltc: bool = True
    has_envmap: bool = True
    material_names: tuple = ()


def f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def i32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.int32)).to(device)


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def _convert(cls, tree, device):
    return cls(**{f: _tensor(getattr(tree, f), device) for f in cls._fields})


def _convert_clusters(tree, device) -> ClusterArrays:
    fields = {f: _tensor(getattr(tree, f), device)
              for f in ClusterArrays._fields if f != "chunk_halves"}
    return ClusterArrays(**fields,
                         chunk_halves=int(np.shape(tree.half_meta)[0]))


def scene_from_numpy(tree, device) -> SceneArrays:
    """Carry a scene committed by `rgk_tpu` over to the port.

    `tree` is an `rgk_tpu.scene.arrays.SceneArrays` whose leaves the
    caller turned into numpy arrays.  Every field of the port's
    `SceneArrays` is copied with its dtype, `bvh` and `clusters`
    included (the chunk size read from the shape of `half_meta`); the
    reference's `pack_mp` is ignored (see the module docstring)."""
    nested = {"materials": MaterialTable, "textures": TextureAtlas,
              "lights": LightTable, "bvh": BVHArrays}
    fields = {}
    for f in SceneArrays._fields:
        if f == "clusters":
            fields[f] = _convert_clusters(tree.clusters, device)
        elif f in nested:
            fields[f] = _convert(nested[f], getattr(tree, f), device)
        else:
            fields[f] = _tensor(getattr(tree, f), device)
    return SceneArrays(**fields)
