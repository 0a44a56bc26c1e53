"""Host-side scene assembly (port of rgk_tpu/scene/builder.py).

Materials, textures, geometry and lights are gathered in numpy on the
host, then `commit(device=...)` freezes them into the port's
`SceneArrays` on one device.  The numpy build is the reference's,
line for line, so the committed arrays equal `rgk_tpu`'s exactly.

Above `bvh_threshold` triangles (`FLAT_MAX_TRIANGLES` by default; never
with `build_bvh=False`) the commit also builds the leaf-4 BVH
(scene/bvh.py) and, on its triangle order, the chunk tree of the
cluster kernel (scene/clusters.py), and sets `SceneMeta.has_bvh`.
Each phase of a build is a span `scene.<phase>` (`utils/trace.py`):
load (`config.build_scene`), sah, clusters and upload;
`SceneBuilder.timings` is a view of them, host seconds by phase.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..io import load_texture
from ..ops.ltc import load_tables_np
from ..utils import log as out
from ..utils import trace
from ..utils.lru import LRU
from . import transforms as xf
from . import bvh as bvh_mod
from .bvh import builder_name, placeholder_bvh
from .clusters import build_clusters, empty_clusters
from .json_utils import ConfigError
from .arrays import (
    BSDF_DIFFUSE,
    BSDF_LTC_BECKMANN,
    BSDF_LTC_BECKMANN_DIFFUSE,
    BSDF_LTC_GGX,
    BSDF_LTC_GGX_DIFFUSE,
    BSDF_MIX,
    LightTable,
    MaterialTable,
    SceneArrays,
    SceneMeta,
    TextureAtlas,
    f32,
    i32,
)

# Largest scene the flat sweep serves (the reference's bvh_threshold).
FLAT_MAX_TRIANGLES = 4096


def build_tri_pack(vertices: np.ndarray, tri_vidx: np.ndarray) -> np.ndarray:
    """Per-triangle Badouel intersection coefficients, [M, 12]:
    (n.xyz, d, b0, bv.xyz, g0, gv.xyz), so that for a ray (ro, rd)
        t     = -(d + ro.n) / (rd.n)
        beta  = b0 + ro.bv + t * (rd.bv)      (and likewise gamma)
    (reference primitives.cpp:75-166, solved on the dominant-axis
    projection in float64)."""
    a = vertices[tri_vidx[:, 0]].astype(np.float64)
    b = vertices[tri_vidx[:, 1]].astype(np.float64)
    c = vertices[tri_vidx[:, 2]].astype(np.float64)
    n = np.cross(c - a, b - a)
    nl = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(nl, 1e-30)
    d = -np.sum(n * a, axis=-1)

    k = np.argmax(np.abs(n), axis=-1)
    i1 = np.where(k == 0, 1, 0)
    i2 = np.where(k == 2, 1, 2)

    def sel(v, idx):
        return np.where(idx == 0, v[:, 0],
                        np.where(idx == 1, v[:, 1], v[:, 2]))

    a1, a2 = sel(a, i1), sel(a, i2)
    b1 = sel(b, i1) - a1
    b2 = sel(b, i2) - a2
    c1 = sel(c, i1) - a1
    c2 = sel(c, i2) - a2
    denom = b1 * c2 - b2 * c1
    denom = np.where(np.abs(denom) > 1e-30, denom, 1e-30)

    def place(v1, v2):
        """Vector with component i1 = v1, component i2 = v2, rest 0."""
        col0 = np.where(i1 == 0, v1, 0.0)
        col1 = np.where(i1 == 1, v1, np.where(i2 == 1, v2, 0.0))
        col2 = np.where(i2 == 2, v2, 0.0)
        return np.stack([col0, col1, col2], axis=1)

    bv = place(c2 / denom, -c1 / denom)
    gv = place(-b2 / denom, b1 / denom)
    b0 = -(a1 * c2 - a2 * c1) / denom
    g0 = -(a2 * b1 - a1 * b2) / denom

    pack = np.concatenate([
        n, d[:, None], b0[:, None], bv, g0[:, None], gv], axis=1)
    return pack.astype(np.float32)


def append_thinglass_column(pack: np.ndarray, tri_mat: np.ndarray,
                            is_thinglass: np.ndarray) -> np.ndarray:
    """Column 12: 1.0 for triangles of thin-glass materials, which the
    intersectors skip (the reference's live pass-through behavior)."""
    col = is_thinglass[tri_mat].astype(np.float32)[:, None]
    return np.concatenate([pack, col], axis=1).astype(np.float32)


def glass_subset(tri_pack: np.ndarray):
    """-> (glass_pack f32 [G, 12], glass_ids i32 [G]): the Badouel rows
    of the thin-glass triangles (column 12 set) and their ids, or one
    row that never hits (d = 1, n = 0) with id -1 when there are none."""
    gmask = tri_pack[:, 12] > 0.5
    if gmask.any():
        return (tri_pack[gmask, :12].astype(np.float32),
                np.nonzero(gmask)[0].astype(np.int32))
    glass_pack = np.zeros((1, 12), np.float32)
    glass_pack[0, 3] = 1.0
    return glass_pack, np.full((1,), -1, np.int32)


def phong_exponent_to_roughness(exponent: float) -> float:
    """The reference's Phong-exponent -> LTC roughness map."""
    return float(np.sqrt(2.0 / (2.0 + exponent)))


@dataclass
class MaterialSpec:
    """Host-side material description, later packed into MaterialTable."""
    name: str
    bxdf: int = BSDF_DIFFUSE
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    diffuse: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))
    diffuse_tex: int = -1
    specular: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    specular_tex: int = -1
    bump_tex: int = -1
    roughness: float = 0.5
    ior: float = 1.0
    mix_m1: str = ""
    mix_m2: str = ""
    mix_amt: float = 0.5
    no_russian: bool = False
    is_thinglass: bool = False


class SceneBuilder:
    # Decoded-texture cache shared across builders, keyed by
    # (path, mtime): the orbit animation rebuilds the scene per frame.
    _decoded_lru = LRU(64)

    def __init__(self):
        self.materials: List[MaterialSpec] = []
        self.material_index: Dict[str, int] = {}
        self.textures: List[np.ndarray] = []
        self.texture_index: Dict[str, int] = {}

        self.vertices: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.tangents: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.tri_vidx: List[np.ndarray] = []
        self.tri_mat: List[np.ndarray] = []
        self._vertex_count = 0
        self._tri_count = 0

        # Areal light groups: (material_index, [triangle indices])
        self.areal_groups: List[tuple] = []
        self.point_lights: List[dict] = []

        self.sky_color = np.zeros(3, np.float32)
        self.sky_intensity = 1.0
        self.sky_rotate = 0.0
        self.sky_tex = -1
        # The build's phase spans ("load" from config.build_scene), and
        # the SAH builder that ran.
        self._spans: List[trace.Span] = []
        self.sah_builder: Optional[str] = None

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times the `with` block as span `scene.<name>`, kept for
        `timings`."""
        with trace.span("scene." + name) as sp:
            self._spans.append(sp)
            yield sp

    @property
    def timings(self) -> Dict[str, float]:
        """Host seconds by phase of the latest build, from its spans."""
        return {sp.name[len("scene."):]: sp.seconds for sp in self._spans}

    # ---------------- materials & textures ----------------

    def register_material(self, spec: MaterialSpec, override: bool = False) -> int:
        """Register by name; duplicates are kept or replaced per
        `override`."""
        if spec.name in self.material_index:
            idx = self.material_index[spec.name]
            if override:
                self.materials[idx] = spec
            return idx
        idx = len(self.materials)
        self.materials.append(spec)
        self.material_index[spec.name] = idx
        return idx

    def material_id(self, name: str) -> int:
        if name not in self.material_index:
            raise ConfigError(f'Material named "{name}" was not defined')
        return self.material_index[name]

    def get_texture(self, path: str) -> int:
        """Load-once texture cache keyed by path."""
        path = os.path.normpath(path)
        if path in self.texture_index:
            return self.texture_index[path]
        key = (path, os.path.getmtime(path) if os.path.exists(path) else 0)
        img = SceneBuilder._decoded_lru.get(key)
        if img is None:
            img = load_texture(path)
            SceneBuilder._decoded_lru.put(key, img)
        idx = len(self.textures)
        self.textures.append(img)
        self.texture_index[path] = idx
        out.log(5, f"Loaded texture '{path}' {img.shape[1]}x{img.shape[0]}")
        return idx

    # ---------------- geometry ----------------

    def add_soup(self, positions, normals, uvs, tangents, material: str,
                 transform: Optional[np.ndarray] = None,
                 texture_transform: Optional[np.ndarray] = None) -> None:
        """Add an unindexed triangle soup (3 consecutive rows = 1 face)."""
        positions = np.asarray(positions, np.float64)
        n = positions.shape[0]
        if n % 3:
            raise ValueError(f"soup of {n} vertices is not whole triangles")
        if transform is not None:
            positions = xf.apply_points(transform, positions)
            normals = xf.apply_vectors(transform, np.asarray(normals, np.float64))
            tangents = xf.apply_vectors(transform, np.asarray(tangents, np.float64))
        uvs = np.asarray(uvs, np.float64)
        if texture_transform is not None:
            uv1 = np.concatenate([uvs, np.ones((n, 1))], axis=1)
            uvs = (uv1 @ texture_transform.T)[:, :2]
        faces = np.arange(n, dtype=np.int64).reshape(-1, 3)
        self.add_mesh(positions, normals, uvs, tangents, faces, material)

    def add_mesh(self, positions, normals, uvs, tangents, faces,
                 material: str) -> None:
        """Add an indexed mesh with shared-per-vertex attributes."""
        mat_id = self.material_id(material)
        v0 = self._vertex_count
        positions = np.asarray(positions, np.float32)
        nverts = positions.shape[0]
        self.vertices.append(positions)
        self.normals.append(np.asarray(normals, np.float32))
        self.tangents.append(
            np.zeros((nverts, 3), np.float32) if tangents is None
            else np.asarray(tangents, np.float32))
        self.uvs.append(
            np.zeros((nverts, 2), np.float32) if uvs is None
            else np.asarray(uvs, np.float32))
        faces = np.asarray(faces, np.int64) + v0
        nf = faces.shape[0]
        self.tri_vidx.append(faces.astype(np.int32))
        self.tri_mat.append(np.full(nf, mat_id, np.int32))
        self._vertex_count += nverts

        if np.any(self.materials[mat_id].emission != 0.0):
            tri_ids = np.arange(self._tri_count, self._tri_count + nf)
            self.areal_groups.append((mat_id, tri_ids))
        self._tri_count += nf

    # ---------------- lights & sky ----------------

    def add_point_light(self, pos, color, intensity: float, size: float = 0.0):
        self.point_lights.append(dict(
            pos=np.asarray(pos, np.float32),
            color=np.asarray(color, np.float32),
            intensity=float(intensity), size=float(size)))

    def set_sky_color(self, color, intensity: float = 1.0) -> None:
        self.sky_color = np.asarray(color, np.float32)
        self.sky_intensity = float(intensity)
        self.sky_tex = -1

    def set_sky_envmap(self, path: str, intensity: float = 1.0,
                       rotate: float = 0.0) -> None:
        self.sky_tex = self.get_texture(path)
        self.sky_intensity = float(intensity)
        self.sky_rotate = float(rotate)

    def make_thinglass_set(self, phrases: List[str]) -> None:
        """Materials whose name contains any phrase become thin glass."""
        for spec in self.materials:
            if any(p in spec.name for p in phrases):
                spec.is_thinglass = True

    # ---------------- commit ----------------

    def commit(self, device, build_bvh: bool = True,
               bvh_threshold: int = FLAT_MAX_TRIANGLES):
        """Freeze to `SceneArrays` on `device` + `SceneMeta`.

        Computes the dynamic epsilon (1e-5 x bbox diameter), the
        per-triangle normals and Badouel rows, the light tables and,
        with `build_bvh` above `bvh_threshold` triangles, the BVH and
        cluster structures; otherwise the scene stays flat whatever its
        size."""
        if self._tri_count == 0:
            raise ConfigError("cannot commit an empty scene")

        vertices = np.concatenate(self.vertices, axis=0)
        normals = np.concatenate(self.normals, axis=0)
        tangents = np.concatenate(self.tangents, axis=0)
        uvs = np.concatenate(self.uvs, axis=0)
        tri_vidx = np.concatenate(self.tri_vidx, axis=0)
        tri_mat = np.concatenate(self.tri_mat, axis=0)

        # Geometric plane normal: normalize(cross(C-A, B-A)).
        a = vertices[tri_vidx[:, 0]]
        b = vertices[tri_vidx[:, 1]]
        c = vertices[tri_vidx[:, 2]]
        gn = np.cross(c - a, b - a)
        gl = np.linalg.norm(gn, axis=-1, keepdims=True)
        tri_normal = gn / np.maximum(gl, 1e-20)

        wmin = vertices.min(axis=0)
        wmax = vertices.max(axis=0)
        epsilon = 1e-5 * float(np.linalg.norm(wmax - wmin))
        out.log(3, f"Using dynamic epsilon: {epsilon}")

        tri_pack = append_thinglass_column(
            build_tri_pack(vertices, tri_vidx), tri_mat,
            np.asarray([m.is_thinglass for m in self.materials], bool))

        has_bvh = build_bvh and self._tri_count > bvh_threshold
        if has_bvh:
            with self.phase("sah"):
                bvh = bvh_mod.build_bvh(vertices, tri_vidx, leaf_size=4,
                                        device=device)
            # One SAH sweep feeds both structures: the chunk tree chops
            # the BVH's own triangle order.
            with self.phase("clusters"):
                clusters = build_clusters(vertices, tri_vidx, tri_pack,
                                          order=bvh.prim_idx.cpu().numpy(),
                                          device=device)
            self.sah_builder = builder_name()
        else:
            bvh = placeholder_bvh(self._tri_count, device)
            clusters = empty_clusters(device)

        glass_pack, glass_ids = glass_subset(tri_pack)
        with self.phase("upload"):
            arrays = SceneArrays(
                vertices=f32(vertices, device), normals=f32(normals, device),
                tangents=f32(tangents, device), uvs=f32(uvs, device),
                tri_vidx=i32(tri_vidx, device), tri_mat=i32(tri_mat, device),
                tri_normal=f32(tri_normal, device),
                tri_pack=f32(tri_pack, device),
                tri_meta=i32(np.concatenate(
                    [tri_vidx, tri_mat[:, None]], axis=1), device),
                tri_shade=f32(np.concatenate([
                    normals[tri_vidx].reshape(-1, 9),
                    uvs[tri_vidx].reshape(-1, 6),
                    tangents[tri_vidx].reshape(-1, 9)], axis=1), device),
                glass_pack=f32(glass_pack, device),
                glass_ids=i32(glass_ids, device),
                ltc_rows=f32(load_tables_np(), device),
                materials=self._pack_materials(device),
                textures=self._pack_textures(device),
                lights=self._pack_lights(vertices, normals, tri_vidx, device),
                bvh=bvh,
                clusters=clusters,
                sky_color=f32(self.sky_color, device),
                sky_intensity=f32(self.sky_intensity, device),
                sky_rotate=f32(self.sky_rotate, device),
                sky_tex=i32(self.sky_tex, device),
                epsilon=f32(epsilon, device),
                world_min=f32(wmin - epsilon, device),
                world_max=f32(wmax + epsilon, device),
            )
        meta = SceneMeta(
            n_triangles=int(self._tri_count),
            n_materials=len(self.materials),
            n_point_lights=len(self.point_lights),
            n_areal_tris=int(arrays.lights.areal_tri.shape[0])
            if float(arrays.lights.total_areal_power) > 0 else 0,
            has_textures=len(self.textures) > 0,
            has_thinglass=any(m.is_thinglass for m in self.materials),
            has_bvh=has_bvh,
            has_mix=any(m.bxdf == BSDF_MIX for m in self.materials),
            has_ltc=any(m.bxdf in (
                BSDF_LTC_BECKMANN, BSDF_LTC_GGX,
                BSDF_LTC_BECKMANN_DIFFUSE, BSDF_LTC_GGX_DIFFUSE)
                for m in self.materials),
            has_envmap=self.sky_tex >= 0,
            material_names=tuple(m.name for m in self.materials),
        )
        out.log(2, f"Committed {self._vertex_count} vertices, "
                   f"{self._tri_count} triangles, {len(self.textures)} "
                   f"textures, {len(self.point_lights)} pointlights and "
                   f"{len(self.areal_groups)} areal lights to the scene.")
        out.log(3, f"Host build seconds ({self.sah_builder or 'no'} SAH "
                   "builder): " + ", ".join(
                       f"{k} {v:.3f}" for k, v in self.timings.items()))
        return arrays, meta

    def _pack_materials(self, device) -> MaterialTable:
        mats = self.materials or [MaterialSpec(name="__default")]

        def res_mix(name, self_idx):
            return self.material_index.get(name, self_idx)

        return MaterialTable(
            bxdf_type=i32([m.bxdf for m in mats], device),
            emission=f32([m.emission for m in mats], device),
            diffuse=f32([m.diffuse for m in mats], device),
            diffuse_tex=i32([m.diffuse_tex for m in mats], device),
            specular=f32([m.specular for m in mats], device),
            specular_tex=i32([m.specular_tex for m in mats], device),
            bump_tex=i32([m.bump_tex for m in mats], device),
            roughness=f32([m.roughness for m in mats], device),
            ior=f32([m.ior for m in mats], device),
            mix_m1=i32([res_mix(m.mix_m1, i) for i, m in enumerate(mats)],
                       device),
            mix_m2=i32([res_mix(m.mix_m2, i) for i, m in enumerate(mats)],
                       device),
            mix_amt=f32([m.mix_amt for m in mats], device),
            no_russian=i32([m.no_russian for m in mats], device).bool(),
            is_thinglass=i32([m.is_thinglass for m in mats], device).bool(),
        )

    def _pack_textures(self, device) -> TextureAtlas:
        if not self.textures:
            return TextureAtlas(texels=f32(np.zeros((1, 3)), device),
                                desc=i32(np.zeros((1, 3)), device))
        descs, chunks, offset = [], [], 0
        for img in self.textures:
            h, w = img.shape[:2]
            descs.append((offset, w, h))
            chunks.append(img.reshape(-1, 3))
            offset += w * h
        return TextureAtlas(texels=f32(np.concatenate(chunks, axis=0), device),
                            desc=i32(np.asarray(descs), device))

    def _pack_lights(self, vertices, normals, tri_vidx, device) -> LightTable:
        # Point lights: power = intensity * 4*pi.
        if self.point_lights:
            p_pos = np.stack([l["pos"] for l in self.point_lights])
            p_col = np.stack([l["color"] for l in self.point_lights])
            p_int = np.array([l["intensity"] for l in self.point_lights], np.float32)
            p_size = np.array([l["size"] for l in self.point_lights], np.float32)
            p_pow = p_int * 4.0 * np.pi
        else:
            p_pos = np.zeros((1, 3), np.float32)
            p_col = np.zeros((1, 3), np.float32)
            p_int = np.zeros(1, np.float32)
            p_size = np.zeros(1, np.float32)
            p_pow = np.zeros(1, np.float32)
        total_point = float(p_pow.sum())

        # Areal lights flattened to triangles of weight area * sum(emission).
        a_tri, a_w, a_em = [], [], []
        total_areal = 0.0
        for mat_id, tri_ids in self.areal_groups:
            em = np.asarray(self.materials[mat_id].emission, np.float32)
            va = vertices[tri_vidx[tri_ids, 0]]
            vb = vertices[tri_vidx[tri_ids, 1]]
            vc = vertices[tri_vidx[tri_ids, 2]]
            areas = 0.5 * np.linalg.norm(np.cross(va - vb, vc - vb), axis=-1)
            w = areas * float(em.sum())
            a_tri.append(tri_ids)
            a_w.append(w)
            a_em.append(np.broadcast_to(em, (len(tri_ids), 3)))
            total_areal += float(w.sum())
        if a_tri:
            a_tri = np.concatenate(a_tri)
            a_w = np.concatenate(a_w)
            a_em = np.concatenate(a_em, axis=0)
        else:
            a_tri = np.zeros(1, np.int32)
            a_w = np.zeros(1, np.float32)
            a_em = np.zeros((1, 3), np.float32)

        # De-indexed rows: vertices + vertex-A shading normal + emission.
        a_rows = np.zeros((a_tri.shape[0], 15), np.float32)
        tidx = np.clip(a_tri, 0, tri_vidx.shape[0] - 1)
        a_rows[:, 0:3] = vertices[tri_vidx[tidx, 0]]
        a_rows[:, 3:6] = vertices[tri_vidx[tidx, 1]]
        a_rows[:, 6:9] = vertices[tri_vidx[tidx, 2]]
        a_rows[:, 9:12] = normals[tri_vidx[tidx, 0]]
        a_rows[:, 12:15] = a_em

        out.log(3, f"Total areal lights power: {total_areal}W")
        out.log(3, f"Total point lights power: {total_point}W")
        return LightTable(
            point_pos=f32(p_pos, device),
            point_color=f32(p_col, device),
            point_intensity=f32(p_int, device),
            point_size=f32(p_size, device),
            point_cum=f32(np.cumsum(p_pow), device),
            areal_tri=i32(a_tri, device),
            areal_cum=f32(np.cumsum(a_w), device),
            areal_rows=f32(a_rows, device),
            total_point_power=f32(total_point, device),
            total_areal_power=f32(total_areal, device),
        )
