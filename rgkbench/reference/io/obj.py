# The port's own copy of rgk_tpu/io/obj.py, kept equal to it.
"""Wavefront OBJ/MTL loading with normal & tangent generation.

Replaces the reference's assimp import path (reference
src/config.cpp loadAssimpScene + src/scene.cpp LoadAiMesh):
* triangulates polygon faces (fan),
* unifies (position, uv, normal) triples into shared vertices
  (the effect of aiProcess_JoinIdenticalVertices),
* generates faceted or smooth normals when the file has none
  (aiProcess_GenNormals / GenSmoothNormals),
* generates UV-space tangents (aiProcess_CalcTangentSpace),
* parses MTL materials: Kd/Ks/Ke/Ns/map_Kd/map_Ks/map_bump.

Returns a list of `ObjMesh` (one per material group) plus the material
dictionary; the scene config layer turns MTL materials into LTC-GGX +
diffuse materials exactly like the reference's assimp importer
(src/bxdf/bxdf.cpp LoadFromAiMaterial: roughness =
sqrt(2/(2+Ns/4))).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class MtlMaterial:
    name: str
    diffuse: np.ndarray = field(default_factory=lambda: np.full(3, 0.6, np.float32))
    specular: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    shininess: float = 0.0
    diffuse_map: str = ""
    specular_map: str = ""
    bump_map: str = ""


@dataclass
class ObjMesh:
    material: str  # material name ("" if none)
    positions: np.ndarray  # [V,3] f32
    normals: np.ndarray    # [V,3] f32
    uvs: np.ndarray        # [V,2] f32
    tangents: np.ndarray   # [V,3] f32
    faces: np.ndarray      # [F,3] int32


def parse_mtl(path: str) -> Dict[str, MtlMaterial]:
    mats: Dict[str, MtlMaterial] = {}
    cur: Optional[MtlMaterial] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = MtlMaterial(name=" ".join(parts[1:]))
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur.diffuse = np.array(parts[1:4], np.float32)
            elif key == "Ks" and len(parts) >= 4:
                cur.specular = np.array(parts[1:4], np.float32)
            elif key == "Ke" and len(parts) >= 4:
                cur.emission = np.array(parts[1:4], np.float32)
            elif key == "Ns" and len(parts) >= 2:
                cur.shininess = float(parts[1])
            elif key == "map_Kd" and len(parts) >= 2:
                cur.diffuse_map = parts[-1]
            elif key == "map_Ks" and len(parts) >= 2:
                cur.specular_map = parts[-1]
            elif key in ("map_bump", "map_Bump", "bump") and len(parts) >= 2:
                cur.bump_map = parts[-1]
    return mats


def _parse_index(tok: str, nv: int, nt: int, nn: int):
    """Parse an OBJ face corner `v[/vt[/vn]]` with 1-based and negative
    index support.  Returns (v, vt, vn) 0-based, -1 for absent."""
    comps = tok.split("/")
    v = int(comps[0])
    v = v - 1 if v > 0 else nv + v
    vt = -1
    vn = -1
    if len(comps) > 1 and comps[1]:
        vt = int(comps[1])
        vt = vt - 1 if vt > 0 else nt + vt
    if len(comps) > 2 and comps[2]:
        vn = int(comps[2])
        vn = vn - 1 if vn > 0 else nn + vn
    return v, vt, vn


def _assemble_mesh(mat_name, corners, positions_np, uvs_np, normals_np,
                   smooth_normals):
    """Vectorized vertex unification + normal/tangent generation for
    one material group.  corners: int32 [F,3,3] of (v, vt, vn)."""
    flat = corners.reshape(-1, 3)
    # Unify (v, vt, vn) triples.  Packing into one int64 key makes
    # np.unique ~6x faster than axis=0 row uniqueness; fall back to
    # rows when the key space could overflow (gigantic meshes).
    nv = int(flat[:, 0].max()) + 2 if flat.size else 2
    nt = int(flat[:, 1].max()) + 2 if flat.size else 2
    nn = int(flat[:, 2].max()) + 2 if flat.size else 2
    if float(nv) * nt * nn < 2 ** 62:
        key = ((flat[:, 0].astype(np.int64) * nt
                + (flat[:, 1] + 1)) * nn + (flat[:, 2] + 1))
        ukey, first_idx, inv = np.unique(key, return_index=True,
                                         return_inverse=True)
        uniq = flat[first_idx]
    else:
        uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)

    v_idx = uniq[:, 0]
    vt_idx = uniq[:, 1]
    vn_idx = uniq[:, 2]
    pos = positions_np[v_idx]
    uv = np.where((vt_idx >= 0)[:, None],
                  uvs_np[np.maximum(vt_idx, 0)] if uvs_np.shape[0]
                  else np.zeros((uniq.shape[0], 2), np.float32),
                  0.0).astype(np.float32)

    # Face normals (standard CCW: cross(B-A, C-A)).
    fa, fb, fc = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    fn = np.cross(fb - fa, fc - fa)
    fl = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = fn / np.maximum(fl, 1e-20)

    have_file_normals = (vn_idx >= 0).all() and normals_np.shape[0]
    if have_file_normals:
        nrm = normals_np[vn_idx]
    elif smooth_normals:
        # Smooth normals: area-weighted accumulation at shared
        # *positions* so coincident corners agree
        # (aiProcess_GenSmoothNormals analogue).
        acc = np.zeros_like(positions_np)
        for ci in range(3):
            np.add.at(acc, v_idx[faces[:, ci]], fn * fl)
        ln = np.linalg.norm(acc, axis=-1, keepdims=True)
        acc = acc / np.maximum(ln, 1e-20)
        nrm = acc[v_idx]
    else:
        # Faceted: replicate face normal to its corners (corners
        # shared across faces get the last writer — matches the
        # flat-shading intent of aiProcess_GenNormals closely
        # enough for unshared soup vertices).
        nrm = np.zeros_like(pos)
        for ci in range(3):
            nrm[faces[:, ci]] = fn

    tangents = _generate_tangents(pos, uv, faces)
    return ObjMesh(material=mat_name, positions=pos.astype(np.float32),
                   normals=nrm.astype(np.float32), uvs=uv,
                   tangents=tangents, faces=faces)


def _tokenize_python(path: str):
    """Pure-python tokenizer: same outputs as the native one
    (native/obj_native.tokenize_obj) — the test oracle."""
    positions: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    corners: List[tuple] = []
    group_of_face: List[int] = []
    group_ids: Dict[str, int] = {}
    group_names: List[str] = []
    mtllibs: List[str] = []
    current_group = -1

    def ensure_group(name: str) -> int:
        if name not in group_ids:
            group_ids[name] = len(group_names)
            group_names.append(name)
        return group_ids[name]

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v" and len(parts) >= 4:
                positions.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
            elif key == "vt" and len(parts) >= 3:
                uvs.append([float(parts[1]), float(parts[2])])
            elif key == "vn" and len(parts) >= 4:
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif key == "f" and len(parts) >= 4:
                nv, nt, nn = len(positions), len(uvs), len(normals)
                cs = [_parse_index(t, nv, nt, nn) for t in parts[1:]]
                if current_group < 0:
                    current_group = ensure_group("")
                for i in range(1, len(cs) - 1):  # fan triangulation
                    corners.append((cs[0], cs[i], cs[i + 1]))
                    group_of_face.append(current_group)
            elif key == "usemtl":
                current_group = ensure_group(" ".join(parts[1:]))
            elif key == "mtllib":
                mtllibs.append(" ".join(parts[1:]))

    pos_np = (np.asarray(positions, np.float32).reshape(-1, 3)
              if positions else np.zeros((0, 3), np.float32))
    uvs_np = (np.asarray(uvs, np.float32).reshape(-1, 2)
              if uvs else np.zeros((0, 2), np.float32))
    nrm_np = (np.asarray(normals, np.float32).reshape(-1, 3)
              if normals else np.zeros((0, 3), np.float32))
    corners_np = (np.asarray(corners, np.int32).reshape(-1, 3, 3)
                  if corners else np.zeros((0, 3, 3), np.int32))
    group_np = np.asarray(group_of_face, np.int32)
    return pos_np, uvs_np, nrm_np, corners_np, group_np, group_names, \
        mtllibs


def _tokenize_numpy(path: str):
    """`_tokenize_python`'s outputs for a file of `v`, `vt`, `vn` and
    triangle `f` lines with positive indices in one corner format, and
    no groups or materials (what the benchmark's generators write),
    parsed in bulk by numpy; None for any other file."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    rows = {b"v": [], b"vt": [], b"vn": [], b"f": []}
    for line in lines:
        key = line[:line.find(b" ")] if b" " in line else line.strip()
        if key in rows:
            rows[key].append(line[len(key) + 1:])
        elif key and not key.startswith(b"#"):
            return None

    def floats(key, width):
        if not rows[key]:
            return np.zeros((0, width), np.float32)
        got = np.array(b" ".join(rows[key]).split(), np.float64)
        if got.size != width * len(rows[key]):
            return None
        return got.reshape(-1, width).astype(np.float32)

    pos, uvs, nrm = floats(b"v", 3), floats(b"vt", 2), floats(b"vn", 3)
    if pos is None or uvs is None or nrm is None:
        return None
    faces = rows[b"f"]
    if not faces:
        return None
    corner = faces[0].split()[0]
    slots = ((0,) if b"/" not in corner else (0, 2) if b"//" in corner
             else (0, 1, 2))
    text = b" ".join(faces).replace(b"//", b" ").replace(b"/", b" ")
    ids = np.array(text.split(), np.int64)
    if ids.size != 3 * len(slots) * len(faces) or (ids <= 0).any():
        return None
    ids = ids.reshape(len(faces), 3, len(slots)) - 1
    corners = np.full((len(faces), 3, 3), -1, np.int32)
    for j, slot in enumerate(slots):
        corners[..., slot] = ids[..., j]
    return (pos, uvs, nrm, corners, np.zeros(len(faces), np.int32), [""],
            [])


def load_obj(path: str, smooth_normals: bool = False):
    """Parse an OBJ file.

    Returns (meshes: List[ObjMesh], materials: Dict[str, MtlMaterial]).
    Meshes are split by active material, as the reference's per-mesh
    material binding requires.  Tokenizing takes `_tokenize_numpy` for
    files of plain triangles, the pure-python tokenizer otherwise.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    tokens = _tokenize_numpy(path) or _tokenize_python(path)
    pos_np, uvs_np, nrm_np, corners, group, group_names, mtllibs = tokens

    basedir = os.path.dirname(path)
    materials: Dict[str, MtlMaterial] = {}
    for m in mtllibs:
        materials.update(parse_mtl(os.path.join(basedir, m)))

    meshes: List[ObjMesh] = []
    for gid, name in enumerate(group_names):
        sel = group == gid
        if not np.any(sel):
            continue
        meshes.append(_assemble_mesh(name, corners[sel], pos_np, uvs_np,
                                     nrm_np, smooth_normals))
    return meshes, materials


def _generate_tangents(pos: np.ndarray, uv: np.ndarray,
                       faces: np.ndarray) -> np.ndarray:
    """Per-vertex UV-space tangents (Lengyel), accumulated over faces —
    the aiProcess_CalcTangentSpace analogue."""
    tan = np.zeros_like(pos)
    if pos.shape[0] == 0 or faces.shape[0] == 0:
        return tan
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    e1 = pos[b] - pos[a]
    e2 = pos[c] - pos[a]
    du1 = uv[b, 0] - uv[a, 0]
    dv1 = uv[b, 1] - uv[a, 1]
    du2 = uv[c, 0] - uv[a, 0]
    dv2 = uv[c, 1] - uv[a, 1]
    det = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    t = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    for ci, idx in ((0, a), (1, b), (2, c)):
        np.add.at(tan, idx, t)
    ln = np.linalg.norm(tan, axis=-1, keepdims=True)
    return (tan / np.maximum(ln, 1e-20)).astype(np.float32)
