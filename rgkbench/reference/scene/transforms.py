# The port's own copy of rgk_tpu/scene/transforms.py, kept equal to it.
"""Host-side 4x4 transform helpers (numpy, column-vector convention).

Replicates the reference's object-placement pipeline exactly
(reference src/config.cpp InstallScene): scale, then rotation about the
*negative* Z, Y, X axes (in that order) by degrees, then translation.
Normals/tangents are transformed by the same matrix's linear part and
renormalized (src/scene.cpp AddPrimitive:226-228) — intentionally not
the inverse-transpose, to keep behavioral parity.
"""

from __future__ import annotations

import numpy as np

DEG = 0.0174533  # the reference's degree->radian constant (config.cpp)


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s[0], s[1], s[2]
    return m


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def rotate(angle_rad: float, axis) -> np.ndarray:
    """Rotation about `axis` by `angle_rad` (right-handed, like glm)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    x, y, z = a
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float64)
    r3 = c * np.eye(3) + s * K + (1 - c) * np.outer(a, a)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r3
    return m


def object_transform(scale_v, rotate_deg, translate_v,
                     pre: np.ndarray | None = None) -> np.ndarray:
    """The reference's S -> Rz(-Z) -> Ry(-Y) -> Rx(-X) -> T pipeline
    (config.cpp:472-479), optionally pre-composed with `pre`
    (axis alignment / primitive pre-scale)."""
    m = pre if pre is not None else identity()
    m = scale(scale_v) @ m
    m = rotate(DEG * rotate_deg[2], (0.0, 0.0, -1.0)) @ m
    m = rotate(DEG * rotate_deg[1], (0.0, -1.0, 0.0)) @ m
    m = rotate(DEG * rotate_deg[0], (-1.0, 0.0, 0.0)) @ m
    m = translate(translate_v) @ m
    return m


def axis_pre_transform(axis: str) -> np.ndarray:
    """Primitive axis reorientation (config.cpp:486-494): built-ins are
    Y-up; axis X rotates pi/2 about +Z, axis Z rotates pi/2 about +X."""
    if axis == "Y":
        return identity()
    if axis == "X":
        return rotate(np.pi / 2.0, (0.0, 0.0, 1.0))
    if axis == "Z":
        return rotate(np.pi / 2.0, (1.0, 0.0, 0.0))
    raise ValueError(f'axis must be X, Y or Z, got "{axis}"')


def apply_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply 4x4 to [N,3] points."""
    return pts @ m[:3, :3].T + m[:3, 3]


def apply_vectors(m: np.ndarray, vecs: np.ndarray, renormalize=True) -> np.ndarray:
    """Apply linear part to [N,3] direction vectors."""
    out = vecs @ m[:3, :3].T
    if renormalize:
        n = np.linalg.norm(out, axis=-1, keepdims=True)
        out = out / np.maximum(n, 1e-20)
    return out
