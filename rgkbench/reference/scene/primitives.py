# The port's own copy of rgk_tpu/scene/primitives.py, kept equal to it.
"""Built-in analytic primitives as triangle soups.

Vertex data parity with the reference's tables (reference
src/primitives.cpp:168-228): each primitive is (positions, normals,
uvs, tangents) per corner, 3 corners per face.  `plane` spans
[-1,1]^2 in XZ facing +Y; `tri` is its lower-left half; `cube` is the
[-1,1]^3 box (the config layer pre-scales it by 0.5 so its default
extent is a unit cube, config.cpp:485).
"""

from __future__ import annotations

import numpy as np

_Y = (0.0, 1.0, 0.0)
_TZ = (0.0, 0.0, 1.0)
_TX = (1.0, 0.0, 0.0)
_TY = (0.0, 1.0, 0.0)


def _soup(rows):
    pos = np.array([r[0] for r in rows], np.float64)
    nrm = np.array([r[1] for r in rows], np.float64)
    uv = np.array([r[2] for r in rows], np.float64)
    tan = np.array([r[3] for r in rows], np.float64)
    return pos, nrm, uv, tan


def plane_y():
    return _soup([
        ((1, 0, 1), _Y, (1, 1), _TZ),
        ((1, 0, -1), _Y, (1, 0), _TZ),
        ((-1, 0, 1), _Y, (0, 1), _TZ),
        ((-1, 0, -1), _Y, (0, 0), _TZ),
        ((-1, 0, 1), _Y, (0, 1), _TZ),
        ((1, 0, -1), _Y, (1, 0), _TZ),
    ])


def trig_y():
    return _soup([
        ((1, 0, 1), _Y, (1, 1), _TZ),
        ((1, 0, -1), _Y, (1, 0), _TZ),
        ((-1, 0, 1), _Y, (0, 1), _TZ),
    ])


def cube():
    rows = []

    def quad(corners, n, t):
        # Two triangles in the reference's corner order:
        # (c0,c1,c2), (c3,c2,c1) with uvs (1,1),(1,0),(0,1),(0,0)
        uvs = [(1, 1), (1, 0), (0, 1), (0, 0)]
        idx = [0, 1, 2, 3, 2, 1]
        for i in idx:
            rows.append((corners[i], n, uvs[i], t))

    # +X / -X walls (tangent +Z)
    quad([(1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1)], (1, 0, 0), _TZ)
    quad([(-1, 1, 1), (-1, 1, -1), (-1, -1, 1), (-1, -1, -1)], (-1, 0, 0), _TZ)
    # +Y / -Y walls (tangent +X)
    quad([(1, 1, 1), (1, 1, -1), (-1, 1, 1), (-1, 1, -1)], (0, 1, 0), _TX)
    quad([(-1, -1, 1), (-1, -1, -1), (1, -1, 1), (1, -1, -1)], (0, -1, 0), _TX)
    # +Z / -Z walls (tangent +Y)
    quad([(1, 1, 1), (-1, 1, 1), (1, -1, 1), (-1, -1, 1)], (0, 0, 1), _TY)
    quad([(1, 1, -1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1)], (0, 0, -1), _TY)
    return _soup(rows)


PRIMITIVES = {
    "plane": plane_y,
    "tri": trig_y,
    "cube": cube,
}
