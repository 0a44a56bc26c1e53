"""Procedural meshes of the benchmark's scenes, frozen copies of
`tools/make_bigscene.py`'s mesh functions and of its stone texture as
the texture loader decodes its PNG (gamma-decoded 8-bit sRGB), so that
the benchmark's inputs do not move when the tools do.
"""

from __future__ import annotations

import numpy as np

from .reference.io.texture_io import gamma_decode


def _write_obj(path: str, verts: np.ndarray, normals: np.ndarray,
               faces: np.ndarray, uvs: np.ndarray = None) -> None:
    """v//vn (or v/vt/vn) OBJ, vectorized formatting (1M faces ~2 s)."""
    with open(path, "w") as f:
        f.write(f"# generated by rgkbench: {len(faces)} tris\n")
        np.savetxt(f, verts, fmt="v %.6f %.6f %.6f")
        if uvs is not None:
            np.savetxt(f, uvs, fmt="vt %.6f %.6f")
        np.savetxt(f, normals, fmt="vn %.5f %.5f %.5f")
        ff = faces + 1  # OBJ is 1-based; vt/vn index == v index here
        if uvs is not None:
            np.savetxt(f, np.repeat(ff, 3, axis=1),
                       fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
        else:
            np.savetxt(f, np.repeat(ff, 2, axis=1),
                       fmt="f %d//%d %d//%d %d//%d")


def make_panels():
    """Emissive quads hung between column pairs: areal lights with
    real area at scene scale, so areal NEE runs in the flagship
    benchmark (the reference's sponza regime has large lights)."""
    quads = []
    for z in (-12.0, 0.0, 12.0):
        for x, nx in ((-3.15, 1.0), (3.15, -1.0)):
            y0, y1 = 4.2, 5.2
            z0, z1 = z - 0.8, z + 0.8
            v = np.array([[x, y0, z0], [x, y0, z1],
                          [x, y1, z1], [x, y1, z0]], np.float32)
            nrm = np.tile(np.array([[nx, 0.0, 0.0]], np.float32),
                          (4, 1))
            f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
            quads.append((v, nrm, f))
    return _merge(quads)


def _grid_faces(nu: int, nv: int, wrap_u: bool = False) -> np.ndarray:
    """Triangulate a (nu x nv) vertex grid into 2*(nu-1|nu)*(nv-1) tris."""
    iu = np.arange(nu if wrap_u else nu - 1)
    iv = np.arange(nv - 1)
    U, V = np.meshgrid(iu, iv, indexing="ij")
    a = V * nu + U
    b = V * nu + (U + 1) % nu if wrap_u else V * nu + U + 1
    c = a + nu
    d = b + nu
    t1 = np.stack([a, b, d], axis=-1).reshape(-1, 3)
    t2 = np.stack([a, d, c], axis=-1).reshape(-1, 3)
    return np.concatenate([t1, t2]).astype(np.int64)


def make_ground(n: int):
    """Rippled stone floor over [-8, 8] x [-20, 20]."""
    x = np.linspace(-8, 8, n)
    z = np.linspace(-20, 20, int(n * 2.5))
    X, Z = np.meshgrid(x, z, indexing="ij")
    Y = (0.05 * np.sin(1.7 * X) * np.cos(1.3 * Z)
         + 0.02 * np.sin(7.1 * X + 2.0) * np.sin(5.3 * Z + 1.0))
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    # Analytic normals from the height function's gradient.
    dYdX = (0.05 * 1.7 * np.cos(1.7 * X) * np.cos(1.3 * Z)
            + 0.02 * 7.1 * np.cos(7.1 * X + 2.0) * np.sin(5.3 * Z + 1.0))
    dYdZ = (-0.05 * 1.3 * np.sin(1.7 * X) * np.sin(1.3 * Z)
            + 0.02 * 5.3 * np.sin(7.1 * X + 2.0) * np.cos(5.3 * Z + 1.0))
    nrm = np.stack([-dYdX, np.ones_like(Y), -dYdZ], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    faces = _grid_faces(z.size, x.size)  # grid is [x-major rows of z]
    # verts reshaped x-major: index = ix * nz + iz -> grid (nz, nx)
    uvs = np.stack([(X + 8.0) / 4.0, (Z + 20.0) / 4.0],
                   axis=-1).reshape(-1, 2)  # repeat-wrapped tiles
    return (verts.astype(np.float32), nrm.astype(np.float32), faces,
            uvs.astype(np.float32))


def make_column(ntheta: int, nh: int, cx: float, cz: float):
    """One fluted, tapered column (closed side surface only)."""
    th = np.linspace(0, 2 * np.pi, ntheta, endpoint=False)
    y = np.linspace(0.0, 6.0, nh)
    T, Y = np.meshgrid(th, y, indexing="xy")          # [nh, ntheta]
    taper = 1.0 - 0.12 * (Y / 6.0)
    r = 0.55 * taper * (1.0 + 0.06 * np.sin(16 * T) + 0.015 * np.sin(3 * Y))
    X = cx + r * np.cos(T)
    Z = cz + r * np.sin(T)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    # Normals: numerical-free radial approximation with fluting slope.
    drdT = 0.55 * taper * (0.06 * 16 * np.cos(16 * T))
    nx = np.cos(T) + (drdT / np.maximum(r, 1e-6)) * np.sin(T)
    nz = np.sin(T) - (drdT / np.maximum(r, 1e-6)) * np.cos(T)
    ny = 0.12 / 6.0 * 0.55 * np.ones_like(nx)  # taper tilt
    nrm = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    faces = _grid_faces(ntheta, nh, wrap_u=True)
    return verts.astype(np.float32), nrm.astype(np.float32), faces


def make_sphere(n_tris: int, cx: float, cy: float, cz: float, rad: float):
    nv = max(3, int(np.sqrt(n_tris / 4)))
    nu = max(3, n_tris // (2 * nv))
    th = np.linspace(0, np.pi, nv + 1)
    ph = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(T) * np.cos(P), np.cos(T),
                  np.sin(T) * np.sin(P)], axis=-1).reshape(-1, 3)
    verts = (np.array([cx, cy, cz]) + rad * n).astype(np.float32)
    faces = _grid_faces(nu, nv + 1, wrap_u=True)
    return verts, n.astype(np.float32), faces


def _merge(parts):
    verts, nrms, faces = [], [], []
    off = 0
    for v, n, f in parts:
        verts.append(v)
        nrms.append(n)
        faces.append(f + off)
        off += len(v)
    return (np.concatenate(verts), np.concatenate(nrms),
            np.concatenate(faces))


def stone_texture(n: int = 512) -> np.ndarray:
    """The colonnade's stone-tile diffuse texture, linear float32 [n, n,
    3]: value-noise octaves and a mortar grid, seeded with 7."""
    rng = np.random.default_rng(7)
    img = np.zeros((n, n))
    for octave in range(4):
        k = 8 << octave
        coarse = rng.standard_normal((k, k))
        img += np.kron(coarse, np.ones((n // k, n // k))) / (1.6 ** octave)
    img = (img - img.min()) / (img.max() - img.min())
    line = ((np.arange(n) % 64) < 3).astype(float)
    mortar = np.maximum(line[None, :], line[:, None])
    base = 0.45 + 0.35 * img
    rgb = np.stack([base * 1.02, base * 0.98, base * 0.92], axis=-1)
    rgb = rgb * (1.0 - 0.45 * mortar[..., None])
    u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return gamma_decode(u8.astype(np.float32) / 255.0)
