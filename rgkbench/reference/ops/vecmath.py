"""Batched 3-vector math for wavefronts of rays (the plain reference's
copy).

The 3-vector functions take tensors shaped ``[..., 3]``.  `take` and
`take_rows` are plain indexing: a row id outside [0, M) of a table of
at most `MATMUL_GATHER_MAX_ROWS` rows gives a zero row, as the one-hot
contraction of the renderer's definition does, and autograd gives the
table's gradient as the per-row sum of the rows' gradients.
"""

from __future__ import annotations

import torch

EPS = 1e-20
# Tables with at most this many rows take the one-hot route in the
# reference (rgk_tpu/ops/vecmath.py), and K5 here.
MATMUL_GATHER_MAX_ROWS = 1024

def take(table, idx):
    """`table[idx]`."""
    return table[idx]


def take_rows(table2d, idx):
    """Rows of the [M, K] `table2d` at `idx` (any shape): ->
    idx.shape + (K,); a zero row for an id outside [0, M) when
    0 < M <= MATMUL_GATHER_MAX_ROWS, plain indexing above.  A table
    under autograd is gathered from a float64 copy, so that its
    gradient, a sum over every lane, adds in float64 (the same rows)."""
    m, k = table2d.shape
    src = table2d.double() if table2d.requires_grad else table2d
    if not 0 < m <= MATMUL_GATHER_MAX_ROWS:
        return src[idx.long()].to(table2d.dtype)
    flat = idx.reshape(-1).long()
    ok = (flat >= 0) & (flat < m)
    rows = src[torch.where(ok, flat, 0)].masked_fill(~ok[:, None], 0)
    rows = rows.to(table2d.dtype)
    return rows if idx.dim() == 1 else rows.reshape(*idx.shape, k)


def dot(a, b, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v, keepdim: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=EPS))


def length2(v, keepdim: bool = False):
    return dot(v, v, keepdim=keepdim)


def distance2(a, b):
    d = a - b
    return dot(d, d)


def normalize(v):
    return v / length(v, keepdim=True)


def safe_normalize(v, fallback=None):
    """Normalize; lanes with ~zero length get `fallback` (default +Z)."""
    l2 = dot(v, v, keepdim=True)
    ok = l2 > 1e-24
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(l2, min=1e-24)), 0.0)
    out = v * inv
    if fallback is None:
        fallback = torch.zeros_like(v)
        fallback[..., 2] = 1.0
    return torch.where(ok, out, fallback)


def reflect_z(v):
    """Mirror reflection about the local +Z axis: (x,y,z) -> (-x,-y,z)."""
    # Stacked on the device, not multiplied by a tensor from a Python
    # list: that would be a host-to-device copy, a sync that a CUDA-graph
    # capture refuses.  Negation is exact, as the product by -1 is.
    return torch.stack([-v[..., 0], -v[..., 1], v[..., 2]], dim=-1)


def build_onb(n):
    """Branchless orthonormal basis (t, b) around unit normal `n`
    (Duff et al. 2017), as in the reference."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def to_local(n, t, b, v):
    """World -> local shading frame (+Z = n)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_global(n, t, b, v):
    """Local shading frame -> world."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def rotation_from_y(dest, v):
    """Rotate `v` by the rotation that takes +Y to the unit `dest`: the
    reference's quaternion shortcut in branchless Rodrigues form, with
    the unnormalized axis cross(+Y, dest) = (d.z, 0, -d.x)."""
    c = dest[..., 1:2]  # cos(theta) = dot(+Y, dest)
    ax = dest[..., 2:3]
    az = -dest[..., 0:1]
    s2 = ax * ax + az * az
    safe = s2 > 1e-12
    k = torch.where(safe, (1.0 - c) / torch.clamp(s2, min=1e-12), 0.0)
    vx, vy, vz = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    adotv = ax * vx + az * vz
    rot = torch.cat([vx * c + (-az * vy) + ax * adotv * k,
                     vy * c + (az * vx - ax * vz),
                     vz * c + ax * vy + az * adotv * k], dim=-1)
    # dest ~ -Y: a half turn about +X, (x, -y, -z).
    flip = torch.cat([vx, -vy, -vz], dim=-1)
    return torch.where(safe, rot, torch.where(c > 0.0, v, flip))
