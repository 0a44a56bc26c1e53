"""Linearly Transformed Cosines: table fetch, PDF eval, sampling
(port of rgk_tpu/ops/ltc.py).

Reads the 64x64 fitted tables from the port's own byte copy of the
reference's `rgk_tpu/data/ltc_tables.npz`, `rgk_tpu_torch/data/`, with
numpy.  All vectors are in the local shading frame (+Z normal).
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import vecmath as vm

_SIZE = 64
_HALF_PI = 0.5 * 3.14159  # the reference's value, not pi/2

KIND_BECKMANN = 0
KIND_GGX = 1


class LTCTables(NamedTuple):
    """Rows kind*4096 + theta*64 + alpha, each (M.flatten(9), amp)."""
    rows: torch.Tensor  # f32 [2*64*64, 10]


@lru_cache(maxsize=1)
def load_tables_np() -> np.ndarray:
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "ltc_tables.npz")
    d = np.load(path)
    m = np.stack([d["beckmann_m"], d["ggx_m"]]).astype(np.float32)
    amp = np.stack([d["beckmann_amp"], d["ggx_amp"]]).astype(np.float32)
    rows = np.concatenate([m.reshape(-1, 9), amp.reshape(-1, 1)], axis=1)
    rows.flags.writeable = False  # shared by every caller of the cache
    return rows


def fetch_bilinear(tables: LTCTables, kind, theta, alpha):
    """Bilinearly interpolated (M [...,3,3], amplitude [...]), with the
    reference's 0.999 clamps."""
    t = torch.clamp(theta / _HALF_PI, 0.0, 1.0)
    a = torch.clamp(torch.sqrt(torch.clamp(alpha, min=0.0)), 0.0, 1.0)
    t = torch.clamp(t, max=0.999)
    a = torch.clamp(a, max=0.999)
    s = _SIZE - 1
    t1 = torch.floor(t * s).to(torch.int32)
    a1 = torch.floor(a * s).to(torch.int32)
    dt1 = t * s - t1.to(torch.float32)
    dt2 = 1.0 - dt1
    da1 = a * s - a1.to(torch.float32)
    da2 = 1.0 - da1

    base = (kind * (_SIZE * _SIZE) + t1 * _SIZE + a1).long()
    rows = tables.rows
    r11 = rows[base]
    r12 = rows[base + 1]
    r21 = rows[base + _SIZE]
    r22 = rows[base + _SIZE + 1]
    w11 = (dt2 * da2)[..., None]
    w12 = (dt2 * da1)[..., None]
    w21 = (dt1 * da2)[..., None]
    w22 = (dt1 * da1)[..., None]
    blended = r11 * w11 + r12 * w12 + r21 * w21 + r22 * w22
    M = blended[..., 0:9].reshape(*blended.shape[:-1], 3, 3)
    return M, blended[..., 9]


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _inv3(M, det):
    """Adjugate-based batched 3x3 inverse."""
    c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
    c01 = M[..., 0, 2] * M[..., 2, 1] - M[..., 0, 1] * M[..., 2, 2]
    c02 = M[..., 0, 1] * M[..., 1, 2] - M[..., 0, 2] * M[..., 1, 1]
    c10 = M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2]
    c11 = M[..., 0, 0] * M[..., 2, 2] - M[..., 0, 2] * M[..., 2, 0]
    c12 = M[..., 0, 2] * M[..., 1, 0] - M[..., 0, 0] * M[..., 1, 2]
    c20 = M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]
    c21 = M[..., 0, 1] * M[..., 2, 0] - M[..., 0, 0] * M[..., 2, 1]
    c22 = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    adj = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c10, c11, c12], dim=-1),
        torch.stack([c20, c21, c22], dim=-1),
    ], dim=-2)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    return adj * inv_det[..., None, None]


def _matvec(M, v):
    # Written out: a batched matmul would sum in another order.
    return (M[..., 0] * v[..., 0:1] + M[..., 1] * v[..., 1:2]
            + M[..., 2] * v[..., 2:3])


def _frame_unrotate(v_frame, v):
    """Inverse of the reference's scaled (Vi_cast, tangent, N) frame:
    xy come out scaled by 1/sin^2(theta), as in the reference."""
    fx, fy = v_frame[..., 0], v_frame[..., 1]
    s2 = torch.clamp(fx * fx + fy * fy, min=1e-12)
    x = (fx * v[..., 0] + fy * v[..., 1]) / s2
    y = (-fy * v[..., 0] + fx * v[..., 1]) / s2
    return torch.stack([x, y, v[..., 2]], dim=-1)


def _frame_rotate(v_frame, v):
    """The forward scaled frame."""
    fx, fy = v_frame[..., 0], v_frame[..., 1]
    x = fx * v[..., 0] - fy * v[..., 1]
    y = fy * v[..., 0] + fx * v[..., 1]
    return torch.stack([x, y, v[..., 2]], dim=-1)


def _safe_arccos(z):
    return torch.arccos(torch.clamp(z, -1.0 + 1e-6, 1.0 - 1e-6))


def pdf(tables: LTCTables, kind, v_frame, v_eval, alpha):
    """LTC BRDF value: frame around `v_frame`, evaluated at `v_eval`
    (the reference builds it around the outgoing vector)."""
    theta = _safe_arccos(v_frame[..., 2])
    M, amp = fetch_bilinear(tables, kind, theta, alpha)
    vr3 = _frame_unrotate(v_frame, v_eval)
    det = _det3(M)
    q = _matvec(_inv3(M, det), vr3)
    p = vm.safe_normalize(q)
    L = _matvec(M, p)
    l2 = torch.sum(L * L, dim=-1)
    l3 = l2 * torch.sqrt(torch.clamp(l2, min=1e-30))
    jac = det / torch.clamp(l3, min=1e-30)
    D = torch.clamp(p[..., 2], min=0.0) / 3.14159
    return amp * D / torch.where(torch.abs(jac) > 1e-20, jac, 1e-20)


def sample(tables: LTCTables, kind, v_in, alpha, rand_hscos):
    """Outgoing direction: M @ cosine-hemisphere vector, z clamped,
    rotated into the frame around `v_in`; theta floored at pi/4."""
    theta = _safe_arccos(v_in[..., 2])
    theta = torch.clamp(theta, min=math.pi / 4.0)
    M, _ = fetch_bilinear(tables, kind, theta, alpha)
    s = _matvec(M, rand_hscos)
    s = torch.cat([s[..., 0:2], torch.clamp(s[..., 2:3], min=1e-4)], dim=-1)
    return vm.safe_normalize(_frame_rotate(v_in, s))
