"""Sample warping: [0,1)^2 -> discs, hemispheres, spheres, triangles
(port of rgk_tpu/ops/warps.py).
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def _sqrt_at_zero(x):
    """sqrt(x) for x >= 0, bit for bit (sqrt(+-0) = +-0), whose gradient
    at 0 is 1 instead of infinite.  A sample rescaled by a parameter
    (the lobe choice's `decide_and_rescale`) reaches 0 exactly on some
    lanes; where that lane's lobe is dropped its gradient is 0, and
    0 x inf = NaN would reach the parameter."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), x)


def to_disc_uniform(sample):
    """[..., 2] -> uniform unit disc, in the reference's (sin, cos) order."""
    r = _sqrt_at_zero(sample[..., 0])
    a = sample[..., 1] * TWO_PI
    return torch.stack([r * torch.sin(a), r * torch.cos(a)], dim=-1)


def to_hemisphere_cosine_z(sample):
    """Cosine-weighted hemisphere with z > 0."""
    p = to_disc_uniform(sample)
    z = torch.sqrt(torch.clamp(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2,
                               min=1e-5))
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def to_sphere_uniform(sample):
    """Uniform unit sphere."""
    z = sample[..., 0] * 2.0 - 1.0
    a = sample[..., 1] * TWO_PI
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(a), r * torch.sin(a), z], dim=-1)


def to_triangle_uniform(sample, a, b, c):
    """Uniform point on triangle (a, b, c) by the parallelogram fold,
    with the reference's vertex roles (edges taken from vertex b)."""
    rx = sample[..., 0:1]
    ry = sample[..., 1:2]
    flip = (rx + ry) > 1.0
    rx = torch.where(flip, 1.0 - rx, rx)
    ry = torch.where(flip, 1.0 - ry, ry)
    return b + rx * (a - b) + ry * (c - b)


def decide_and_rescale(sample, probability):
    """Stochastically split a 1-D sample.  Returns (took_first_branch,
    rescaled_sample), the rescaled sample uniform on [0,1) given the
    branch."""
    p = probability
    take = sample < p
    denom_t = torch.clamp(p, min=1e-12)
    denom_f = torch.clamp(1.0 - p, min=1e-12)
    rescaled = torch.where(take, sample / denom_t, (sample - p) / denom_f)
    take = take & ~(p <= 0.0)
    take = take | (p >= 1.0)
    return take, torch.clamp(rescaled, 0.0, 1.0 - 1e-7)
