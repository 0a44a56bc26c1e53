"""Texture sampling over the flat atlas (port of rgk_tpu/ops/textures.py):
bilinear with repeat-wrap and half-texel offset, bump-map slopes, and
the lat-long sky lookup.  Each lane may address a different texture.

A texel fetch is `_Gather`: plain indexing, whose backward adds into a
zero table what plain indexing's backward adds, stamped as the step's
`tex_bwd_ns` (`graph_while.grad_phase`).  Where no input takes a
gradient (a render) autograd records nothing, so the ops are plain
indexing's.  In a gradient step a colour lookup adds its textured lanes
to the step's `tex_fetches`.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from . import graph_while as gw


def _wrap01(x):
    return x - torch.floor(x)


class _Gather(torch.autograd.Function):
    """`texels[idx]` whose backward adds each lane's gradient into its
    texel of a zero table, in lane order, as plain indexing's backward
    does (its `_index_put_impl_` with `unsafe`, which reads nothing back
    on the host: `index_put_`'s range check would sync), inside the
    gradient step's `tex_bwd_ns` phase.

    A lane whose gradient is 0 (an untextured lane, whose lookup
    `torch.where` discards; a lane that missed or ended) adds its row to
    a spare row of its own past the table, which is dropped: the sums
    are plain indexing's bit for bit (adding +-0.0 to a sum that starts
    at +0.0 leaves it alone), and those lanes, which all fetch the same
    few texels, no longer pile onto them in one serial run of the
    sort-based accumulate."""

    @staticmethod
    def forward(ctx, texels, idx):
        ctx.save_for_backward(idx)
        ctx.table = texels.shape
        return texels[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        n = ctx.table[0]
        with gw.grad_phase("tex_bwd_ns"):
            spare = n + torch.arange(idx.numel(), device=idx.device)
            rows = torch.where((g != 0).any(dim=-1), idx,
                               spare.reshape(idx.shape))
            table = g.new_zeros((n + idx.numel(), *ctx.table[1:]))
            torch.ops.aten._index_put_impl_(table, (rows,), g, True, True)
        return table[:n], None


def _fetch(texels, offset, w, h, ix, iy):
    ix = torch.minimum(torch.clamp(ix, min=0), w - 1)
    iy = torch.minimum(torch.clamp(iy, min=0), h - 1)
    return _Gather.apply(texels, (offset + iy * w + ix).long())


def _desc(atlas, tex_id):
    desc = atlas.desc[torch.clamp(tex_id, min=0).long()]
    return desc[..., 0], desc[..., 1], desc[..., 2]


def sample_bilinear(atlas, tex_id, uv):
    """Bilinear fetch; tex_id int [...] (>= 0), uv f32 [...,2]: u wraps,
    pixel centers at (i+0.5)/size, edge rows clamped."""
    offset, w, h = _desc(atlas, tex_id)
    x = _wrap01(uv[..., 0]) * w.to(torch.float32) - 0.5
    y = _wrap01(uv[..., 1]) * h.to(torch.float32) - 0.5
    ix0 = torch.floor(x).to(torch.int32)
    iy0 = torch.floor(y).to(torch.int32)
    fx = x - ix0.to(torch.float32)
    fy = y - iy0.to(torch.float32)
    ix1 = torch.where(ix0 != w - 1, ix0 + 1, ix0)
    iy1 = torch.where(iy0 != h - 1, iy0 + 1, iy0)
    ix0 = torch.clamp(ix0, min=0)
    iy0 = torch.clamp(iy0, min=0)
    c00 = _fetch(atlas.texels, offset, w, h, ix0, iy0)
    c01 = _fetch(atlas.texels, offset, w, h, ix1, iy0)
    c10 = _fetch(atlas.texels, offset, w, h, ix0, iy1)
    c11 = _fetch(atlas.texels, offset, w, h, ix1, iy1)
    fx = fx[..., None]
    fy = fy[..., None]
    c0 = c00 * (1.0 - fx) + c01 * fx
    c1 = c10 * (1.0 - fx) + c11 * fx
    return c0 * (1.0 - fy) + c1 * fy


def resolve_color(atlas, tex_id, solid_color, uv):
    """Texture when tex_id >= 0, else the solid color."""
    textured = tex_id >= 0
    if gw.grad_probe is not None and atlas.texels.requires_grad:
        gw.grad_probe.add("tex_fetches", textured.sum())
    tex = sample_bilinear(atlas, tex_id, uv)
    return torch.where(textured[..., None], tex, solid_color)


def bump_slopes(atlas, tex_id, uv):
    """(slope_right, slope_bottom): nearest-neighbor luma differences,
    here minus the next texel right / down."""
    offset, w, h = _desc(atlas, tex_id)
    x = _wrap01(uv[..., 0]) * w.to(torch.float32) - 0.5
    y = _wrap01(uv[..., 1]) * h.to(torch.float32) - 0.5
    # The reference truncates toward zero, then clamps -1 -> 0.
    ix = x.to(torch.int32)
    iy = y.to(torch.int32)
    ix2 = torch.where(ix != w - 1, ix + 1, ix)
    iy2 = torch.where(iy != h - 1, iy + 1, iy)
    ix = torch.clamp(ix, min=0)
    iy = torch.clamp(iy, min=0)

    def luma(c):
        return (c[..., 0] + c[..., 1] + c[..., 2]) / 3.0

    here = luma(_fetch(atlas.texels, offset, w, h, ix, iy))
    right = luma(_fetch(atlas.texels, offset, w, h, ix2, iy))
    down = luma(_fetch(atlas.texels, offset, w, h, ix, iy2))
    return here - right, here - down


def sky_radiance(scene, direction, has_envmap=True):
    """Sky radiance toward direction [...,3]: the constant color, or
    the lat-long envmap rotated about Y by `sky_rotate` degrees.  The
    caller passes -ray_direction, as the reference does."""
    const = scene.sky_color * scene.sky_intensity
    if not has_envmap:
        return const.expand(direction.shape)
    # arcsin(s) in the form XLA lowers jnp.arcsin to,
    # 2 * atan2(s, 1 + sqrt(1 - s^2)), so envmap lookups match the
    # reference's to the last bits.
    s = torch.clamp(direction[..., 1], -1.0, 1.0)
    alpha = 2.0 * torch.atan2(s, 1.0 + torch.sqrt((1.0 - s) * (1.0 + s)))
    beta = -torch.atan2(direction[..., 0], direction[..., 2])
    beta = beta + scene.sky_rotate * 0.0174533
    x = beta / (2.0 * math.pi) + 0.5
    y = alpha / math.pi + 0.5
    uv = torch.stack([x, y], dim=-1)
    tex_id = scene.sky_tex.expand(direction.shape[:-1])
    env = sample_bilinear(scene.textures, torch.clamp(tex_id, min=0), uv)
    env = env * scene.sky_intensity
    return torch.where(scene.sky_tex >= 0, env, const.expand(env.shape))
