"""Batched 3-vector math for wavefronts of rays (port of
rgk_tpu/ops/vecmath.py).

The 3-vector functions take tensors shaped ``[..., 3]``.

`take` and `take_rows` are the reference's gathers.  `take`'s
optimization barrier is the TPU's alone, so here it is `table[idx]`.
`take_rows` keeps the reference's dispatch by the table's row count:
a table of at most `MATMUL_GATHER_MAX_ROWS` rows, which the reference
fetches as a one-hot contraction differentiable in the table, goes
through kernel K5 (`csrc/take_rows.cu`, built at first use by
`rgk_tpu_torch.kernels`) on a CUDA tensor, or through its plain
version `take_rows_plain` / `take_rows_backward_plain` on a CPU tensor;
the table's gradient is the per-row sum of the rows' gradients, the
contraction's transpose, summed in a fixed order.  A larger table is
plain indexing, the reference's fallback gather.  `launches` counts
K5's launches ("forward", and "backward" for its two-kernel backward);
nothing else adds to it.
"""

from __future__ import annotations

from functools import lru_cache

import torch
from torch.autograd.function import once_differentiable

EPS = 1e-20
# Tables with at most this many rows take the one-hot route in the
# reference (rgk_tpu/ops/vecmath.py), and K5 here.
MATMUL_GATHER_MAX_ROWS = 1024

launches = {"forward": 0, "backward": 0}


def take(table, idx):
    """`table[idx]`: the reference's `take` without its TPU barrier."""
    return table[idx]


def take_rows(table2d, idx):
    """Rows of the [M, K] `table2d` at `idx` (any shape): ->
    idx.shape + (K,).

    For 0 < M <= MATMUL_GATHER_MAX_ROWS (the reference's one-hot
    route) the rows come from K5 on a CUDA tensor (float32 or int32
    tables; another type raises) or from `take_rows_plain` on a CPU
    tensor, bit for bit the table's; an id outside [0, M) gives a zero
    row, as the one-hot product does.  With the table under autograd,
    its gradient is `take_rows_backward`'s per-row sum.  Larger tables
    are indexed directly, the reference's fallback gather.  Nothing
    here syncs."""
    m, k = table2d.shape
    if not 0 < m <= MATMUL_GATHER_MAX_ROWS:
        return table2d[idx.long()]
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    table2d = table2d.contiguous()
    if torch.is_grad_enabled() and table2d.requires_grad:
        rows = _TakeRows.apply(table2d, flat)
    else:
        rows = _fetch(table2d, flat)
    return rows if idx.dim() == 1 else rows.reshape(*idx.shape, k)


class _TakeRows(torch.autograd.Function):
    """K5's pair under autograd: saves the ids only, returns no
    gradient for them."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return _fetch(table, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return take_rows_backward(g.contiguous(), idx, ctx.rows), None


def _fetch(table, idx):
    if table.device != idx.device:
        raise ValueError(f"ids on {idx.device}, table on {table.device}")
    if table.device.type == "cpu":
        return take_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise RuntimeError(f"no take_rows kernel for device {table.device}")
    return _launch_forward(table, idx)


def take_rows_backward(g, idx, m):
    """The table's gradient from the rows' gradient `g` [R, K] float32
    and the int32 ids [R]: [m, K], row j the sum of g's rows whose id is
    j (ids outside [0, m) add nothing).  K5 on a CUDA tensor, summing in
    an order fixed by R, m, K, the ids and whether `g` is 16-byte
    aligned, so two runs agree bit for bit; `take_rows_backward_plain`
    on a CPU tensor."""
    if g.device.type == "cpu":
        return take_rows_backward_plain(g, idx, m)
    if g.device.type != "cuda":
        raise RuntimeError(f"no take_rows kernel for device {g.device}")
    return _launch_backward(g, idx, m)


def take_rows_plain(table, idx):
    """K5's forward in plain PyTorch: `table[idx]`, a zero row where an
    id lies outside [0, M)."""
    ok = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.where(ok, idx, 0).long()]
    return rows.masked_fill(~ok[:, None], 0)


def take_rows_backward_plain(g, idx, m):
    """K5's backward in plain PyTorch: `index_add_` into zeros, which on
    the CPU adds in lane order."""
    ok = (idx >= 0) & (idx < m)
    out = torch.zeros((m, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx[ok].long(), g[ok])


def _check_ids(idx, r, dev):
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] != r \
            or idx.device != dev or not idx.is_contiguous():
        raise ValueError(f"ids must be contiguous int32 [{r}] on {dev}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")


def _launch_forward(table, idx):
    from .. import kernels

    if table.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"K5 fetches float32 or int32 rows, got "
                        f"{table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("the table must be a contiguous 2-D tensor")
    m, k = table.shape
    r = idx.shape[0]
    _check_ids(idx, r, table.device)
    out = torch.empty((r, k), dtype=table.dtype, device=table.device)
    if r == 0 or k == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.rgk_take_rows(table.data_ptr(), m, k, idx.data_ptr(), r,
                               out.data_ptr(), stream)
    kernels.check_launch(rc, "take_rows")
    launches["forward"] += 1
    return out


def _launch_backward(g, idx, m):
    from .. import kernels

    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"K5's backward takes a contiguous float32 [R, K] "
                         f"gradient, got {g.dtype} {tuple(g.shape)}")
    if not 0 < m <= MATMUL_GATHER_MAX_ROWS:
        raise ValueError(f"K5's backward takes at most "
                         f"{MATMUL_GATHER_MAX_ROWS} rows, got {m}")
    r, k = g.shape
    dev = g.device
    _check_ids(idx, r, dev)
    if r == 0 or k == 0:
        return torch.zeros((m, k), dtype=torch.float32, device=dev)
    lib = kernels.load()
    need = lib.rgk_take_rows_backward_smem(m, k)
    have = _smem_optin(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    if need > have:
        raise ValueError(f"K5's backward needs {need} bytes of shared "
                         f"memory for a [{m}, {k}] table; the card opts in "
                         f"to {have}")
    partials = torch.empty((lib.rgk_take_rows_partials(r), m, k),
                           dtype=torch.float32, device=dev)
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rgk_take_rows_backward(g.data_ptr(), idx.data_ptr(), r, m,
                                        k, partials.data_ptr(),
                                        out.data_ptr(), stream)
    kernels.check_launch(rc, "take_rows backward")
    launches["backward"] += 1
    return out


@lru_cache(maxsize=None)
def _smem_optin(device_index):
    from .. import kernels

    got = kernels.load().rgk_device_smem_optin(device_index)
    if got < 0:
        kernels.check_launch(-got, "shared-memory query")
    return got


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
