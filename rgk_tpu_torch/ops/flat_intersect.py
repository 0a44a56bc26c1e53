"""Flat-sweep ray-triangle intersection: the CUDA kernel and its plain
version (port of rgk_tpu/ops/pallas_intersect.py, kernel K1).

`intersect_flat` returns, for each ray, the closest hit (min t, then
min id) or any hit against every Badouel row of `tri_pack` [M, 13],
honouring the (t_min, t_max) window and the `exclude` id and skipping
thin-glass rows (col 12 > 0.5).  Any-hit returns K1's witness: tri 0
when a hit exists, else -1, with zero barycentrics.

* A CUDA tensor launches `csrc/flat_intersect.cu` (built at first use
  by `rgk_tpu_torch.kernels`), or raises.
* A CPU tensor takes `flat_plain`, the same function written as plain
  PyTorch: K1's elementwise formula over [r, M] planes, chunked over
  rays under a fixed byte budget.  The CPU tests run it, and the chip
  smoke test holds the kernel to it on the card.

`launches` counts kernel launches by variant; nothing else adds to it.
"""

from __future__ import annotations

import torch

BIG = 3.4e38
_PARALLEL_EPS = 1e-9
PACK_COLS = 13
# Bytes of [r, M] float planes the plain version keeps live per chunk.
PLAIN_CHUNK_BYTES = 512 << 20
_PLAIN_PLANES = 12

launches = {"closest": 0, "any": 0}


def _check(tri_pack, ro, rd, t_min, t_max, exclude):
    dev = ro.device
    for name, x, dtype, shape in (
            ("tri_pack", tri_pack, torch.float32, (None, PACK_COLS)),
            ("ro", ro, torch.float32, (None, 3)),
            ("rd", rd, torch.float32, (None, 3)),
            ("t_min", t_min, torch.float32, (None,)),
            ("t_max", t_max, torch.float32, (None,)),
            ("exclude", exclude, torch.int32, (None,))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != len(shape) or any(
                s is not None and x.shape[i] != s for i, s in enumerate(shape)):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "tri_pack" and x.shape[0] != ro.shape[0]:
            raise ValueError(f"{name} has {x.shape[0]} rows for "
                             f"{ro.shape[0]} rays")


def intersect_flat(tri_pack, ro, rd, t_min, t_max, exclude,
                   any_hit: bool = False):
    """-> (t f32 [R], tri i32 [R], bary_b f32 [R], bary_c f32 [R]).

    tri_pack f32 [M, 13]; ro, rd f32 [R, 3]; t_min, t_max f32 [R];
    exclude i32 [R] (-1 = none); all contiguous on one device."""
    _check(tri_pack, ro, rd, t_min, t_max, exclude)
    if ro.device.type == "cpu":
        return flat_plain(tri_pack, ro, rd, t_min, t_max, exclude, any_hit)
    if ro.device.type != "cuda":
        raise NotImplementedError(
            f"no flat-sweep kernel for device {ro.device}")
    return _launch(tri_pack, ro, rd, t_min, t_max, exclude, any_hit)


def _launch(tri_pack, ro, rd, t_min, t_max, exclude, any_hit):
    from .. import kernels

    lib = kernels.load()
    r, m = ro.shape[0], tri_pack.shape[0]
    dev = ro.device
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    bb = torch.empty(r, dtype=torch.float32, device=dev)
    bc = torch.empty(r, dtype=torch.float32, device=dev)
    if r == 0:
        return t, tri, bb, bc
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rgk_flat_intersect(
            tri_pack.data_ptr(), m, ro.data_ptr(), rd.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), exclude.data_ptr(), r,
            t.data_ptr(), tri.data_ptr(), bb.data_ptr(), bc.data_ptr(),
            int(any_hit), stream)
    kernels.check_launch(rc, "flat_intersect")
    launches["any" if any_hit else "closest"] += 1
    return t, tri, bb, bc


def flat_plain(tri_pack, ro, rd, t_min, t_max, exclude,
               any_hit: bool = False):
    """K1's function in plain PyTorch, on any device (see module doc)."""
    r, m = ro.shape[0], tri_pack.shape[0]
    dev = ro.device
    t_out = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    bb_out = torch.zeros(r, dtype=torch.float32, device=dev)
    bc_out = torch.zeros(r, dtype=torch.float32, device=dev)
    if r == 0 or m == 0:
        return t_out, tri_out, bb_out, bc_out

    (nx, ny, nz, d, b0, bvx, bvy, bvz, g0, gvx, gvy, gvz,
     glass) = tri_pack.unbind(1)                       # each [M]
    ids = torch.arange(m, dtype=torch.int32, device=dev)
    usable = ~(glass > 0.5)
    chunk = max(1, PLAIN_CHUNK_BYTES // (m * 4 * _PLAIN_PLANES))
    for s in range(0, r, chunk):
        e = min(r, s + chunk)
        ox, oy, oz = ro[s:e].unbind(1)
        dx, dy, dz = rd[s:e].unbind(1)
        ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
        dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]

        rddn = dx * nx + dy * ny + dz * nz                 # [r, M]
        rodn = ox * nx + oy * ny + oz * nz + d
        safe = torch.abs(rddn) > _PARALLEL_EPS
        t = -rodn / torch.where(safe, rddn, 1.0)
        beta = (b0 + ox * bvx + oy * bvy + oz * bvz
                + t * (dx * bvx + dy * bvy + dz * bvz))
        gamma = (g0 + ox * gvx + oy * gvy + oz * gvz
                 + t * (dx * gvx + dy * gvy + dz * gvz))
        ok = (safe & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
              & (t > t_min[s:e, None]) & (t < t_max[s:e, None]) & usable
              & (ids != exclude[s:e, None]))
        t_sel = torch.where(ok, t, BIG)
        if any_hit:
            best = t_sel.amin(dim=1)
            t_out[s:e] = best
            tri_out[s:e] = torch.where(best < BIG, 0, -1).to(torch.int32)
            continue
        # argmin returns the first minimal index: min t, then min id.
        idx = torch.argmin(t_sel, dim=1, keepdim=True)
        best = t_sel.gather(1, idx)[:, 0]
        found = best < BIG
        t_out[s:e] = best
        tri_out[s:e] = torch.where(found, idx[:, 0].to(torch.int32), -1)
        bb_out[s:e] = torch.where(found, beta.gather(1, idx)[:, 0], 0.0)
        bc_out[s:e] = torch.where(found, gamma.gather(1, idx)[:, 0], 0.0)
    return t_out, tri_out, bb_out, bc_out
