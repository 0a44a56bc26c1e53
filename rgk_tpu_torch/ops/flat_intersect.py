"""Flat-sweep ray-triangle intersection: the CUDA kernel and its plain
version (port of rgk_tpu/ops/pallas_intersect.py, kernel K1).

`intersect_flat` returns, for each ray, the closest hit (min t, then
min id) or any hit against every Badouel row of `tri_pack` [M, 13],
honouring the (t_min, t_max) window and the `exclude` id and skipping
thin-glass rows (col 12 > 0.5).  Any-hit returns K1's witness: tri 0
when a hit exists, else -1, with zero barycentrics, and the t of the
lowest accepted id.  A ray whose window is empty (not t_min < t_max)
gets the no-hit record (t BIG, tri -1, barycentrics 0): the path
tracer hands its dead lanes and inactive shadow rays such a window, and
K1 sweeps only the others.

* A CUDA tensor launches `csrc/flat_intersect.cu` (built at first use
  by `rgk_tpu_torch.kernels`), or raises: a front end that lists the
  rays with a non-empty window on the device, a sweep of that list that
  splits the rows over the card when the rays are few, and a pass that
  writes a split query's records.
* A CPU tensor takes `flat_plain`, the same function written as plain
  PyTorch: K1's elementwise formula over [r, M] planes, chunked over
  rays under a fixed byte budget.  The CPU tests run it, and the chip
  smoke test holds the kernel to it on the card.

`launches` counts queries launched by variant (each a memset and three
kernels); nothing else adds to it.  Inside `count_swept(into)` every
query adds the rays it sweeps (those with a non-empty window) into
`into` on the device: K1's front end counts them on the card,
`flat_plain`'s caller on the CPU.
"""

from __future__ import annotations

import contextlib
import threading

import torch

BIG = 3.4e38
_PARALLEL_EPS = 1e-9
PACK_COLS = 13
# Bytes of [r, M] float planes the plain version keeps live per chunk.
PLAIN_CHUNK_BYTES = 512 << 20
_PLAIN_PLANES = 12

launches = {"closest": 0, "any": 0}
# The counter of the innermost `count_swept` on this thread (the threads
# of a device mesh query concurrently).
_swept = threading.local()


def scratch_bytes(r: int) -> int:
    """A query's device scratch for r rays, as `csrc/flat_intersect.cu`
    lays it out: an 8-byte key and a 4-byte list entry a ray, then two
    int32 counters."""
    return 12 * r + 8


@contextlib.contextmanager
def count_swept(into):
    """Inside, each query adds the number of rays it sweeps into `into`,
    an int64 [1] tensor on the rays' device, without a sync (module
    doc)."""
    prev = getattr(_swept, "into", None)
    _swept.into = into
    try:
        yield
    finally:
        _swept.into = prev


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
    exclude i32 [R] (-1 = none); all contiguous on one device.

    Under autograd, with rays that carry a gradient, K1 sweeps the
    detached rays and a closest hit's record is recomputed from the
    winner's row, as `flat_plain` does: the card and the CPU
    differentiate the hit point along the ray alike."""
    _check(tri_pack, ro, rd, t_min, t_max, exclude)
    into = getattr(_swept, "into", None)
    if into is not None and (into.device != ro.device
                             or into.dtype != torch.int64
                             or into.shape != (1,)):
        raise ValueError(f"the swept-ray counter must be int64 [1] on "
                         f"{ro.device}, got {into.dtype} "
                         f"{tuple(into.shape)} on {into.device}")
    if ro.device.type == "cpu":
        if into is not None:
            into.add_((t_max > t_min).sum())
        return flat_plain(tri_pack, ro, rd, t_min, t_max, exclude, any_hit)
    if ro.device.type != "cuda":
        raise RuntimeError(
            f"no flat-sweep kernel for device {ro.device}")
    if _records_grad(ro, rd):
        return _recorded(_launch, tri_pack, ro, rd, t_min, t_max, exclude,
                         any_hit)
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
    # Freed after the launch: the stream orders its next use after it.
    scratch = torch.empty(scratch_bytes(r), dtype=torch.uint8, device=dev)
    into = getattr(_swept, "into", None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rgk_flat_intersect(
            tri_pack.data_ptr(), m, ro.data_ptr(), rd.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), exclude.data_ptr(), r,
            t.data_ptr(), tri.data_ptr(), bb.data_ptr(), bc.data_ptr(),
            int(any_hit), scratch.data_ptr(),
            None if into is None else into.data_ptr(), stream)
    kernels.check_launch(rc, "flat_intersect")
    launches["any" if any_hit else "closest"] += 1
    return t, tri, bb, bc


def flat_plain(tri_pack, ro, rd, t_min, t_max, exclude,
               any_hit: bool = False):
    """K1's function in plain PyTorch, on any device (see module doc).

    Under autograd, with rays that carry a gradient, the sweep runs
    without one and a closest hit's record is recomputed from the
    winner's row by the sweep's own expressions (the same values): the
    hit point is differentiated along the ray as the reference's
    `intersect_brute` does, and only [R] tensors are saved, not the
    [R, M] planes.  Any-hit results carry no gradient."""
    if _records_grad(ro, rd):
        return _recorded(flat_plain, tri_pack, ro, rd, t_min, t_max,
                         exclude, any_hit)
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
        if any_hit:
            # argmax returns the first maximal index: the lowest accepted
            # id, the row K1's ascending sweep accepts first.
            idx = torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True)
            found = ok.gather(1, idx)[:, 0]
            t_out[s:e] = torch.where(found, t.gather(1, idx)[:, 0], BIG)
            tri_out[s:e] = torch.where(found, 0, -1).to(torch.int32)
            continue
        t_sel = torch.where(ok, t, BIG)
        # argmin returns the first minimal index: min t, then min id.
        idx = torch.argmin(t_sel, dim=1, keepdim=True)
        best = t_sel.gather(1, idx)[:, 0]
        found = best < BIG
        t_out[s:e] = best
        tri_out[s:e] = torch.where(found, idx[:, 0].to(torch.int32), -1)
        bb_out[s:e] = torch.where(found, beta.gather(1, idx)[:, 0], 0.0)
        bc_out[s:e] = torch.where(found, gamma.gather(1, idx)[:, 0], 0.0)
    return t_out, tri_out, bb_out, bc_out


def _records_grad(ro, rd):
    return torch.is_grad_enabled() and (ro.requires_grad or rd.requires_grad)


def _recorded(sweep, tri_pack, ro, rd, t_min, t_max, exclude, any_hit):
    """`sweep` (K1's launch or `flat_plain`) on the detached rays, then a
    closest hit's record recomputed from the winner's row with the rays'
    gradient."""
    with torch.no_grad():
        hit = sweep(tri_pack, ro.detach(), rd.detach(), t_min, t_max,
                    exclude, any_hit)
    return hit if any_hit else _winner_record(tri_pack, ro, rd, *hit)


def _winner_record(tri_pack, ro, rd, t, tri, bary_b, bary_c):
    """(t, tri, bary_b, bary_c) of closest hits, t and the barycentrics
    recomputed in torch ops from the winning rows, as `flat_plain`'s
    sweep computes them."""
    found = tri >= 0
    rows = tri_pack[torch.clamp(tri, min=0).long()]
    (nx, ny, nz, d, b0, bvx, bvy, bvz, g0, gvx, gvy, gvz,
     _) = rows.unbind(1)
    ox, oy, oz = ro.unbind(1)
    dx, dy, dz = rd.unbind(1)
    rddn = dx * nx + dy * ny + dz * nz
    rodn = ox * nx + oy * ny + oz * nz + d
    safe = torch.abs(rddn) > _PARALLEL_EPS
    tw = -rodn / torch.where(safe, rddn, 1.0)
    beta = (b0 + ox * bvx + oy * bvy + oz * bvz
            + tw * (dx * bvx + dy * bvy + dz * bvz))
    gamma = (g0 + ox * gvx + oy * gvy + oz * gvz
             + tw * (dx * gvx + dy * gvy + dz * gvz))
    return (torch.where(found, tw, t), tri, torch.where(found, beta, bary_b),
            torch.where(found, gamma, bary_c))
