"""Cluster-BVH ray intersection for scenes above 4096 triangles: the
CUDA kernel K2, its plain version and the front end around them (port
of rgk_tpu/ops/pallas_cluster.py).

`intersect_clusters` is the front end the integrator calls on the
card.  It sorts the rays by the reference's coherence key
(`ray_sort_key`; lanes with an empty interval last), gathers them in
that order (ids as int32), runs `traverse`,
scatters the result back to the caller's order and, for closest hits,
recomputes t and the barycentrics from the winner's `tri_pack` row
exactly as the reference does.

`traverse` is the kernel's wrapper: for each ray the closest hit
(min t, then min id, whatever order the chunks are met in) or any hit
against the chunk tree of `ClusterArrays`, honouring (t_min, t_max) and
`exclude`.  Any hit returns the witness tri 0 (else -1).  With
`stats=True` it also returns, per ray, the nodes slab-tested and the
leaf chunks swept.
* A CUDA tensor launches `csrc/cluster_intersect.cu` (built at first
  use by `rgk_tpu_torch.kernels`), or raises.
* A CPU tensor takes `cluster_plain`: the same function as plain
  PyTorch, a per-lane stackless walk through the lane's own octant's
  links, the dequantized u16 slab test and the shared-hit-point
  Badouel sweep of the leaf chunk's 64*chunk_halves rows.  The tests
  run it on the CPU; the chip smoke test holds the kernel to it on the
  card, where it runs too.

`launches` counts kernel launches by variant; nothing else adds to it.
"""

from __future__ import annotations

import torch

from ..scene.clusters import HALF

BIG = 3.4e38
_INT_MAX = 0x7FFFFFFF
# Elements of a [lanes, rows] plane the plain sweep keeps live per chunk.
PLAIN_SWEEP_ELEMS = 1 << 22

launches = {"closest": 0, "any": 0}


# ---------------------------------------------------------------- front end

def _spread3(x):
    """Spread 8 bits so consecutive bits land 3 apart (Morton)."""
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton3(q):
    """[R, 3] int coords (<= 8 bits each) -> interleaved Morton code."""
    return (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))


def _octant(rd):
    """Direction octant: bit a set = negative along axis a."""
    return ((rd[:, 0] < 0).to(torch.int32)
            + 2 * (rd[:, 1] < 0).to(torch.int32)
            + 4 * (rd[:, 2] < 0).to(torch.int32))


def ray_sort_key(cl, ro, rd):
    """Coherence key, int32: direction octant (top 3 bits), a 5-bit/axis
    Morton code of the origin inside the scene box, then a 4-bit/axis
    Morton code of the direction (the reference's `_ray_sort_key`,
    bitwise)."""
    lo = cl.scene_lo
    extent = cl.scene_step * 65535.0
    inv = 31.0 / torch.clamp(extent, min=1e-9)
    qo = torch.clamp((ro - lo) * inv, 0.0, 31.0).to(torch.int32)
    qd = torch.clamp((rd + 1.0) * 7.5, 0.0, 15.0).to(torch.int32)
    return (_octant(rd) << 27) | (_morton3(qo) << 12) | _morton3(qd)


def sort_rays(cl, ro, rd, t_min, t_max, exclude):
    """-> (perm, ro, rd, t_min, t_max, exclude), the rays gathered in
    coherence order (stable), so that neighbouring threads walk the
    same chunks.  Lanes with an empty interval go last, where their
    threads do not walk.  Ids are gathered as int32."""
    key = torch.where(t_max <= t_min, _INT_MAX, ray_sort_key(cl, ro, rd))
    perm = torch.argsort(key, stable=True)
    return (perm, *(x[perm].contiguous()
                    for x in (ro, rd, t_min, t_max, exclude)))


def intersect_clusters(cl, tri_pack, ro, rd, t_min, t_max, exclude,
                       any_hit: bool = False):
    """-> (t f32 [R], tri i32 [R], bary_b f32 [R], bary_c f32 [R]).

    cl: the scene's ClusterArrays; tri_pack f32 [M, 13]; ro, rd f32
    [R, 3]; t_min, t_max f32 [R] (t_min >= 0); exclude i32 [R] (-1 =
    none)."""
    perm, *sorted_rays = sort_rays(cl, ro, rd, t_min, t_max, exclude)
    t_s, idx_s = traverse(cl, *sorted_rays, any_hit=any_hit)
    t = torch.empty_like(t_s).index_copy_(0, perm, t_s)
    idx = torch.empty_like(idx_s).index_copy_(0, perm, idx_s)

    if any_hit:
        zeros = torch.zeros_like(t)
        return t, idx, zeros, zeros
    return hit_record(tri_pack, ro, rd, t, idx)


def hit_record(tri_pack, ro, rd, t, idx):
    """-> (t, tri, bary_b, bary_c) of closest hits (t, idx) from the
    kernel: t and the barycentrics recomputed from the winner's
    tri_pack row, exactly as the reference does (pallas_cluster.py:
    696-706), so the reported record does not carry the kernel's
    last-bit rounding."""
    found = idx >= 0
    rows = tri_pack[torch.clamp(idx, 0, tri_pack.shape[0] - 1).long()]
    rddn = torch.sum(rd * rows[:, 0:3], dim=-1)
    t_ex = -(torch.sum(ro * rows[:, 0:3], dim=-1) + rows[:, 3]) \
        / torch.where(torch.abs(rddn) > 1e-30, rddn, 1e-30)
    t = torch.where(found, t_ex, t)
    p = ro + t[:, None] * rd
    beta = rows[:, 4] + torch.sum(p * rows[:, 5:8], dim=-1)
    gamma = rows[:, 8] + torch.sum(p * rows[:, 9:12], dim=-1)
    return (t, idx, torch.where(found, beta, 0.0),
            torch.where(found, gamma, 0.0))


# ------------------------------------------------------------- the wrapper

def _check(cl, ro, rd, t_min, t_max, exclude=None):
    """Raises unless the tables and the rays are what the kernels take
    (`exclude` None: a wrapper that takes none)."""
    dev = ro.device
    r = ro.shape[0]
    for name, x, dtype, shape in (
            ("boxes_q", cl.boxes_q, torch.int32, (None,)),
            ("leaf_bits", cl.leaf_bits, torch.int32, (None,)),
            ("links", cl.links, torch.int32, (None, 128)),
            ("pack", cl.pack, torch.float32, (None, 128)),
            ("scene_lo", cl.scene_lo, torch.float32, (3,)),
            ("scene_step", cl.scene_step, torch.float32, (3,)),
            ("ro", ro, torch.float32, (r, 3)),
            ("rd", rd, torch.float32, (r, 3)),
            ("t_min", t_min, torch.float32, (r,)),
            ("t_max", t_max, torch.float32, (r,)),
            ("exclude", exclude, torch.int32, (r,))):
        if x is None and name == "exclude":
            continue
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
    n_nodes = cl.boxes_q.shape[0] // 3
    if cl.boxes_q.shape[0] != 3 * n_nodes or n_nodes >= 65536:
        raise ValueError(f"boxes_q of {cl.boxes_q.shape[0]} words")
    if cl.links.shape[0] % 8 or cl.links.shape[0] // 8 * 128 < n_nodes:
        raise ValueError(f"links of shape {tuple(cl.links.shape)} for "
                         f"{n_nodes} nodes")
    if cl.leaf_bits.shape[0] * 32 < n_nodes:
        raise ValueError("leaf_bits too short")
    if cl.pack.shape[0] % 16 or (cl.pack.shape[0] // 16 * 128) % (
            cl.chunk_halves * HALF):
        raise ValueError(f"pack of shape {tuple(cl.pack.shape)} is not "
                         f"whole chunks of {cl.chunk_halves * HALF}")


def traverse(cl, ro, rd, t_min, t_max, exclude, any_hit: bool = False,
             stats: bool = False):
    """-> (t f32 [R], tri i32 [R]) [+ (nodes i32 [R], leaves i32 [R])
    with stats].  All tensors contiguous on one device (module doc).

    The kernel's persistent warps take rays from one counter per device,
    reset on the current stream before each launch: two launches on one
    device must not overlap, so a caller that uses several streams orders
    them (every caller in the port uses the current stream)."""
    _check(cl, ro, rd, t_min, t_max, exclude)
    if ro.device.type == "cpu":
        return cluster_plain(cl, ro, rd, t_min, t_max, exclude, any_hit,
                             stats)
    if ro.device.type != "cuda":
        raise RuntimeError(
            f"no cluster kernel for device {ro.device}")
    return _launch(cl, ro, rd, t_min, t_max, exclude, any_hit, stats)


def _launch(cl, ro, rd, t_min, t_max, exclude, any_hit, stats):
    from .. import kernels

    lib = kernels.load()
    r, dev = ro.shape[0], ro.device
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    nodes = leaves = None
    if stats:
        nodes = torch.empty(r, dtype=torch.int32, device=dev)
        leaves = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.rgk_cluster_intersect(
                cl.boxes_q.data_ptr(), cl.leaf_bits.data_ptr(),
                cl.links.data_ptr(), cl.links.shape[0] // 8 * 128,
                cl.boxes_q.shape[0] // 3, cl.pack.data_ptr(),
                cl.chunk_halves * HALF, cl.scene_lo.data_ptr(),
                cl.scene_step.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                t_min.data_ptr(), t_max.data_ptr(), exclude.data_ptr(), r,
                t.data_ptr(), tri.data_ptr(),
                nodes.data_ptr() if stats else None,
                leaves.data_ptr() if stats else None,
                int(any_hit), stream)
        kernels.check_launch(rc, "cluster_intersect")
        launches["any" if any_hit else "closest"] += 1
    return (t, tri, nodes, leaves) if stats else (t, tri)


# --------------------------------------------------------- the plain version

def _unpack_tables(cl):
    """The chunk tree as plain tensors: dequantizable boxes f32 [N, 6]
    (qmin xyz, qmax xyz), leaf flags bool [N], hit and miss links int64
    [8, N], and the pack viewed triangle-major f32 [K, 16]."""
    n = cl.boxes_q.shape[0] // 3
    w = cl.boxes_q.view(n, 3).to(torch.int64) & 0xFFFFFFFF
    hi, lo16 = (w >> 16) & 0xFFFF, w & 0xFFFF
    qbox = torch.stack([hi[:, 0], lo16[:, 0], hi[:, 1],
                        lo16[:, 1], hi[:, 2], lo16[:, 2]],
                       dim=1).to(torch.float32)
    nid = torch.arange(n, device=w.device)
    bits = cl.leaf_bits.to(torch.int64)[nid >> 5]
    leaf = ((bits >> (nid & 31)) & 1) > 0
    links = (cl.links.view(8, -1)[:, :n].to(torch.int64) & 0xFFFFFFFF)
    return (qbox, leaf, (links >> 16) & 0xFFFF, links & 0xFFFF,
            tri_major(cl.pack))


def tri_major(pack):
    """The coefficient-major pack [T*16, 128] viewed slot-major [T*128,
    16]: row s = the 16 coefficients of slot s."""
    tiles = pack.shape[0] // 16
    return pack.view(tiles, 16, 128).transpose(1, 2).reshape(-1, 16)


def _inv(c):
    """1/c with zero components replaced by +-1e-20 (reference :189)."""
    tiny = torch.where(c >= 0.0, 1e-20, -1e-20)
    return 1.0 / torch.where(torch.abs(c) > 1e-20, c, tiny)


def _sweep(rows, ro, rd, t_min, t_max, excl, best_t, best_i, any_hit):
    """Badouel sweep of per-lane chunks `rows` [L, csz, 16] against the
    lanes' rays, merged into (best_t, best_i) by (min t, min id).  Any
    hit: best_t = the least accepted t, best_i = 0 where one exists."""
    col = [rows[..., j] for j in range(12)]
    pid = rows[..., 13].contiguous().view(torch.int32)
    ox, oy, oz = (ro[:, i:i + 1] for i in range(3))
    dx, dy, dz = (rd[:, i:i + 1] for i in range(3))
    rddn = dx * col[0] + dy * col[1] + dz * col[2]
    rodn = ox * col[0] + oy * col[1] + oz * col[2] + col[3]
    t = -rodn / rddn
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    beta = col[4] + px * col[5] + py * col[6] + pz * col[7]
    gamma = col[8] + px * col[9] + py * col[10] + pz * col[11]
    ok = ((beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (t > t_min[:, None]) & (t < t_max[:, None])
          & (pid != excl[:, None]))
    t_sel = torch.where(ok, t, BIG)
    tile_t = t_sel.amin(dim=1)
    if any_hit:
        found = tile_t < BIG
        return (torch.minimum(best_t, tile_t),
                torch.where(found, 0, best_i))
    tile_i = torch.where(ok & (t_sel == tile_t[:, None]), pid,
                         _INT_MAX).amin(dim=1)
    win = (tile_t < BIG) & ((tile_t < best_t)
                            | ((tile_t == best_t) & (tile_i < best_i)))
    return torch.where(win, tile_t, best_t), torch.where(win, tile_i, best_i)


def cluster_plain(cl, ro, rd, t_min, t_max, exclude, any_hit: bool = False,
                  stats: bool = False):
    """K2's function in plain PyTorch, on any device (see module doc).

    A host loop steps every live lane one node a round: slab-test the
    node on its dequantized box, sweep the leaf's chunk on a hit, then
    follow the hit link (inner node hit) or the miss link.  Finished
    lanes leave the live set; lanes with an empty interval (t_max <=
    t_min) cannot hit and never enter it."""
    r, dev = ro.shape[0], ro.device
    qbox, leaf, hit_link, miss_link, slot_rows = _unpack_tables(cl)
    n_nodes = leaf.shape[0]
    csz = cl.chunk_halves * HALF
    slot = torch.arange(csz, device=dev)

    out_t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    out_i = torch.full((r,), -1, dtype=torch.int32, device=dev)
    out_nodes = torch.zeros(r, dtype=torch.int32, device=dev)
    out_leaves = torch.zeros(r, dtype=torch.int32, device=dev)

    # Quantized-frame slab terms, as the reference's: box planes are u16
    # grid coords q; world t = (q - (ro - lo) / step) * (step / rd).
    lane = torch.nonzero(t_max > t_min).flatten()
    ro_l, rd_l, tmin, tmax, excl = (x[lane] for x in (ro, rd, t_min, t_max,
                                                      exclude))
    lo, step = cl.scene_lo, cl.scene_step
    rq = (ro_l - lo) / step
    iv = step * _inv(rd_l)
    octant = _octant(rd_l).long()
    n_live = lane.numel()
    node = torch.zeros(n_live, dtype=torch.int64, device=dev)
    best_t = torch.full((n_live,), BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((n_live,), -1, dtype=torch.int32, device=dev)
    n_vis = torch.zeros(n_live, dtype=torch.int32, device=dev)
    n_leaf = torch.zeros(n_live, dtype=torch.int32, device=dev)

    while lane.numel():
        q = qbox[node]
        t0 = (q[:, 0:3] - rq) * iv
        t1 = (q[:, 3:6] - rq) * iv
        tn = torch.minimum(t0, t1).amax(dim=1)
        tf = torch.maximum(t0, t1).amin(dim=1)
        tcap = torch.minimum(best_t, tmax)
        hit = (tf >= tn) & (tf >= tmin) & (tn <= tcap)
        n_vis += 1
        is_leaf = leaf[node]
        w_hit = hit_link[octant, node]
        w_miss = miss_link[octant, node]

        sweep = torch.nonzero(hit & is_leaf).flatten()
        if sweep.numel():
            n_leaf[sweep] += 1
            chunk = w_hit[sweep]
            step_l = max(1, PLAIN_SWEEP_ELEMS // csz)
            for s in range(0, sweep.numel(), step_l):
                sl = sweep[s:s + step_l]
                rows = slot_rows[chunk[s:s + step_l, None] * csz + slot]
                bt, bi = _sweep(rows, ro_l[sl], rd_l[sl], tmin[sl],
                                tmax[sl], excl[sl], best_t[sl], best_i[sl],
                                any_hit)
                best_t[sl] = bt
                best_i[sl] = bi

        node = torch.where(hit & ~is_leaf, w_hit, w_miss)
        done = node >= n_nodes
        if any_hit:
            done = done | (best_i >= 0)
        fin = torch.nonzero(done).flatten()
        if fin.numel():
            ids = lane[fin]
            out_t[ids] = best_t[fin]
            out_i[ids] = best_i[fin]
            out_nodes[ids] = n_vis[fin]
            out_leaves[ids] = n_leaf[fin]
            keep = torch.nonzero(~done).flatten()
            (lane, node, octant, best_t, best_i, n_vis, n_leaf, rq, iv,
             ro_l, rd_l, tmin, tmax, excl) = (
                x[keep] for x in (lane, node, octant, best_t, best_i, n_vis,
                                  n_leaf, rq, iv, ro_l, rd_l, tmin, tmax,
                                  excl))
    return (out_t, out_i, out_nodes, out_leaves) if stats else (out_t, out_i)
