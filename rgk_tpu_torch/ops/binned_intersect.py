"""The binned cluster pipeline: walk-emit (K3), dense chunk sweeps of
(chunk, ray) pairs (K4), and K2 over the window the cap could not cover
(port of rgk_tpu/ops/pallas_binned.py).

`intersect_clusters_binned` has the contract of
`cluster_intersect.intersect_clusters` and returns the same hits:
1. sort the rays by the coherence key (`cluster_intersect.sort_rays`,
   empty intervals last);
2. K3 (`walk`): per ray, the ids of the first K leaf chunks whose slab
   test passes, the count of all of them, and `skipmin`, the entry t of
   the first chunk the cap dropped (nudged down), else 3.4e38;
3. the lists become (chunk, ray) pairs keyed by chunk (-1 -> a sentinel
   that sorts last), in one stable sort;
4. K4 (`sweep_pairs`): each pair's closest hit in its chunk;
5. the pair results go back to [R, K] by `index_copy_` (no second sort)
   and reduce per ray by (min t, min id);
6. pass 2 (`cluster_intersect.traverse`, closest mode) over the window
   `pass2_window` gives; lanes that need none get an empty interval and
   do not walk.  Under any hit only hitless lanes take part;
7. merge by (min t, min id), unsort, and report the record as
   `intersect_clusters` does (`hit_record`), or the any-hit witness.

Three hazards of the reference are pinned here:
* no pair is dropped: the sweep runs over all R*K pairs with a bounds
  check, where the reference's grid P // 1024 truncates
  (pallas_binned.py:402);
* ties across the cap: the reference's pass 2 searches (skipmin, best t)
  with K2's strict t < t_max and merges with a strict <
  (pallas_binned.py:540-554), so a triangle of a dropped chunk at the same
  t as the emitted winner, with a smaller id, is lost.  Here the upper
  bound is opened by one ulp (`torch.nextafter`) and the merge keeps (min
  t, min id), so the result equals K2's whatever the walk order;
* the cap's invariant (the reference's comment at :214 misstates it): the
  walk tests every node against tcap = min(t_max, skipmin) once the list
  is full, else t_max, so a chunk neither listed nor dropped is not
  entered before skipmin, and pass 2 from skipmin covers it.

Each wrapper dispatches on the tensors' device, as `traverse` does: a
CUDA tensor launches its kernel (`csrc/binned_walk.cu`,
`csrc/binned_sweep.cu`) or raises; a CPU tensor takes the plain version
(`walk_plain`, `sweep_plain`).  `launches` counts kernel launches;
nothing else adds to it.
"""

from __future__ import annotations

import torch

from ..scene.clusters import HALF
from . import cluster_intersect as ci

BIG = ci.BIG
SENT = 0x7FFFFF00       # pair key of an empty list slot, above any chunk id
DEFAULT_K = 8           # chunk ids a ray lists before the cap

launches = {"walk": 0, "sweep": 0}


# ---------------------------------------------------------------- front end

def intersect_clusters_binned(cl, tri_pack, ro, rd, t_min, t_max, exclude,
                              any_hit: bool = False, K: int = DEFAULT_K):
    """-> (t f32 [R], tri i32 [R], bary_b f32 [R], bary_c f32 [R]), as
    `cluster_intersect.intersect_clusters` (same arguments)."""
    perm, ro_s, rd_s, tmin_s, tmax_s, excl_s = ci.sort_rays(
        cl, ro, rd, t_min, t_max, exclude)
    ids, _, skipmin = walk(cl, ro_s, rd_s, tmin_s, tmax_s, K)
    cid, pos = make_pairs(ids)
    ray_of = torch.div(pos, K, rounding_mode="floor").to(torch.int32)
    t_p, i_p = sweep_pairs(cl, cid, ray_of, ro_s, rd_s, tmin_s, tmax_s,
                           excl_s)
    best_t, best_i = reduce_pairs(t_p, i_p, pos, K)
    lo, hi = pass2_window(skipmin, tmin_s, tmax_s, best_t, best_i, any_hit)
    t2, i2 = ci.traverse(cl, ro_s, rd_s, lo, hi, excl_s, any_hit=False)
    best_t, best_i = merge(best_t, best_i, t2, i2)

    t = torch.empty_like(best_t).index_copy_(0, perm, best_t)
    idx = torch.empty_like(best_i).index_copy_(0, perm, best_i)
    if any_hit:
        zeros = torch.zeros_like(t)
        return t, torch.where(idx >= 0, 0, -1).to(torch.int32), zeros, zeros
    return ci.hit_record(tri_pack, ro, rd, t, idx)


def make_pairs(ids):
    """[R, K] chunk lists -> (chunk key i32 [R*K], position int64 [R*K]),
    stably sorted by key; empty slots (-1) carry SENT and sort last.  The
    pair at sorted index j came from list slot pos[j] (ray pos // K)."""
    flat = ids.reshape(-1)
    key = torch.where(flat >= 0, flat, SENT).to(torch.int32)
    return torch.sort(key, stable=True)


def reduce_pairs(t_p, i_p, pos, K: int):
    """Pair results in sorted order -> each ray's (min t, min id) over
    its K slots: (t f32 [R], id i32 [R]; 3.4e38 / -1 without a hit)."""
    t_k = torch.empty_like(t_p).index_copy_(0, pos, t_p).view(-1, K)
    i_k = torch.empty_like(i_p).index_copy_(0, pos, i_p).view(-1, K)
    best_t = t_k.amin(dim=1)
    best_i = torch.where(t_k == best_t[:, None], i_k,
                         ci._INT_MAX).amin(dim=1)
    return best_t, torch.where(best_t < BIG, best_i, -1).to(torch.int32)


def pass2_window(skipmin, t_min, t_max, best_t, best_i, any_hit: bool):
    """-> (t_min, t_max) of pass 2, per ray.  A ray whose cap dropped a
    chunk (skipmin < 3.4e38) searches (max(skipmin, t_min),
    min(nextafter(best t), t_max)): the upper bound opened by one ulp, so
    that a triangle at exactly the best t, with a smaller id, is still
    found.  Under any hit a ray with a hit is settled.  Every other ray
    gets the empty interval (3.4e38, -3.4e38) and does not walk."""
    lower = torch.maximum(skipmin, t_min)
    upper = torch.minimum(torch.nextafter(best_t, torch.full_like(
        best_t, float("inf"))), t_max)
    need = (skipmin < BIG) & (lower < upper)
    if any_hit:
        need = need & (best_i < 0)
    return torch.where(need, lower, BIG), torch.where(need, upper, -BIG)


def merge(best_t, best_i, t2, i2):
    """(min t, then min id) of the listed chunks' winner and pass 2's."""
    win = (i2 >= 0) & ((t2 < best_t) | ((t2 == best_t) & (i2 < best_i)))
    return torch.where(win, t2, best_t), torch.where(win, i2, best_i)


# ------------------------------------------------------------- the wrappers

def walk(cl, ro, rd, t_min, t_max, K: int = DEFAULT_K, stats: bool = False):
    """K3: -> (ids i32 [R, K], cnt i32 [R], skipmin f32 [R]) [+ nodes i32
    [R] with stats].  Tensors contiguous on one device (module doc)."""
    ci._check(cl, ro, rd, t_min, t_max)
    if K < 1:
        raise ValueError(f"K must be at least 1, got {K}")
    if ro.device.type == "cpu":
        return walk_plain(cl, ro, rd, t_min, t_max, K, stats)
    if ro.device.type != "cuda":
        raise RuntimeError(f"no walk kernel for device {ro.device}")
    from .. import kernels

    lib = kernels.load()
    r, dev = ro.shape[0], ro.device
    ids = torch.empty((r, K), dtype=torch.int32, device=dev)
    cnt = torch.empty(r, dtype=torch.int32, device=dev)
    skip = torch.empty(r, dtype=torch.float32, device=dev)
    nodes = torch.empty(r, dtype=torch.int32, device=dev) if stats else None
    if r:
        with torch.cuda.device(dev):
            rc = lib.rgk_binned_walk(
                cl.boxes_q.data_ptr(), cl.leaf_bits.data_ptr(),
                cl.links.data_ptr(), cl.links.shape[0] // 8 * 128,
                cl.boxes_q.shape[0] // 3, cl.scene_lo.data_ptr(),
                cl.scene_step.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                t_min.data_ptr(), t_max.data_ptr(), r, K, ids.data_ptr(),
                cnt.data_ptr(), skip.data_ptr(),
                nodes.data_ptr() if stats else None,
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.check_launch(rc, "binned_walk")
        launches["walk"] += 1
    return (ids, cnt, skip, nodes) if stats else (ids, cnt, skip)


def _n_chunks(cl):
    return cl.pack.shape[0] // 16 * 128 // (cl.chunk_halves * HALF)


def sweep_pairs(cl, cid, ray_of, ro, rd, t_min, t_max, exclude):
    """K4: -> (t f32 [P], tri i32 [P]), each pair's closest hit (min t,
    min id) in chunk cid[p] for ray ray_of[p] inside that ray's (t_min,
    t_max), not its `exclude`; 3.4e38 / -1 without one, and for a pair
    whose key is no chunk id (SENT) or whose ray is out of range.  cid,
    ray_of i32 [P]; the rays as for `walk`, plus exclude i32 [R].  The
    pairs need not be sorted, but the kernel is fast when they are."""
    ci._check(cl, ro, rd, t_min, t_max, exclude)
    for name, x in (("cid", cid), ("ray_of", ray_of)):
        if x.device != ro.device or x.dtype != torch.int32 or x.dim() != 1 \
                or not x.is_contiguous() or x.shape[0] != cid.shape[0]:
            raise ValueError(f"{name} must be contiguous int32 [P] on "
                             f"{ro.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if ro.device.type == "cpu":
        return sweep_plain(cl, cid, ray_of, ro, rd, t_min, t_max, exclude)
    if ro.device.type != "cuda":
        raise RuntimeError(f"no sweep kernel for device {ro.device}")
    from .. import kernels

    lib = kernels.load()
    p, dev = cid.shape[0], ro.device
    t = torch.empty(p, dtype=torch.float32, device=dev)
    tri = torch.empty(p, dtype=torch.int32, device=dev)
    if p:
        with torch.cuda.device(dev):
            rc = lib.rgk_binned_sweep(
                cid.data_ptr(), ray_of.data_ptr(), p, _n_chunks(cl),
                cl.pack.data_ptr(), cl.chunk_halves * HALF, ro.shape[0],
                ro.data_ptr(), rd.data_ptr(), t_min.data_ptr(),
                t_max.data_ptr(), exclude.data_ptr(), t.data_ptr(),
                tri.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        kernels.check_launch(rc, "binned_sweep")
        launches["sweep"] += 1
    return t, tri


# --------------------------------------------------------- the plain versions

def walk_plain(cl, ro, rd, t_min, t_max, K: int = DEFAULT_K,
               stats: bool = False):
    """K3's function in plain PyTorch, on any device.

    A host loop steps every live lane one node a round through its own
    octant's links, as `cluster_plain` does: slab-test the node against
    [t_min, tcap] (tcap = min(t_max, skipmin) once the lane's list is
    full, else t_max), list a hit leaf's chunk while there is room, else
    lower skipmin to its nudged entry t; count it either way."""
    r, dev = ro.shape[0], ro.device
    qbox, leaf, hit_link, miss_link, _ = ci._unpack_tables(cl)
    n_nodes = leaf.shape[0]
    out_ids = torch.full((r, K), -1, dtype=torch.int32, device=dev)
    out_cnt = torch.zeros(r, dtype=torch.int32, device=dev)
    out_skip = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    out_nodes = torch.zeros(r, dtype=torch.int32, device=dev)

    lane = torch.nonzero(t_max > t_min).flatten()
    ro_l, rd_l, tmin, tmax = (x[lane] for x in (ro, rd, t_min, t_max))
    rq = (ro_l - cl.scene_lo) / cl.scene_step
    iv = cl.scene_step * ci._inv(rd_l)
    octant = ci._octant(rd_l).long()
    n_live = lane.numel()
    node = torch.zeros(n_live, dtype=torch.int64, device=dev)
    ids = torch.full((n_live, K), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n_live, dtype=torch.int32, device=dev)
    skip = torch.full((n_live,), BIG, dtype=torch.float32, device=dev)
    n_vis = torch.zeros(n_live, dtype=torch.int32, device=dev)

    while lane.numel():
        q = qbox[node]
        t0 = (q[:, 0:3] - rq) * iv
        t1 = (q[:, 3:6] - rq) * iv
        tn = torch.minimum(t0, t1).amax(dim=1)
        tf = torch.maximum(t0, t1).amin(dim=1)
        tcap = torch.where(cnt >= K, torch.minimum(tmax, skip), tmax)
        hit = (tf >= tn) & (tf >= tmin) & (tn <= tcap)
        n_vis += 1
        is_leaf = leaf[node]
        w_hit = hit_link[octant, node]
        w_miss = miss_link[octant, node]

        emit = hit & is_leaf
        room = torch.nonzero(emit & (cnt < K)).flatten()
        ids[room, cnt[room].long()] = w_hit[room].to(torch.int32)
        # The kernel's nudge, one rounding per operation.
        tn_c = tn - torch.abs(tn) * 2e-7 - 1e-30
        skip = torch.where(emit & (cnt >= K), torch.minimum(skip, tn_c), skip)
        cnt = cnt + emit.to(torch.int32)

        node = torch.where(hit & ~is_leaf, w_hit, w_miss)
        done = node >= n_nodes
        fin = torch.nonzero(done).flatten()
        if fin.numel():
            out = lane[fin]
            out_ids[out] = ids[fin]
            out_cnt[out] = cnt[fin]
            out_skip[out] = skip[fin]
            out_nodes[out] = n_vis[fin]
            keep = torch.nonzero(~done).flatten()
            (lane, node, octant, ids, cnt, skip, n_vis, rq, iv, tmin,
             tmax) = (x[keep] for x in (lane, node, octant, ids, cnt, skip,
                                        n_vis, rq, iv, tmin, tmax))
    if stats:
        return out_ids, out_cnt, out_skip, out_nodes
    return out_ids, out_cnt, out_skip


def sweep_plain(cl, cid, ray_of, ro, rd, t_min, t_max, exclude):
    """K4's function in plain PyTorch, on any device: `cluster_plain`'s
    chunk sweep (`cluster_intersect._sweep`) for each pair with a chunk
    key, a few planes at a time."""
    p, dev = cid.shape[0], ro.device
    csz = cl.chunk_halves * HALF
    out_t = torch.full((p,), BIG, dtype=torch.float32, device=dev)
    out_i = torch.full((p,), -1, dtype=torch.int32, device=dev)
    valid = torch.nonzero((cid >= 0) & (cid < _n_chunks(cl)) & (ray_of >= 0)
                          & (ray_of < ro.shape[0])).flatten()
    slot_rows = ci.tri_major(cl.pack)
    slot = torch.arange(csz, device=dev)
    step = max(1, ci.PLAIN_SWEEP_ELEMS // csz)
    for s in range(0, valid.numel(), step):
        sl = valid[s:s + step]
        ray = ray_of[sl].long()
        rows = slot_rows[cid[sl].long()[:, None] * csz + slot]
        n = sl.numel()
        out_t[sl], out_i[sl] = ci._sweep(
            rows, ro[ray], rd[ray], t_min[ray], t_max[ray], exclude[ray],
            torch.full((n,), BIG, dtype=torch.float32, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev), False)
    return out_t, out_i
