"""Port parity: the binned cluster pipeline of rgk_tpu_torch (K3's plain
version `walk_plain`, K4's `sweep_plain` and the front end
`intersect_clusters_binned`) against rgk_tpu's Pallas binned kernels in
interpret mode and against the port's own K2 path (`cluster_plain`
through `intersect_clusters`), on the 1000-triangle soups of
tests/test_torch_cluster_intersect.py (layouts half / tpc2 / tpc4).

On the CPU the wrappers `walk` and `sweep_pairs` run the plain
versions; the CUDA kernels are held to them by tests/test_torch_cuda.py
and chip_smoke.py on the card.

Tolerances: chunk lists compared as sorted sets, bitwise, with `cnt`
equal; front-end ids equal (closest hit), hit / no hit equal (any hit),
and t bitwise equal to the K2 path's (both report the winner's record
recomputed from tri_pack); the sweep against the reference kernel: ids
equal, t within rtol 3e-4 / atol 1e-6 (its sums run in another order).
The reference's interpret-mode kernels take tens of seconds to compile,
so they run once each: the walk on tpc2 (4 chunks, K = 4: no overflow),
the sweep on halves and tpc2, the whole pipeline at K = 4 on halves
(16 chunks: overflow and pass 2).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.ops import pallas_binned as jb
from rgk_tpu.scene.builder import append_thinglass_column
from rgk_tpu.scene.builder import build_tri_pack as j_build_tri_pack
from rgk_tpu_torch import kernels
from rgk_tpu_torch.ops import binned_intersect as bi
from rgk_tpu_torch.ops import cluster_intersect as ci
from rgk_tpu_torch.scene import clusters as tclusters
from test_torch_cluster_intersect import LAYOUTS, N_RAYS, _scenes

BIG = np.float32(3.4e38)


def _lanes(r, t_min, t_max, exclude=-1):
    return [torch.from_numpy(np.broadcast_to(np.asarray(x, dt), (r,)).copy())
            for x, dt in ((t_min, np.float32), (t_max, np.float32),
                          (exclude, np.int32))]


def _rays(seed=22, n=N_RAYS):
    return [torch.from_numpy(x) for x in scenes.rays(n, seed=seed)]


def _ref_walk(jscene, ro, rd, t_min, t_max, K):
    """rgk_tpu's K3 in interpret mode -> (ids [R, K], cnt [R], skipmin)."""
    c = jscene.clusters
    cols = [jnp.asarray(x.numpy()) for x in (*ro.T, *rd.T, t_min, t_max)]
    out = jb._run_walk(c.boxes_q, c.leaf_bits, c.links, c.scene_lo,
                       c.scene_step, *cols, K=K, block=256, interpret=True)
    return [np.asarray(x) for x in out]


def _leaf_slabs(cl, ro, rd, t_min, t_max):
    """Every leaf against every lane: (chunk id of each leaf [L], entry t
    [R, L], slab test against [t_min, t_max] [R, L]), in the walks'
    arithmetic."""
    qbox, leaf, hit_link, _, _ = ci._unpack_tables(cl)
    rq = (ro - cl.scene_lo) / cl.scene_step
    iv = cl.scene_step * ci._inv(rd)
    q = qbox[leaf]
    t0 = (q[None, :, 0:3] - rq[:, None]) * iv[:, None]
    t1 = (q[None, :, 3:6] - rq[:, None]) * iv[:, None]
    tn = torch.minimum(t0, t1).amax(dim=2)
    tf = torch.maximum(t0, t1).amin(dim=2)
    hit = (tf >= tn) & (tf >= t_min[:, None]) & (tn <= t_max[:, None])
    return hit_link[0, leaf], tn, hit


def _sets(ids):
    return [sorted(int(c) for c in row if c >= 0) for row in ids]


# ------------------------------------------------------------------ K3


def test_walk_plain_matches_reference(monkeypatch):
    """(a) Without overflow (K = the number of chunks) the set of listed
    chunks and cnt do not depend on the walk order: they equal the
    reference kernel's, and the set is exactly the leaves whose own slab
    test passes.  skipmin stays 3.4e38; empty-interval lanes list
    nothing."""
    jscene, cl, _ = _scenes("tpc2", monkeypatch)
    K = bi._n_chunks(cl)
    assert K == 4
    ro, rd = _rays()
    t_min, t_max, _ = _lanes(N_RAYS, 0.5, 1e4)
    ids, cnt, skip = bi.walk(cl, ro, rd, t_min, t_max, K)
    r_ids, r_cnt, r_skip = _ref_walk(jscene, ro, rd, t_min, t_max, K)
    assert _sets(ids.numpy()) == _sets(r_ids)
    np.testing.assert_array_equal(cnt.numpy(), r_cnt)
    assert bool((skip == BIG).all()) and (r_skip == BIG).all()
    assert 1.0 < cnt.double().mean().item() < K

    chunk, _, hit = _leaf_slabs(cl, ro, rd, t_min, t_max)
    assert _sets(ids.numpy()) == [sorted(chunk[h].tolist()) for h in hit]

    dead = torch.arange(N_RAYS) % 3 == 0
    ids2, cnt2, skip2 = bi.walk(cl, ro, rd, t_min,
                                torch.where(dead, -1.0, t_max), K)
    assert bool((cnt2[dead] == 0).all() and (ids2[dead] == -1).all())
    assert torch.equal(ids2[~dead], ids[~dead])
    assert torch.equal(cnt2[~dead], cnt[~dead])
    assert bi.launches == {"walk": 0, "sweep": 0}  # CPU: no kernel


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("K", [1, 2])
def test_walk_cap_covers_every_leaf(monkeypatch, layout, K):
    """(b) With a cap the walk may drop chunks, but every leaf whose
    slab test passes is listed or enters at t >= skipmin, where pass 2
    takes over; the list holds min(cnt, K) distinct chunks in order."""
    _, cl, _ = _scenes(layout, monkeypatch)
    ro, rd = _rays(seed=9)
    t_min, t_max, _ = _lanes(N_RAYS, 0.0, 1e4)
    ids, cnt, skip, nodes = bi.walk(cl, ro, rd, t_min, t_max, K, stats=True)
    chunk, tn, hit = _leaf_slabs(cl, ro, rd, t_min, t_max)
    listed = (chunk[None, None, :] == ids[:, :, None].long()).any(dim=1)
    covered = listed | (tn >= skip[:, None])
    assert bool(covered[hit].all())
    n_listed = (ids >= 0).sum(dim=1)
    assert torch.equal(n_listed, torch.clamp(cnt, max=K))
    assert bool(((skip < BIG) == (cnt > K)).all())
    assert bool((cnt <= hit.sum(dim=1)).all() and (nodes >= 1).all())
    if bi._n_chunks(cl) > K:
        assert bool((cnt > K).any())  # the cap is exercised


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("layout", ["half", "tpc2"])
def test_sweep_plain_matches_reference(monkeypatch, layout):
    """(c) Each sorted (chunk, ray) pair's closest hit in its chunk,
    against the reference kernel on the same pairs (padded to a multiple
    of 1024 with sentinel keys for it; the port takes them as they
    are), with an exclude per ray."""
    jscene, cl, _ = _scenes(layout, monkeypatch)
    ro, rd = _rays(seed=10)
    t_min, t_max, _ = _lanes(N_RAYS, 0.1, 30.0)
    excl = torch.from_numpy(np.random.default_rng(3).integers(
        -1, 1000, N_RAYS).astype(np.int32))
    K = 4
    ids, _, _ = bi.walk(cl, ro, rd, t_min, t_max, K)
    cid, pos = bi.make_pairs(ids)
    ray_of = (pos // K).to(torch.int32)
    t_p, i_p = bi.sweep_pairs(cl, cid, ray_of, ro, rd, t_min, t_max, excl)

    p = cid.shape[0]
    pp = -(-p // 1024) * 1024
    key = np.full(pp, bi.SENT, np.int32)
    key[:p] = cid.numpy()
    ray = np.zeros(pp, np.int64)
    ray[:p] = ray_of.numpy()
    ray8 = torch.cat([ro, rd, t_min[:, None], t_max[:, None]], 1).numpy()
    cols = [jnp.asarray(ray8[ray, k]) for k in range(8)]
    rt, ri = jb._run_sweep(jscene.clusters.pack, jnp.asarray(key),
                           jb._run_ends(jnp.asarray(key)), *cols,
                           jnp.asarray(excl.numpy()[ray]), cl.chunk_halves,
                           True)
    rt, ri = np.asarray(rt)[:p], np.asarray(ri)[:p]
    np.testing.assert_array_equal(i_p.numpy(), ri)
    hit = ri >= 0
    assert hit[key[:p] != bi.SENT].mean() > 0.05
    np.testing.assert_allclose(t_p.numpy()[hit], rt[hit], rtol=3e-4,
                               atol=1e-6)
    assert bool((t_p[~torch.from_numpy(hit)] == BIG).all())
    assert not bool(((i_p == excl[ray_of.long()]) & (i_p >= 0)).any())


# ---------------------------------------------------------- the front end


def _both(cl, pack, ro, rd, t_min, t_max, exclude=-1, any_hit=False, K=4):
    lanes = _lanes(ro.shape[0], t_min, t_max, exclude)
    return (ci.intersect_clusters(cl, pack, ro, rd, *lanes, any_hit=any_hit),
            bi.intersect_clusters_binned(cl, pack, ro, rd, *lanes,
                                         any_hit=any_hit, K=K))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("K", [1, 4, 8])
def test_front_end_equals_k2_path(monkeypatch, layout, K):
    """(d) The binned front end reports what the K2 front end reports:
    closest hit (ids and t bitwise), an exclude pass over its winners,
    any-hit validity in a window, and a third of the lanes with an empty
    interval."""
    _, cl, pack = _scenes(layout, monkeypatch)
    ro, rd = _rays()
    k2, bn = _both(cl, pack, ro, rd, 0.0, 1e4, K=K)
    assert (k2[1] >= 0).double().mean() > 0.05
    for a, b in zip(k2, bn):
        assert torch.equal(a, b)

    k2x, bnx = _both(cl, pack, ro, rd, 0.0, 1e4, exclude=k2[1].numpy(), K=K)
    assert torch.equal(k2x[1], bnx[1]) and torch.equal(k2x[0], bnx[0])
    assert not bool(((bnx[1] == k2[1]) & (k2[1] >= 0)).any())

    k2a, bna = _both(cl, pack, ro, rd, 0.1, 20.0, any_hit=True, K=K)
    assert torch.equal(k2a[1] >= 0, bna[1] >= 0)
    assert set(bna[1].unique().tolist()) <= {-1, 0}

    dead = np.arange(N_RAYS) % 3 == 0
    t_max = np.where(dead, -1.0, 1e4).astype(np.float32)
    k2d, bnd = _both(cl, pack, ro, rd, 0.0, t_max, K=K)
    assert torch.equal(k2d[1], bnd[1])
    assert not bool((bnd[1][torch.from_numpy(dead)] >= 0).any())
    assert torch.equal(bnd[1][~torch.from_numpy(dead)],
                       bn[1][~torch.from_numpy(dead)])


def test_front_end_matches_reference_pipeline(monkeypatch):
    """(d) Ids equal rgk_tpu's binned pipeline (interpret mode, block 256,
    K = 4) on 16 chunks, where lists overflow and pass 2 runs."""
    jscene, cl, pack = _scenes("half", monkeypatch)
    ro, rd = _rays()
    ref = jb.intersect_clusters_binned(
        jscene, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), 0.0, 1e4,
        block=256, K=4, interpret=True)
    _, bn = _both(cl, pack, ro, rd, 0.0, 1e4, K=4)
    np.testing.assert_array_equal(bn[1].numpy(), np.asarray(ref.tri))
    hit = np.asarray(ref.tri) >= 0
    np.testing.assert_allclose(bn[0].numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-6)
    _, cnt, _ = bi.walk(cl, ro, rd, *_lanes(N_RAYS, 0.0, 1e4)[:2], 4)
    assert bool((cnt > 4).any())


def test_no_pair_is_dropped(monkeypatch):
    """(e) R = 640 and K = 4 give 2,560 pairs, not a multiple of the
    reference's 1024-pair grid step: every pair is swept and no lane
    differs from the K2 path."""
    _, cl, pack = _scenes("half", monkeypatch)
    ro, rd = _rays(seed=11, n=640)
    seen = []
    sweep = bi.sweep_pairs

    def spy(cl, cid, *args):
        seen.append(cid.clone())
        return sweep(cl, cid, *args)

    monkeypatch.setattr(bi, "sweep_pairs", spy)
    k2, bn = _both(cl, pack, ro, rd, 0.0, 1e4, K=4)
    for a, b in zip(k2, bn):
        assert torch.equal(a, b)
    (cid,) = seen
    assert cid.shape[0] == 2560
    t_min, t_max, excl = _lanes(640, 0.0, 1e4)
    ids, cnt, _ = bi.walk(cl, ro, rd, t_min, t_max, 4)
    assert int((cid != bi.SENT).sum()) == int(torch.clamp(cnt, max=4).sum())

    # A pair whose key or ray is out of range is no pair: no hit.
    cid, pos = bi.make_pairs(ids)
    ray_of = (pos // 4).to(torch.int32)
    ray_of[:3] = torch.tensor([-1, 640, 10 ** 6], dtype=torch.int32)
    cid[3] = bi._n_chunks(cl)
    t, tri = bi.sweep_pairs(cl, cid, ray_of, ro, rd, t_min, t_max, excl)
    assert bool((tri[:4] == -1).all() and (t[:4] == BIG).all())
    assert bool((tri[4:] >= 0).any())


# ------------------------------------------------------- tie across the cap


def _tie_scene():
    """The 1000-triangle soup plus two coplanar triangles at z = 12, ids
    1000 (small, around the origin) and 1001 (long, reaching to
    (-19, -19)), with the same plane row: a ray down the z axis near the
    origin hits both at one bitwise t."""
    verts, tris = scenes.soup(1000, seed=21)
    z = 12.0
    small = [[-0.5, -0.5, z], [-0.5, 1.0, z], [1.0, -0.5, z]]
    long_ = [[1.0, -1.0, z], [-19.0, -19.0, z], [-1.0, 1.0, z]]
    verts = np.concatenate([verts, small, long_]).astype(np.float32)
    tris = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    glass = np.zeros(len(tris), bool)
    glass[:1000:7] = True
    pack = append_thinglass_column(j_build_tri_pack(verts, tris),
                                   np.arange(len(tris)), glass)
    return tclusters.build_clusters(verts, tris, pack), torch.from_numpy(pack)


def test_tie_across_the_cap():
    """(f) K = 1 lists the chunk of triangle 1001 and drops that of 1000,
    which the ray hits at the same bitwise t.  Pass 2's window, opened by
    one ulp above the best t, finds 1000: the result is the lower id, as
    on the K2 path.  Closed at the best t it would not be."""
    cl, pack = _tie_scene()
    slot_ids = ci.tri_major(cl.pack)[:, 13].contiguous().view(torch.int32)
    csz = cl.chunk_halves * 64
    chunk = {i: int(torch.nonzero(slot_ids == i)[0, 0]) // csz
             for i in (1000, 1001)}
    assert chunk[1000] != chunk[1001]
    assert torch.equal(pack[1000, :4].view(torch.int32),
                       pack[1001, :4].view(torch.int32))

    ro = torch.tensor([[-0.1, -0.05, 20.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0]])
    t_min, t_max, excl = _lanes(1, 0.0, 1e4)
    alone = [ci._sweep(ci.tri_major(cl.pack)[None, s:s + 1], ro, rd, t_min,
                       t_max, excl, t_max.clone(), excl.clone(), False)
             for s in (int(torch.nonzero(slot_ids == i)[0, 0])
                       for i in (1000, 1001))]
    assert [int(b[1]) for b in alone] == [1000, 1001]
    assert alone[0][0].view(torch.int32) == alone[1][0].view(torch.int32)
    t_tie = alone[0][0]

    ids, cnt, skip = bi.walk(cl, ro, rd, t_min, t_max, K=1)
    assert ids.tolist() == [[chunk[1001]]] and int(cnt) > 1
    assert float(skip) < float(t_tie)

    k2, bn = _both(cl, pack, ro, rd, 0.0, 1e4, K=1)
    assert int(k2[1]) == int(bn[1]) == 1000
    assert torch.equal(k2[0], bn[0])

    # The window closed at the best t misses the tie (K2's t < t_max).
    for upper, want in ((t_tie, -1), (torch.nextafter(
            t_tie, torch.full_like(t_tie, np.inf)), 1000)):
        _, tri = ci.traverse(cl, ro, rd, skip, upper, excl)
        assert int(tri) == want


def test_pass2_window_and_merge():
    """(f) The window and the merge on synthetic lanes."""
    f = torch.tensor
    inf = float("inf")
    skip = f([BIG, 4.0, 4.0, 4.0, 4.0, 9.0])
    t_min = f([0.0, 0.0, 5.0, 0.0, 0.0, 0.0])
    t_max = f([1e4, 1e4, 1e4, 6.0, 1e4, 1e4])
    best_t = f([7.0, 7.0, 7.0, 7.0, BIG, 7.0])
    best_i = f([3, 3, 3, 3, -1, 3], dtype=torch.int32)
    lo, hi = bi.pass2_window(skip, t_min, t_max, best_t, best_i, False)
    up7 = torch.nextafter(f(7.0), f(inf))
    assert lo.tolist() == [BIG, 4.0, 5.0, 4.0, 4.0, BIG]
    assert hi.tolist() == [-BIG, float(up7), float(up7), 6.0, 1e4, -BIG]
    lo, hi = bi.pass2_window(skip, t_min, t_max, best_t, best_i, True)
    assert lo.tolist() == [BIG, BIG, BIG, BIG, 4.0, BIG]

    t2 = f([6.0, 7.0, 7.0, 7.0, 3.0, BIG])
    i2 = f([9, 2, 5, 3, 8, -1], dtype=torch.int32)
    bt, bid = bi.merge(f([7.0] * 5 + [BIG]), f([3] * 5 + [-1],
                                               dtype=torch.int32), t2, i2)
    assert bt.tolist() == [6.0, 7.0, 7.0, 7.0, 3.0, BIG]
    assert bid.tolist() == [9, 2, 3, 3, 8, -1]


# ------------------------------------------------------------ the build


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """Editing a header that the kernels include, or a source, names a
    new library, so the next load rebuilds; restoring it names the old
    one again."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/toolkit/bin/nvcc")
    header = csrc / "cluster_common.cuh"
    assert header.exists() and os.path.basename(
        kernels.library_path()).startswith("librgk_kernels_")
    base = kernels.library_path()
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    assert kernels.library_path() != base
    header.write_text(text)
    assert kernels.library_path() == base
    src = csrc / "binned_sweep.cu"
    src.write_text(src.read_text() + "\n")
    assert kernels.library_path() != base


@pytest.mark.parametrize("scene", ["far", "tiny"])
def test_far_scene_binned_contract(scene):
    """The far scenes where the binned front end and K2's part (a sphere
    of radius 1 at coordinates in the hundreds seen from 200 units, one
    of radius 0.05 seen from 150; 8,192 rays aimed near triangle edges)
    on the plain route: walk_plain, sweep_plain and pass 2 through
    cluster_plain against cluster_plain alone.  Where the ids differ,
    both are hits of the same point across a shared edge, within
    rounding of the exhaustive oracle (flat_plain over the whole
    tri_pack) and of each row's float64 t, and the binned hit is the
    earlier one: K2 pruned a chunk whose box entry t rounded above a hit
    inside it (scenes.assert_binned_contract)."""
    cl, pack, rays = scenes.far_sphere_tree("cpu", scene, n_rays=8192)
    before = dict(bi.launches)
    binned = bi.intersect_clusters_binned(cl, pack, *rays)
    k2 = ci.intersect_clusters(cl, pack, *rays)
    assert bi.launches == before
    assert (k2[1] >= 0).double().mean().item() > 0.9
    n, earlier, _ = scenes.assert_binned_contract(pack, rays, binned, k2)
    assert n > 0 and n == earlier
