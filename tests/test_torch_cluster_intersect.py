"""Port parity: the cluster-BVH intersection of rgk_tpu_torch (kernel
K2's plain version `cluster_plain`, its front end `intersect_clusters`,
and `intersect_bvh`) against rgk_tpu's intersect_brute, its Pallas
cluster kernel in interpret mode and its intersect_bvh.

On the CPU the kernel wrapper `traverse` runs `cluster_plain`; the CUDA
kernel itself is held to `cluster_plain` by tests/test_torch_cuda.py and
chip_smoke.py on the card.

Tolerance: winning triangle ids equal (closest hit) and hit / no hit
equal (any hit), against every oracle; t within rtol 3e-4 / atol 1e-6
where a hit exists (as tests/test_intersect.py), barycentrics atol 1e-4.
The soups carry thin-glass rows (every 7th triangle), which never hit.
Leaf layouts: 64-triangle halves (chunk_halves == 1) and whole tiles,
two (tpc 2) or four (tpc 4) a chunk, forced by lowering CHUNK_CAP.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.ops.intersect import intersect_brute
from rgk_tpu.ops.intersect import intersect_bvh as j_intersect_bvh
from rgk_tpu.ops.pallas_cluster import _ray_sort_key
from rgk_tpu.ops.pallas_cluster import intersect_clusters as j_clusters
from rgk_tpu.scene import clusters as jclusters
from rgk_tpu.scene.arrays import BVHArrays as JBVHArrays
from rgk_tpu.scene.builder import append_thinglass_column
from rgk_tpu.scene.builder import build_tri_pack as j_build_tri_pack
from rgk_tpu.scene.bvh import build_bvh as j_build_bvh
from rgk_tpu_torch.ops import cluster_intersect as ci
from rgk_tpu_torch.ops.intersect import intersect_bvh
from rgk_tpu_torch.scene import clusters as tclusters
from rgk_tpu_torch.scene.bvh import build_bvh

N_TRIS = 1000
N_RAYS = 512
# CHUNK_CAP per layout; with 1000 triangles (16 halves): None -> 1 half
# a chunk, 4 -> 4 halves (tpc 2), 2 -> 8 halves (tpc 4).
LAYOUTS = {"half": None, "tpc2": 4, "tpc4": 2}


class _JScene:
    """Just enough of rgk_tpu's SceneArrays for its intersectors."""

    def __init__(self, pack13, clusters=None, bvh=None):
        self.tri_pack = jnp.asarray(pack13)
        self.clusters = clusters
        self.bvh = bvh


class _TScene:
    def __init__(self, pack13, bvh):
        self.tri_pack = torch.from_numpy(pack13)
        self.bvh = bvh


def _pack13(verts, tris):
    is_glass = np.zeros(len(tris), bool)
    is_glass[::7] = True
    return append_thinglass_column(j_build_tri_pack(verts, tris),
                                   np.arange(len(tris)), is_glass)


def _scenes(layout, monkeypatch, seed=21):
    cap = LAYOUTS[layout]
    if cap is not None:
        monkeypatch.setattr(jclusters, "CHUNK_CAP", cap)
        monkeypatch.setattr(tclusters, "CHUNK_CAP", cap)
    verts, tris = scenes.soup(N_TRIS, seed=seed)
    pack = _pack13(verts, tris)
    jscene = _JScene(pack, jclusters.build_clusters(verts, tris, pack))
    cl = tclusters.build_clusters(verts, tris, pack)
    assert cl.chunk_halves == {"half": 1, "tpc2": 4, "tpc4": 8}[layout]
    return jscene, cl, torch.from_numpy(pack)


def _port(cl, pack, ro, rd, t_min, t_max, exclude=None, any_hit=False):
    r = ro.shape[0]
    lanes = [torch.from_numpy(np.broadcast_to(np.asarray(x, dt), (r,)).copy())
             for x, dt in ((t_min, np.float32), (t_max, np.float32),
                           (-1 if exclude is None else exclude, np.int32))]
    return [x.numpy() for x in ci.intersect_clusters(
        cl, pack, torch.from_numpy(ro), torch.from_numpy(rd), *lanes,
        any_hit=any_hit)]


def _assert_closest(port, ref, min_hits=0.05):
    np.testing.assert_array_equal(port[1], np.asarray(ref.tri))
    hit = port[1] >= 0
    assert hit.mean() > min_hits
    np.testing.assert_allclose(port[0][hit], np.asarray(ref.t)[hit],
                               rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(port[2][hit], np.asarray(ref.bary_b)[hit],
                               atol=1e-4)
    np.testing.assert_allclose(port[3][hit], np.asarray(ref.bary_c)[hit],
                               atol=1e-4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cluster_plain_matches_brute(monkeypatch, layout):
    """Closest hit, an exclude pass over its winners, and any hit in a
    finite window, against the GEMM oracle."""
    jscene, cl, pack = _scenes(layout, monkeypatch)
    ro, rd = scenes.rays(N_RAYS, seed=22)
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)

    hb = intersect_brute(jscene, jro, jrd, 0.0, 1e4)
    port = _port(cl, pack, ro, rd, 0.0, 1e4)
    _assert_closest(port, hb)
    assert not np.any(pack[port[1][port[1] >= 0], 12].numpy() > 0.5)

    hb2 = intersect_brute(jscene, jro, jrd, 0.0, 1e4, exclude=hb.tri)
    port2 = _port(cl, pack, ro, rd, 0.0, 1e4, exclude=port[1])
    _assert_closest(port2, hb2, min_hits=0.0)
    assert not np.any((port2[1] == port[1]) & (port[1] >= 0))

    hb3 = intersect_brute(jscene, jro, jrd, 0.1, 20.0)
    port3 = _port(cl, pack, ro, rd, 0.1, 20.0, any_hit=True)
    np.testing.assert_array_equal(port3[1] >= 0, np.asarray(hb3.tri) >= 0)
    assert set(np.unique(port3[1])) <= {-1, 0}


@pytest.mark.parametrize("layout", ["half", "tpc2"])
def test_cluster_plain_matches_reference_kernel(monkeypatch, layout):
    """Against rgk_tpu's Pallas cluster kernel in interpret mode, on the
    same cluster arrays: closest hit, exclusion, any hit, and a third of
    the lanes with an empty interval (no hit there, neighbours
    unchanged)."""
    jscene, cl, pack = _scenes(layout, monkeypatch)
    ro, rd = scenes.rays(N_RAYS, seed=22)
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)

    def ref(t_min, t_max, **kw):
        return j_clusters(jscene, jro, jrd, t_min, t_max, block=256,
                          interpret=True, **kw)

    hr = ref(0.0, 1e4)
    port = _port(cl, pack, ro, rd, 0.0, 1e4)
    _assert_closest(port, hr)

    hr2 = ref(0.0, 1e4, exclude=hr.tri)
    _assert_closest(_port(cl, pack, ro, rd, 0.0, 1e4, exclude=port[1]), hr2,
                    min_hits=0.0)

    hr3 = ref(0.1, 20.0, any_hit=True)
    port3 = _port(cl, pack, ro, rd, 0.1, 20.0, any_hit=True)
    np.testing.assert_array_equal(port3[1] >= 0, np.asarray(hr3.tri) >= 0)

    dead = np.arange(N_RAYS) % 3 == 0
    t_max = np.where(dead, -1.0, 1e4).astype(np.float32)
    hr4 = ref(0.0, jnp.asarray(t_max))
    port4 = _port(cl, pack, ro, rd, 0.0, t_max)
    np.testing.assert_array_equal(port4[1], np.asarray(hr4.tri))
    assert not np.any(port4[1][dead] >= 0)
    np.testing.assert_array_equal(port4[1][~dead], port[1][~dead])
    np.testing.assert_array_equal(port4[0][~dead], port[0][~dead])


def test_traverse_counts_and_empty_lanes(monkeypatch):
    """The wrapper's per-ray counters: a lane with an empty interval
    does not walk; every other lane tests the root, and a lane with a
    hit swept at least one chunk."""
    _, cl, _ = _scenes("half", monkeypatch)
    ro, rd = (torch.from_numpy(x) for x in scenes.rays(N_RAYS, seed=5))
    dead = torch.arange(N_RAYS) % 3 == 0
    t_min = torch.zeros(N_RAYS)
    t_max = torch.where(dead, -1.0, 1e4)
    excl = torch.full((N_RAYS,), -1, dtype=torch.int32)
    t, tri, nodes, leaves = ci.traverse(cl, ro, rd, t_min, t_max, excl,
                                        stats=True)
    t2, tri2 = ci.traverse(cl, ro, rd, t_min, t_max, excl)
    assert torch.equal(tri, tri2) and torch.equal(t, t2)
    assert bool((nodes[dead] == 0).all() and (leaves[dead] == 0).all())
    assert bool((tri[dead] == -1).all() and (t[dead] == ci.BIG).all())
    assert bool((nodes[~dead] >= 1).all() and (leaves[tri >= 0] >= 1).all())
    assert bool((leaves <= nodes).all())
    n_nodes = cl.boxes_q.shape[0] // 3
    assert int(nodes.max()) <= n_nodes
    assert ci.launches == {"closest": 0, "any": 0}  # CPU: no kernel


def test_intersect_bvh_matches_reference():
    verts, tris = scenes.soup(600, seed=3)
    pack = _pack13(verts, tris)
    jbvh = j_build_bvh(verts, tris, leaf_size=4)
    jscene = _JScene(pack, bvh=jbvh)
    tscene = _TScene(pack, build_bvh(verts, tris, leaf_size=4))
    ro, rd = scenes.rays(2000, seed=4)
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)
    tro, trd = torch.from_numpy(ro), torch.from_numpy(rd)
    assert isinstance(jbvh, JBVHArrays)

    hj = j_intersect_bvh(jscene, jro, jrd, 0.0, 1e4)
    ht = intersect_bvh(tscene, tro, trd, 0.0, 1e4)
    _assert_closest([x.numpy() for x in ht], hj)
    hb = intersect_brute(jscene, jro, jrd, 0.0, 1e4)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hb.tri))

    excl = ht.tri
    hj2 = j_intersect_bvh(jscene, jro, jrd, 0.0, 1e4,
                          exclude=jnp.asarray(excl.numpy()))
    ht2 = intersect_bvh(tscene, tro, trd, 0.0, 1e4, exclude=excl)
    _assert_closest([x.numpy() for x in ht2], hj2, min_hits=0.0)

    hj3 = j_intersect_bvh(jscene, jro, jrd, 0.1, 20.0, any_hit=True)
    ht3 = intersect_bvh(tscene, tro, trd, 0.1, 20.0, any_hit=True)
    np.testing.assert_array_equal(ht3.tri.numpy() >= 0,
                                  np.asarray(hj3.tri) >= 0)

    # Hits are detached: traversal is not differentiated.
    ro_g = tro.clone().requires_grad_(True)
    assert not intersect_bvh(tscene, ro_g, trd, 0.0, 1e4).t.requires_grad


def test_sort_key_matches_reference(monkeypatch):
    """Bitwise, including zero direction components, origins outside
    the scene box and empty-interval lanes sorted last."""
    jscene, cl, _ = _scenes("half", monkeypatch)
    ro, rd = scenes.rays(4096, seed=6, spread=15.0)
    rd[::5, 0] = 0.0
    rd[1::7, 2] = -0.0
    key = ci.ray_sort_key(cl, torch.from_numpy(ro), torch.from_numpy(rd))
    ref = _ray_sort_key(jscene.clusters, jnp.asarray(ro), jnp.asarray(rd))
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), np.asarray(ref))
    assert len(np.unique(key.numpy())) > 1000

    t_min = torch.zeros(4096)
    t_max = torch.where(torch.arange(4096) % 2 == 0, -1.0, 1e4)
    perm, *_ = ci.sort_rays(cl, torch.from_numpy(ro), torch.from_numpy(rd),
                            t_min, t_max,
                            torch.full((4096,), -1, dtype=torch.int32))
    assert bool((t_max[perm[2048:]] < 0).all())


def test_front_end_carries_int32_ids(monkeypatch):
    """Ids ride the sort and unsort as int32: values at and above 2^24,
    which a float carry would round, come back exactly, in the caller's
    order."""
    _, cl, pack = _scenes("half", monkeypatch)
    ro, rd = (torch.from_numpy(x) for x in scenes.rays(N_RAYS, seed=7))
    ids = (1 << 24) + torch.arange(N_RAYS, dtype=torch.int32) * 3 + 1
    ids = ids[torch.randperm(N_RAYS, generator=torch.Generator().manual_seed(0))]
    seen = {}

    def echo(cl, ro_s, rd_s, t_min, t_max, exclude, any_hit=False):
        seen["exclude"] = exclude
        return torch.zeros(ro_s.shape[0]), exclude.clone()

    monkeypatch.setattr(ci, "traverse", echo)
    t_min, t_max = torch.zeros(N_RAYS), torch.full((N_RAYS,), 1e4)
    for any_hit in (False, True):
        _, tri, _, _ = ci.intersect_clusters(cl, pack, ro, rd, t_min, t_max,
                                             ids, any_hit=any_hit)
        assert seen["exclude"].dtype == torch.int32
        assert not torch.equal(seen["exclude"], ids)  # sorted, not as given
        assert torch.equal(tri, ids)
