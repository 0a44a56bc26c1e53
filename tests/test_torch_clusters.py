"""Port parity: the host BVH and cluster builds of rgk_tpu_torch
(scene/bvh.py, scene/clusters.py) against rgk_tpu's.

Tolerance: none.  Every array equals the reference's bit for bit (float
arrays compared as int32 bit patterns; pack row 13 holds ids as
NaN-patterned floats), for the numpy and the native SAH builder, on
both leaf layouts: 64-triangle halves (chunk_halves == 1) and whole
tiles with several tiles a chunk (tpc > 1, forced by lowering
CHUNK_CAP in both packages).
"""

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.scene import bvh as jbvh
from rgk_tpu.scene import clusters as jclusters
from rgk_tpu.scene.builder import append_thinglass_column
from rgk_tpu.scene.builder import build_tri_pack as j_build_tri_pack
from rgk_tpu_torch.scene import bvh as tbvh
from rgk_tpu_torch.scene import clusters as tclusters
from rgk_tpu_torch.scene import config as tconfig
from rgk_tpu_torch.scene.arrays import (BVHArrays, ClusterArrays,
                                        scene_from_numpy)


def _numpy_tree(cls, tree, **extra):
    """A reference NamedTuple of jax arrays as the port's, on the CPU."""
    fields = {f: torch.from_numpy(np.array(getattr(tree, f)))
              for f in cls._fields if f not in extra}
    return cls(**fields, **extra)


def _pack13(verts, tris, glass_every=7):
    is_glass = np.zeros(len(tris), bool)
    is_glass[::glass_every] = True
    return append_thinglass_column(j_build_tri_pack(verts, tris),
                                   np.arange(len(tris)), is_glass)


def _use_numpy_builder(monkeypatch):
    monkeypatch.setattr(jbvh, "_load_native_builder", lambda: None)
    monkeypatch.setattr(tbvh, "native_builder", lambda: None)


@pytest.mark.parametrize("builder", ["numpy", "native"])
def test_build_bvh_matches_reference(monkeypatch, builder):
    if builder == "numpy":
        _use_numpy_builder(monkeypatch)
        verts, tris = scenes.soup(1500, seed=3)
    else:
        assert tbvh.native_builder() is not None, "native builder missing"
        verts, tris = scenes.soup(5000, seed=3)
    ref = _numpy_tree(BVHArrays, jbvh.build_bvh(verts, tris, leaf_size=4))
    port = tbvh.build_bvh(verts, tris, leaf_size=4)
    scenes.assert_same(port, ref)
    assert int(port.node_meta[0, 2]) == port.node_meta.shape[0]  # root skip
    assert sorted(port.prim_idx.tolist()) == list(range(len(tris)))


@pytest.mark.parametrize("case,cap,halves", [
    ("soup_5000", None, 1),
    ("soup_1000_tpc2", 4, 4),      # 16 halves under a cap of 4 leaves
    ("soup_5000_tpc8", 8, 16),     # 79 halves under a cap of 8 leaves
    ("soup_1500_numpy", None, 1),
])
def test_build_clusters_matches_reference(monkeypatch, case, cap, halves):
    if cap is not None:
        monkeypatch.setattr(jclusters, "CHUNK_CAP", cap)
        monkeypatch.setattr(tclusters, "CHUNK_CAP", cap)
    if case.endswith("numpy"):
        _use_numpy_builder(monkeypatch)
    n = int(case.split("_")[1])
    verts, tris = scenes.soup(n, seed=n)
    pack = _pack13(verts, tris)
    ref = jclusters.build_clusters(verts, tris, pack)
    port = tclusters.build_clusters(verts, tris, pack)
    assert port.chunk_halves == halves == np.asarray(ref.half_meta).shape[0]
    scenes.assert_same(port, _numpy_tree(ClusterArrays, ref,
                                         chunk_halves=halves))
    # Folded rows: thin glass and padding never hit (n = 0, d = 1).
    tiles = port.pack.shape[0] // 16
    rows = port.pack.view(tiles, 16, 128).transpose(1, 2).reshape(-1, 16)
    ids = rows[:, 13].contiguous().view(torch.int32)
    dead = ids < 0
    dead[ids >= 0] = torch.from_numpy(pack[:, 12] > 0.5)[ids[ids >= 0].long()]
    assert bool((rows[dead, :3] == 0).all() and (rows[dead, 3] == 1).all())
    assert int((ids < 0).sum()) == rows.shape[0] - n


def test_build_clusters_reuses_given_order():
    verts, tris = scenes.soup(3000, seed=9)
    pack = _pack13(verts, tris)
    order = np.asarray(jbvh.build_bvh(verts, tris).prim_idx)
    ref = jclusters.build_clusters(verts, tris, pack, order=order)
    port = tclusters.build_clusters(verts, tris, pack, order=order)
    scenes.assert_same(port, _numpy_tree(ClusterArrays, ref,
                                         chunk_halves=port.chunk_halves))


def test_empty_clusters_match_reference():
    ref = jclusters.empty_clusters()
    scenes.assert_same(tclusters.empty_clusters(),
                       _numpy_tree(ClusterArrays, ref, chunk_halves=2))


def test_colonnade_commit_matches_reference(tmp_path):
    """The 33,960-triangle colonnade commits with BVH and clusters equal
    to scene_from_numpy of the reference's commit."""
    path = scenes.colonnade(tmp_path, 20000)
    tree, _, jmeta, _ = scenes.jax_build(path)
    arrays, meta, builder = tconfig.build_scene(tconfig.load_config(path),
                                                "cpu")
    assert meta.n_triangles == jmeta.n_triangles == 33960
    assert meta.has_bvh and jmeta.has_bvh
    ref = scene_from_numpy(tree, "cpu")
    assert ref.clusters.chunk_halves == 1
    scenes.assert_same(arrays, ref)
    assert builder.sah_builder == "native"
    assert set(builder.timings) == {"load", "sah", "clusters", "upload"}
    assert arrays.bvh.node_meta.shape[0] > 1
    assert arrays.clusters.boxes_q.shape[0] // 3 == 1063
