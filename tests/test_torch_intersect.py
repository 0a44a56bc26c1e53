"""Port parity: the flat sweep (kernel K1) of rgk_tpu_torch against
rgk_tpu's intersect_brute and its Pallas kernel in interpret mode.

On the CPU `intersect_flat` runs K1's plain version; the CUDA kernel
itself is checked against that plain version by tests/test_torch_cuda.py
and by chip_smoke.py on the card.

Tolerance: winning triangle ids equal; t within rtol 3e-4 / atol 1e-6
where a hit exists (as tests/test_intersect.py), barycentrics atol 1e-5.
The reference sums the dot products in another order (matmuls), which
moves t by a few ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgk_tpu.ops.intersect import intersect_brute
from rgk_tpu.ops.pallas_intersect import (M_TILE, intersect_pallas,
                                          prepare_pack_mp)
from rgk_tpu.scene.builder import append_thinglass_column
from rgk_tpu.scene.builder import build_tri_pack as j_build_tri_pack
from rgk_tpu_torch.ops import flat_intersect as fi
from rgk_tpu_torch.ops.intersect import make_intersector, visibility
from rgk_tpu_torch.scene.builder import build_tri_pack

N_TRIS = 2 * M_TILE + 57  # multi-tile sweep with a ragged tail
N_RAYS = 512


class _JScene:
    def __init__(self, pack13):
        self.tri_pack = jnp.asarray(pack13)
        self.pack_mp = jnp.asarray(prepare_pack_mp(pack13))


def _soup(n_tris, seed, glass_every=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n_tris, 3))
    offsets = rng.normal(0, 0.6, (n_tris, 3, 3))
    verts = (centers[:, None, :] + offsets).reshape(-1, 3).astype(np.float32)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    is_glass = np.zeros(max(1, n_tris), bool)
    if glass_every:
        is_glass[::glass_every] = True
    return append_thinglass_column(
        j_build_tri_pack(verts, tris), np.arange(n_tris), is_glass)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _port(pack13, ro, rd, t_min, t_max, exclude=None, any_hit=False):
    r = ro.shape[0]
    t = torch.from_numpy
    out = fi.intersect_flat(
        t(pack13), t(ro), t(rd),
        t(np.broadcast_to(np.float32(t_min), (r,)).copy()),
        t(np.broadcast_to(np.float32(t_max), (r,)).copy()),
        t(np.full(r, -1, np.int32) if exclude is None
          else exclude.astype(np.int32)),
        any_hit=any_hit)
    return [x.numpy() for x in out]


def _assert_closest_equal(got, ref):
    t, tri, bb, bc = got
    np.testing.assert_array_equal(tri, np.asarray(ref.tri))
    hit = tri >= 0
    np.testing.assert_allclose(t[hit], np.asarray(ref.t)[hit],
                               rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(bb[hit], np.asarray(ref.bary_b)[hit],
                               atol=1e-5)
    np.testing.assert_allclose(bc[hit], np.asarray(ref.bary_c)[hit],
                               atol=1e-5)
    return hit


def test_build_tri_pack_matches_reference():
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(90, 3)).astype(np.float32)
    tris = rng.integers(0, 90, (60, 3)).astype(np.int32)
    np.testing.assert_array_equal(build_tri_pack(verts, tris),
                                  j_build_tri_pack(verts, tris))


def test_plain_matches_brute_and_pallas():
    """Closest hit with a t window, then with exclusion of the first
    pass's winners, against the GEMM oracle and the interpret-mode
    Pallas kernel."""
    pack = _soup(N_TRIS, seed=11, glass_every=9)
    scene = _JScene(pack)
    ro, rd = _rays(N_RAYS, seed=12)
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)

    hb = intersect_brute(scene, jro, jrd, 0.5, 14.0)
    hp = intersect_pallas(scene, jro, jrd, 0.5, 14.0, block=256,
                          interpret=True)
    got = _port(pack, ro, rd, 0.5, 14.0)
    hit = _assert_closest_equal(got, hb)
    _assert_closest_equal(got, hp)
    assert hit.mean() > 0.05
    # Glass rows never win; the window holds.
    assert not np.any(pack[got[1][hit], 12] > 0.5)
    assert np.all((got[0][hit] > 0.5) & (got[0][hit] < 14.0))

    excl = got[1]
    hb2 = intersect_brute(scene, jro, jrd, 0.0, 1e4,
                          exclude=jnp.asarray(excl))
    hp2 = intersect_pallas(scene, jro, jrd, 0.0, 1e4,
                           exclude=jnp.asarray(excl), block=256,
                           interpret=True)
    got2 = _port(pack, ro, rd, 0.0, 1e4, exclude=excl)
    _assert_closest_equal(got2, hb2)
    _assert_closest_equal(got2, hp2)
    assert not np.any((got2[1] == excl) & (excl >= 0))


def test_plain_any_hit_validity():
    """Any-hit: the same rays are occluded as K1 says (the witness t
    may differ; only validity is defined), with K1's witness fields."""
    pack = _soup(N_TRIS, seed=21, glass_every=5)
    scene = _JScene(pack)
    ro, rd = _rays(N_RAYS, seed=22)
    t_max = np.random.default_rng(23).uniform(
        0.0, 20.0, N_RAYS).astype(np.float32)
    hp = intersect_pallas(scene, jnp.asarray(ro), jnp.asarray(rd), 0.1,
                          jnp.asarray(t_max), any_hit=True, block=256,
                          interpret=True)
    hb = intersect_brute(scene, jnp.asarray(ro), jnp.asarray(rd), 0.1,
                         jnp.asarray(t_max))
    t, tri, bb, bc = _port(pack, ro, rd, 0.1, t_max, any_hit=True)
    valid = tri >= 0
    np.testing.assert_array_equal(valid, np.asarray(hp.tri) >= 0)
    np.testing.assert_array_equal(valid, np.asarray(hb.tri) >= 0)
    assert 0.05 < valid.mean() < 0.95
    assert set(np.unique(tri)) <= {0, -1}
    assert not bb.any() and not bc.any()
    assert np.all(t[valid] < t_max[valid])


def test_plain_empty_scene_and_empty_batch():
    """M = 0 (sky-only) gives misses everywhere, as the Pallas kernel
    on its all-padding pack; R = 0 returns empty outputs."""
    pack = np.zeros((0, 13), np.float32)
    ro, rd = _rays(64, seed=31)
    hp = intersect_pallas(_JScene(pack), jnp.asarray(ro), jnp.asarray(rd),
                          0.0, 1e4, block=64, interpret=True)
    for any_hit in (False, True):
        t, tri, bb, bc = _port(pack, ro, rd, 0.0, 1e4, any_hit=any_hit)
        np.testing.assert_array_equal(tri, np.asarray(hp.tri))
        assert np.all(tri == -1) and np.all(t == np.float32(fi.BIG))
        assert not bb.any() and not bc.any()
    out = _port(_soup(8, seed=32), ro[:0], rd[:0], 0.0, 1e4)
    assert all(x.shape == (0,) for x in out)


def test_wrapper_checks_and_cpu_dispatch():
    pack = torch.from_numpy(_soup(40, seed=41))
    ro, rd = (torch.from_numpy(a) for a in _rays(16, seed=42))
    tmin = torch.zeros(16)
    tmax = torch.full((16,), 1e4)
    excl = torch.full((16,), -1, dtype=torch.int32)
    before = dict(fi.launches)
    fi.intersect_flat(pack, ro, rd, tmin, tmax, excl)
    assert fi.launches == before  # CPU tensors take the plain version
    with pytest.raises(TypeError):
        fi.intersect_flat(pack, ro.double(), rd, tmin, tmax, excl)
    with pytest.raises(TypeError):
        fi.intersect_flat(pack, ro, rd, tmin, tmax, excl.long())
    with pytest.raises(ValueError):
        fi.intersect_flat(pack[:, :12].contiguous(), ro, rd, tmin, tmax, excl)
    with pytest.raises(ValueError):
        fi.intersect_flat(pack, ro.t().contiguous().t(), rd, tmin, tmax,
                          excl)
    with pytest.raises(ValueError):
        fi.intersect_flat(pack, ro, rd, tmin[:8], tmax, excl)


def test_intersector_and_visibility():
    """make_intersector broadcasts scalar windows; visibility sees a
    point behind a triangle as occluded and one in front as visible."""
    verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    pack = np.zeros((1, 13), np.float32)
    pack[:, :12] = build_tri_pack(verts, np.array([[0, 1, 2]], np.int32))

    class Scene:
        tri_pack = torch.from_numpy(pack)
        epsilon = torch.tensor(1e-5)

    class Meta:
        n_triangles = 1
        has_bvh = False

    isect = make_intersector(Meta)
    a = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, 2.0]])
    b = torch.tensor([[0.0, 0.0, -2.0], [0.0, 0.0, 1.0]])
    vis = visibility(Scene, isect, a, b)
    assert vis.tolist() == [False, True]
    vis = visibility(Scene, isect, a, b,
                     active=torch.tensor([False, True]))
    assert vis.tolist() == [True, True]
    hit = isect(Scene, b, torch.nn.functional.normalize(a - b, dim=-1),
                0.0, 100.0)
    assert hit.tri.tolist() == [0, -1]
    assert abs(float(hit.t[0]) - 2.0) < 1e-5

