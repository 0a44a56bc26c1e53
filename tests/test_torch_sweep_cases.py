"""K4's contract on the CPU: `sweep_pairs` (which takes its plain
version, `sweep_plain`, for CPU tensors) against a float64 numpy
reference of the same function, on the pair lists the card kernel's
windows must also take: no pair, one pair, only sentinel keys, one chunk
only, every chunk once, keys and rays out of range.

The reference: for each pair, every row of its chunk (the coefficient-
major pack read slot by slot), t = -(ro.n + d) / (rd.n) and the
barycentrics at the hit point in float64, accepted inside (t_min, t_max)
and not the ray's `exclude`; closest by (min t, min id).  Ids are held
equal except on pairs whose float64 decision lies within 1e-4 of a
bound (a float32 edge case), t within rtol 3e-4.
"""

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch.ops import binned_intersect as bi
from rgk_tpu_torch.ops import cluster_intersect as ci
from rgk_tpu_torch.scene import clusters as tclusters
from rgk_tpu_torch.scene.builder import build_tri_pack

N_RAYS = 300
MARGIN = 1e-4


@pytest.fixture(scope="module")
def scene():
    verts, tris = scenes.soup(1000, seed=31)
    pack = np.zeros((tris.shape[0], 13), np.float32)
    pack[:, :12] = build_tri_pack(verts, tris)
    pack[::9, 12] = 1.0  # thin glass never hits
    cl = tclusters.build_clusters(verts, tris, pack)
    ro, rd = scenes.rays(N_RAYS, seed=32)
    rng = np.random.default_rng(33)
    rays = [torch.from_numpy(x) for x in (
        ro, rd, np.full(N_RAYS, 0.1, np.float32),
        rng.uniform(5.0, 40.0, N_RAYS).astype(np.float32),
        np.where(rng.random(N_RAYS) < 0.3, rng.integers(0, 1000, N_RAYS),
                 -1).astype(np.int32))]
    return cl, rays


def _reference(cl, cid, ray_of, rays):
    """-> (t f64 [P], id [P], ambiguous bool [P]) as the module doc says."""
    rows = ci.tri_major(cl.pack).double().numpy()
    ids = ci.tri_major(cl.pack)[:, 13].contiguous().view(torch.int32).numpy()
    ro, rd, t_min, t_max, excl = (x.numpy() for x in rays)
    csz = cl.chunk_halves * tclusters.HALF
    n_chunks = bi._n_chunks(cl)
    p = cid.shape[0]
    out_t = np.full(p, float(bi.BIG))
    out_i = np.full(p, -1, np.int64)
    amb = np.zeros(p, bool)
    for j, (c, r) in enumerate(zip(cid.tolist(), ray_of.tolist())):
        if not (0 <= c < n_chunks and 0 <= r < ro.shape[0]):
            continue
        w = rows[c * csz:(c + 1) * csz]
        o, d = ro[r].astype(np.float64), rd[r].astype(np.float64)
        den = w[:, 0:3] @ d
        with np.errstate(divide="ignore", invalid="ignore"):
            t = -(w[:, 0:3] @ o + w[:, 3]) / den
            hit = o[None] + t[:, None] * d[None]
            beta = w[:, 4] + (hit * w[:, 5:8]).sum(1)
            gamma = w[:, 8] + (hit * w[:, 9:12]).sum(1)
            margins = np.stack([beta, gamma, 1 - beta - gamma,
                                (t - t_min[r]) / np.maximum(abs(t), 1),
                                (t_max[r] - t) / np.maximum(abs(t), 1)])
        ok = np.isfinite(t) & (margins >= 0).all(0) & (ids[c * csz:(c + 1)
                                                            * csz] != excl[r])
        ok &= ids[c * csz:(c + 1) * csz] >= 0
        near = np.isfinite(t) & (np.abs(margins) < MARGIN).any(0)
        if ok.any():
            k = np.lexsort((ids[c * csz:(c + 1) * csz][ok], t[ok]))[0]
            out_t[j] = t[ok][k]
            out_i[j] = ids[c * csz:(c + 1) * csz][ok][k]
            tie = np.sort(t[ok])
            amb[j] = len(tie) > 1 and (tie[1] - tie[0]) < MARGIN * abs(tie[0])
        amb[j] |= bool(near.any())
    return out_t, out_i, amb


def _pairs(kind, cl):
    n_chunks = bi._n_chunks(cl)
    rng = np.random.default_rng(len(kind))
    if kind == "none":
        cid, ray = np.zeros(0, np.int64), np.zeros(0, np.int64)
    elif kind == "one":
        cid, ray = np.array([n_chunks // 2]), np.array([7])
    elif kind == "all_sentinel":
        cid = np.full(40, bi.SENT)
        ray = rng.integers(0, N_RAYS, 40)
    elif kind == "one_chunk":
        cid = np.full(N_RAYS, 3)
        ray = np.arange(N_RAYS)
    elif kind == "every_chunk_once":
        cid = np.arange(n_chunks)
        ray = rng.integers(0, N_RAYS, n_chunks)
    else:  # out of range, then a sentinel tail
        cid = np.concatenate([np.sort(rng.integers(0, n_chunks, 60)),
                              [n_chunks, -3, 0, 1], np.full(10, bi.SENT)])
        ray = np.concatenate([rng.integers(0, N_RAYS, 60),
                              [0, 1, -1, N_RAYS], rng.integers(0, 9, 10)])
    return (torch.from_numpy(np.asarray(cid)).to(torch.int32).contiguous(),
            torch.from_numpy(np.asarray(ray)).to(torch.int32).contiguous())


@pytest.mark.parametrize("kind", ["none", "one", "all_sentinel", "one_chunk",
                                  "every_chunk_once", "out_of_range"])
def test_sweep_pairs_matches_reference(scene, kind):
    cl, rays = scene
    cid, ray_of = _pairs(kind, cl)
    before = dict(bi.launches)
    t, tri = bi.sweep_pairs(cl, cid, ray_of, *rays)
    assert bi.launches == before  # the CPU takes the plain version
    assert t.shape == tri.shape == cid.shape
    assert t.dtype == torch.float32 and tri.dtype == torch.int32
    rt, ri, amb = _reference(cl, cid, ray_of, rays)
    np.testing.assert_array_equal(tri.numpy()[~amb], ri[~amb])
    hit = (ri >= 0) & ~amb & (tri.numpy() == ri)
    np.testing.assert_allclose(t.numpy()[hit], rt[hit], rtol=3e-4, atol=1e-6)
    assert bool((t[tri < 0] == bi.BIG).all())
    if kind in ("none", "all_sentinel"):
        assert bool((tri == -1).all())
    if kind in ("one_chunk", "every_chunk_once"):
        assert (ri >= 0).any()  # the case has hits to compare
    if kind == "out_of_range":
        assert bool((tri[60:62] == -1).all() and (tri[62:64] == -1).all())
        assert bool((tri[-10:] == -1).all())
    assert amb.size == 0 or amb.mean() < 0.05
