"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc: it carries the `cuda`
marker and skips without a card.  The file imports no JAX, so it also
runs where JAX is not installed (tests/conftest.py imports JAX, hence
`--noconftest` there):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: the sampler kernel equals the plain sampler on the CPU bit for
bit, and a render through it equals one through the plain sampler on the
card (the BDPT splat image within rtol 1e-5: atomics).  K1 equals
flat_plain bit for bit (it rounds each operation
as the plain version does); elsewhere triangle ids equal on >= 99.99% of
rays (nvcc contracts multiply-adds to FMA, the plain versions do not,
which can flip a hit exactly on an edge); t within rtol 3e-4 / atol 1e-6
where ids agree
(for K2 the reported t, recomputed from the winner's row; its in-kernel
t on >= 99.99% of the hits, since grazing hits cancel in rd.n); any-hit
validity equal on >= 99.99% of rays.  Whole images: the bounds of
bench.py parity_gate (rgk_tpu_torch/parity.py).  The binned kernels
K3/K4: lists, counts and skipmin equal the plain walk's on >= 99.99% of
lanes, K4 as K2; the binned front end's ids equal K2's on >= 99.99% of
rays (they share the slab and row tests); on the far spheres, where the
prefilter's slack must grow with the magnitudes, exactly equal on every
ray whose list did not overflow.  The probes: equal to their plain
versions (the sweeps' t within rtol 3e-4).  K5 (take_rows): its rows
equal the plain version's bit for bit; its backward equals itself bit
for bit run to run and lies within 1e-5 x max|reference| of a float64
sum of the same terms.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch.driver import cli
from rgk_tpu_torch.io import read_exr
from rgk_tpu_torch.ops import binned_intersect as bi
from rgk_tpu_torch.ops import cluster_intersect as ci
from rgk_tpu_torch.ops import flat_intersect as fi
from rgk_tpu_torch.ops import vecmath as vm
from rgk_tpu_torch.parity import image_parity
from rgk_tpu_torch.scene import clusters as tclusters
from rgk_tpu_torch.scene.builder import build_tri_pack
from rgk_tpu_torch.tools import prof_smem_probe as p1
from rgk_tpu_torch.tools import prof_sync as p2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(n_tris, n_rays, seed, dev):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n_tris, 3))
    verts = (centers[:, None, :]
             + rng.normal(0, 0.6, (n_tris, 3, 3))).reshape(-1, 3)
    pack = np.zeros((n_tris, 13), np.float32)
    if n_tris:
        pack[:, :12] = build_tri_pack(verts.astype(np.float32),
                                      np.arange(3 * n_tris).reshape(-1, 3))
    pack[::7, 12] = 1.0
    ro = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return [torch.from_numpy(x).to(dev) for x in (
        pack, ro, rd, np.full(n_rays, 0.5, np.float32),
        np.full(n_rays, 1e4, np.float32), np.full(n_rays, -1, np.int32))]


def _check_against_plain(args, any_hit):
    mode = "any" if any_hit else "closest"
    n0 = fi.launches[mode]
    k = fi.intersect_flat(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    assert fi.launches[mode] == n0 + 1
    p = fi.flat_plain(*args, any_hit=any_hit)
    same = k[1] == p[1]
    assert same.double().mean().item() >= 0.9999
    if not any_hit:
        both = same & (p[1] >= 0)
        torch.testing.assert_close(k[0][both], p[0][both], rtol=3e-4,
                                   atol=1e-6)
    return k


@pytest.mark.parametrize("n_tris,n_rays", [(2 * 256 + 57, 1 << 16),
                                           (0, 1000), (5, 129)])
def test_kernel_matches_plain(cuda_device, n_tris, n_rays):
    """Multi-tile with a ragged tile, sky-only (M = 0), and a ragged ray
    tail; closest hit, an exclude pass over its winners, any hit."""
    args = _inputs(n_tris, n_rays, seed=n_tris + 1, dev=cuda_device)
    k = _check_against_plain(args, any_hit=False)
    excl = k[1].contiguous()
    k2 = _check_against_plain(args[:5] + [excl], any_hit=False)
    assert not bool(((k2[1] == excl) & (excl >= 0)).any())
    _check_against_plain(args, any_hit=True)
    if n_tris == 0:
        assert bool((k[1] == -1).all())


@pytest.mark.parametrize("n_tris,n_rays", [(1, 777), (4096, 3001),
                                           (3 * 128 + 5, 3 * 512 + 1),
                                           (300, 511)])
def test_kernel_edges(cuda_device, n_tris, n_rays):
    """The shapes K1's blocking must cover: M = 1, M = 4096 (the flat
    limit), M not a multiple of the 128-row tile, R not a multiple of the
    512 rays of a block (4 a thread), R below one block; closest hit, an
    exclude pass, any hit; thin-glass rows (every 7th) never hit."""
    args = _inputs(n_tris, n_rays, seed=n_tris + 7, dev=cuda_device)
    for any_hit in (False, True):
        _check_against_plain(args, any_hit)
    k = _check_against_plain(args, any_hit=False)
    assert not bool((k[1][k[1] >= 0] % 7 == 0).any())
    excl = k[1].contiguous()
    k2 = _check_against_plain(args[:5] + [excl], any_hit=False)
    assert not bool(((k2[1] == excl) & (excl >= 0)).any())


def _stack(n_tris, n_rays, dev, facing):
    """n_tris large triangles stacked at z = 1 + 0.01 i, every 7th thin
    glass, and rays from z = 0 inside their footprint, toward them
    (facing) or away."""
    z = 1.0 + 0.01 * np.arange(n_tris, dtype=np.float32)
    verts = np.stack([np.stack([np.full(n_tris, x), np.full(n_tris, y), z],
                               axis=1)
                      for x, y in ((-8, -8), (8, -8), (0, 8))], axis=1)
    pack = np.zeros((n_tris, 13), np.float32)
    pack[:, :12] = build_tri_pack(verts.reshape(-1, 3).astype(np.float32),
                                  np.arange(3 * n_tris).reshape(-1, 3))
    pack[::7, 12] = 1.0
    rng = np.random.default_rng(n_rays)
    ro = np.zeros((n_rays, 3), np.float32)
    ro[:, :2] = rng.uniform(-1, 1, (n_rays, 2))
    rd = np.zeros((n_rays, 3), np.float32)
    rd[:, 2] = 1.0 if facing else -1.0
    rd[:, :2] = rng.uniform(-0.02, 0.02, (n_rays, 2))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return [torch.from_numpy(x).to(dev) for x in (
        pack, ro, rd, np.zeros(n_rays, np.float32),
        np.full(n_rays, 1e4, np.float32), np.full(n_rays, -1, np.int32))]


@pytest.mark.parametrize("n_tris", [2, 200, 4096])
def test_kernel_all_or_no_rays_hit(cuda_device, n_tris):
    """Every ray hits every row of the stack, or none: the closest hit is
    row 1 (row 0 is thin glass), then row 2 with row 1 excluded; any hit
    leaves every warp at its first tile, or sweeps every row."""
    args = _stack(n_tris, 2 * 512 + 33, cuda_device, facing=True)
    k = _check_against_plain(args, any_hit=False)
    assert bool((k[1] == 1).all())
    k2 = _check_against_plain(args[:5] + [k[1].contiguous()], any_hit=False)
    assert bool((k2[1] == 2).all()) if n_tris > 2 else bool(
        (k2[1] == -1).all())
    assert bool((_check_against_plain(args, any_hit=True)[1] == 0).all())
    away = _stack(n_tris, 2 * 512 + 33, cuda_device, facing=False)
    for any_hit in (False, True):
        assert bool((_check_against_plain(away, any_hit)[1] == -1).all())


def _far_sphere(center, radius, cam_dist, n_rays, seed, dev):
    """A closed sphere of 4096 small triangles at `center`, and rays from
    `cam_dist` away aimed at points of random triangles near their edges
    and corners: large coordinates and a far camera put many hits within
    rounding of an edge, where the prefilter's slack must cover the
    rounding of both its form and the exact test's."""
    mb = _module("_make_bigscene", os.path.join(TOOLS, "make_bigscene.py"))
    verts, _, faces = mb.make_sphere(4100, *center, radius)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    pack = np.zeros((faces.shape[0], 13), np.float32)
    pack[:, :12] = build_tri_pack(verts, faces)
    rng = np.random.default_rng(seed)
    corners = verts[faces[rng.integers(0, faces.shape[0], n_rays)]]
    target = (corners * rng.dirichlet([0.3] * 3, n_rays)[:, :, None]).sum(1)
    away = rng.normal(size=(n_rays, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    ro = (np.asarray(center) + cam_dist * away).astype(np.float32)
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (
        pack, ro, rd, np.zeros(n_rays, np.float32),
        np.full(n_rays, 1e4, np.float32), np.full(n_rays, -1, np.int32))]


@pytest.mark.parametrize("scene", ["soup", "far", "tiny"])
def test_kernel_equals_plain_bit_for_bit(cuda_device, scene):
    """K1 computes flat_plain's function in its order and roundings, on a
    random soup and where the prefilter's slack must grow with the
    magnitudes: a sphere of radius 1 at coordinates in the hundreds seen
    from 200 units, and one of radius 0.05 seen from 150.  Closest hit
    (t, id, barycentrics), an exclude pass over its winners and any-hit
    ids equal the plain version's on every ray."""
    if scene == "soup":
        args = _inputs(3 * 128 + 5, 1 << 16, seed=11, dev=cuda_device)
    elif scene == "far":
        args = _far_sphere((300.0, -200.0, 500.0), 1.0, 200.0, 1 << 16, 12,
                           cuda_device)
    else:
        args = _far_sphere((0.0, 0.0, 0.0), 0.05, 150.0, 1 << 16, 13,
                           cuda_device)
    k = fi.intersect_flat(*args)
    assert (k[1] >= 0).double().mean().item() > (0.05 if scene == "soup"
                                                 else 0.9)
    excl = [*args[:5], k[1].contiguous()]
    for a in (args, excl):
        k = fi.intersect_flat(*a)
        p = fi.flat_plain(*a)
        for name, x, y in zip(("t", "tri", "bary_b", "bary_c"), k, p):
            diff = int((x != y).sum())
            assert diff == 0, f"{name} differs from flat_plain on {diff} rays"
    assert torch.equal(fi.intersect_flat(*args, any_hit=True)[1],
                       fi.flat_plain(*args, any_hit=True)[1])


LIVE_RAYS = 1 << 18    # the box's block: one slice at 100% live, sliced below
LIVE_SHARES = (0.0, "one", 0.002, 0.02, 0.27, 1.0)


def _tie_scene(dev, n_rays=LIVE_RAYS, seed=5):
    """3,870 rows: a 16 x 16 grid of unit squares (512 triangles) in the
    plane z = 5, a random soup, and the grid again as the last 512 rows;
    half the rays run up +z from points on the grid's lines, where t
    ties between triangles that share an edge and always between a grid
    row and its copy 3,358 rows on (another slice of a sliced query);
    the rest random, through the soup.  The windows start at 0.5."""
    g = 16
    x, y = np.meshgrid(np.arange(g, dtype=np.float32) - g / 2,
                       np.arange(g, dtype=np.float32) - g / 2)
    x, y = x.ravel(), y.ravel()
    quad = np.stack([np.stack([x + a, y + b, np.full_like(x, 5.0)], axis=1)
                     for a, b in ((0, 0), (1, 0), (1, 1), (0, 1))], axis=1)
    grid = np.concatenate([quad[:, [0, 1, 2]], quad[:, [0, 2, 3]]])
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (3870 - 2 * grid.shape[0], 3))
    soup = centers[:, None, :] + rng.normal(0, 0.6, (centers.shape[0], 3, 3))
    verts = np.concatenate([grid, soup, grid]).astype(np.float32)
    pack = np.zeros((verts.shape[0], 13), np.float32)
    pack[:, :12] = build_tri_pack(verts.reshape(-1, 3),
                                  np.arange(verts.shape[0] * 3).reshape(-1, 3))
    pack[1000::97, 12] = 1.0  # thin glass in the soup
    half = n_rays // 2
    on_line = rng.integers(-g // 2, g // 2, (half, 2)).astype(np.float32)
    along = rng.integers(0, 4 * g, half).astype(np.float32) / 4 - g / 2
    axis = rng.integers(0, 2, half)
    on_line[np.arange(half), axis] = along
    ro = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    ro[:half, :2], ro[:half, 2] = on_line, 0.0
    rd[:half] = (0.0, 0.0, 1.0)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return [torch.from_numpy(a).to(dev) for a in (
        pack, ro, rd, np.full(n_rays, 0.5, np.float32),
        np.full(n_rays, 1e4, np.float32), np.full(n_rays, -1, np.int32))]


def _empty_windows(t_min, t_max, share, seed):
    """t_max with every ray but a scattered `share` of them ("one": a
    single ray) given an empty window: t_max = t_min, -1 or NaN."""
    n = t_max.shape[0]
    rng = np.random.default_rng(seed)
    live = np.zeros(n, bool)
    if share == "one":
        live[rng.integers(n)] = True
    else:
        live[rng.permutation(n)[:int(round(share * n))]] = True
    empty = np.stack([t_min.cpu().numpy(), np.full(n, -1.0, np.float32),
                      np.full(n, np.nan, np.float32)])[rng.integers(0, 3, n),
                                                        np.arange(n)]
    out = np.where(live, t_max.cpu().numpy(), empty).astype(np.float32)
    return torch.from_numpy(out).to(t_max.device), int(live.sum())


def _assert_bit_equal(got, want, what):
    for name, x, y in zip(("t", "tri", "bary_b", "bary_c"), got, want):
        diff = int((x.view(torch.int32) != y.view(torch.int32)).sum())
        assert diff == 0, f"{what}: {name} differs from flat_plain on " \
                          f"{diff} rays"


@pytest.mark.parametrize("scene", ["soup", "ties"])
@pytest.mark.parametrize("share", LIVE_SHARES)
def test_kernel_sweeps_only_live_rays(cuda_device, scene, share):
    """K1 at every live share, from one ray to all 262,144 (one slice an
    item) and below (the rows sliced), the empty windows scattered:
    every output equals flat_plain's bit for bit, closest and any hit
    (any: the lowest accepted id's t), the swept counter reads the live
    rays, and a second run gives the same bits (the slices' atomics)."""
    args = (_inputs(3870, LIVE_RAYS, seed=21, dev=cuda_device)
            if scene == "soup" else _tie_scene(cuda_device))
    args[4], live = _empty_windows(args[3], args[4], share, seed=22)
    for any_hit in (False, True):
        swept = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        with fi.count_swept(swept):
            k = fi.intersect_flat(*args, any_hit=any_hit)
        again = fi.intersect_flat(*args, any_hit=any_hit)
        torch.cuda.synchronize()
        what = f"{scene} {share} {'any' if any_hit else 'closest'}"
        _assert_bit_equal(k, fi.flat_plain(*args, any_hit=any_hit), what)
        _assert_bit_equal(again, k, what + " run to run")
        assert int(swept) == live
        if share == 1.0:
            hits = k[1] >= 0
            assert 0.05 < hits.double().mean().item()
            if scene == "ties" and not any_hit:
                assert int((k[1][hits] < 512).sum()) > 10_000


def test_kernel_graph_serves_every_live_count(cuda_device):
    """One captured K1 query (a closest and an any-hit one) replayed
    with another live count each time: the grid fixed at capture serves
    all of them, bit-equal to flat_plain, the swept counter in the graph
    reading each count."""
    args = _tie_scene(cuda_device)
    full = args[4].clone()
    swept = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    outs = {}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), fi.count_swept(swept):
        for any_hit in (False, True):
            fi.intersect_flat(*args, any_hit=any_hit)  # build, warm
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g), fi.count_swept(swept):
        for any_hit in (False, True):
            outs[any_hit] = fi.intersect_flat(*args, any_hit=any_hit)
    for i, share in enumerate((0.27, 1.0, "one", 0.0, 0.002, 0.02, 1.0)):
        t_max, live = _empty_windows(args[3], full, share, seed=30 + i)
        args[4].copy_(t_max)
        swept.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert int(swept) == 2 * live, share
        for any_hit in (False, True):
            _assert_bit_equal(outs[any_hit],
                              fi.flat_plain(*args, any_hit=any_hit),
                              f"replay {i} ({share})")


def test_slice_render_on_card_matches_cpu(cuda_device, tmp_path):
    mod = _module("_bdpt_scene", os.path.join(TOOLS, "bdpt_scene.py"))
    path = tmp_path / "box.json"
    path.write_text(json.dumps(mod.scene_dict(res=32, ms=4, reverse=0)))
    images = {}
    for name, extra in (("gpu", []), ("cpu", ["--cpu"])):
        before = dict(fi.launches)
        out = tmp_path / name
        assert cli.main([str(path), "-q", "-D", str(out), *extra]) == 0
        images[name] = read_exr(str(out / "bdpt_box.exr"))
        grew = {m: fi.launches[m] > before[m] for m in before}
        assert grew == {"closest": name == "gpu", "any": name == "gpu"}
    stats = image_parity(images["gpu"], images["cpu"])
    assert stats["ok"], stats


def _soup(n_tris, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n_tris, 3))
    verts = (centers[:, None, :]
             + rng.normal(0, 0.6, (n_tris, 3, 3))).reshape(-1, 3)
    verts = verts.astype(np.float32)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    pack = np.zeros((n_tris, 13), np.float32)
    pack[:, :12] = build_tri_pack(verts, tris)
    pack[::7, 12] = 1.0
    return verts, tris, pack


@pytest.mark.parametrize("cap,halves", [(None, 1), (16, 8)])
def test_cluster_kernel_matches_plain(cuda_device, monkeypatch, cap, halves):
    """K2 on both leaf layouts (64-triangle halves; 8-half chunks of 4
    tiles): closest hit, an exclude pass, any hit, a third of the lanes
    with an empty interval; the counters agree too."""
    if cap is not None:
        monkeypatch.setattr(tclusters, "CHUNK_CAP", cap)
    verts, tris, pack = _soup(8000, seed=3)
    cl = tclusters.build_clusters(verts, tris, pack, device=cuda_device)
    assert cl.chunk_halves == halves
    tri_pack = torch.from_numpy(pack).to(cuda_device)
    n = 1 << 16
    _, ro, rd, t_min, t_max, excl = _inputs(0, n, seed=4, dev=cuda_device)
    dead = torch.arange(n, device=cuda_device) % 3 == 0
    t_max = torch.where(dead, -1.0, t_max)
    _, *args = ci.sort_rays(cl, ro, rd, t_min, t_max, excl)

    def check(args, any_hit):
        mode = "any" if any_hit else "closest"
        n0 = ci.launches[mode]
        k = ci.traverse(cl, *args, any_hit=any_hit, stats=True)
        torch.cuda.synchronize()
        assert ci.launches[mode] == n0 + 1
        p = ci.cluster_plain(cl, *args, any_hit=any_hit, stats=True)
        dead_s = ~(args[3] > args[2])
        assert not bool((k[1][dead_s] >= 0).any())
        assert bool((k[2][dead_s] == 0).all())
        same = (k[1] >= 0) == (p[1] >= 0) if any_hit else k[1] == p[1]
        assert same.double().mean().item() >= 0.9999
        assert ((k[2] == p[2]) & (k[3] == p[3])).double().mean() >= 0.999
        if not any_hit:
            both = same & (p[1] >= 0)
            rk = ci.hit_record(tri_pack, args[0], args[1], k[0], k[1])
            rp = ci.hit_record(tri_pack, args[0], args[1], p[0], p[1])
            torch.testing.assert_close(rk[0][both], rp[0][both], rtol=3e-4,
                                       atol=1e-6)
            raw = (k[0][both] - p[0][both]).abs() <= 1e-6 + 3e-4 * p[0][
                both].abs()
            assert raw.double().mean().item() >= 0.9999
        return k

    k = check(args, any_hit=False)
    assert (k[1] >= 0).double().mean().item() > 0.05
    excl_s = k[1].contiguous()
    k2 = check(args[:4] + [excl_s], any_hit=False)
    assert not bool(((k2[1] == excl_s) & (excl_s >= 0)).any())
    check(args, any_hit=True)


@pytest.mark.parametrize("cap,halves", [(None, 1), (16, 8)])
@pytest.mark.parametrize("n", [1, 31, 33, 4097, 200_003])
def test_cluster_kernel_edges(cuda_device, monkeypatch, cap, halves, n):
    """K2's persistent warps on ray counts that are not whole groups of
    32, below one group, and far above one wave of resident warps, on
    both layouts, with empty intervals; two launches in a row (the group
    counter starts again); ids, any-hit validity and the counters equal
    cluster_plain's."""
    if cap is not None:
        monkeypatch.setattr(tclusters, "CHUNK_CAP", cap)
    verts, tris, pack = _soup(8000, seed=6)
    cl = tclusters.build_clusters(verts, tris, pack, device=cuda_device)
    assert cl.chunk_halves == halves
    _, ro, rd, t_min, t_max, excl = _inputs(0, n, seed=n, dev=cuda_device)
    t_max = torch.where(torch.arange(n, device=cuda_device) % 5 == 2, 0.0,
                        t_max)
    _, *args = ci.sort_rays(cl, ro, rd, t_min, t_max, excl)
    for any_hit in (False, True, False):
        k = ci.traverse(cl, *args, any_hit=any_hit, stats=True)
        torch.cuda.synchronize()
        p = ci.cluster_plain(cl, *args, any_hit=any_hit, stats=True)
        same = (k[1] >= 0) == (p[1] >= 0) if any_hit else k[1] == p[1]
        assert same.double().mean().item() >= (0.9999 if n > 1e4 else 1.0)
        assert ((k[2] == p[2]) & (k[3] == p[3])).double().mean() >= (
            0.999 if n > 1e4 else 1.0)
        empty = ~(args[3] > args[2])
        assert not bool((k[1][empty] >= 0).any())
        assert bool((k[2][empty] == 0).all() and (k[3][empty] == 0).all())


def test_colonnade_on_card_matches_cpu(cuda_device, tmp_path):
    """The 33,960-triangle colonnade: the card goes through K2 only, and
    its image passes parity against the port's CPU image."""
    smoke = _module("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    path, n_tris = smoke.write_colonnade(
        str(tmp_path / "scene"), 20000,
        **{"output-width": 32, "output-height": 18, "multisample": 2})
    assert n_tris == 33960
    images = {}
    for name, extra in (("gpu", []), ("cpu", ["--cpu"])):
        before = dict(ci.launches), dict(fi.launches)
        out = tmp_path / name
        assert cli.main([path, "-q", "-D", str(out), *extra]) == 0
        images[name] = read_exr(str(out / "colonnade.exr"))
        assert {m: ci.launches[m] > before[0][m] for m in before[0]} == {
            "closest": name == "gpu", "any": name == "gpu"}
        assert fi.launches == before[1]
    stats = image_parity(images["gpu"], images["cpu"])
    assert stats["ok"], stats


@pytest.mark.parametrize("cap,halves", [(None, 1), (16, 8)])
@pytest.mark.parametrize("K", [8, 2])
def test_binned_kernels_match_plain(cuda_device, monkeypatch, cap, halves, K):
    """K3 and K4 against walk_plain and sweep_plain on both layouts, at
    the default cap and at one that overflows; the binned front end
    against K2's: closest hit, an exclude pass, any hit, a third of the
    lanes with an empty interval."""
    if cap is not None:
        monkeypatch.setattr(tclusters, "CHUNK_CAP", cap)
    verts, tris, pack = _soup(8000, seed=3)
    cl = tclusters.build_clusters(verts, tris, pack, device=cuda_device)
    assert cl.chunk_halves == halves
    tri_pack = torch.from_numpy(pack).to(cuda_device)
    n = 1 << 16
    _, ro, rd, t_min, t_max, excl = _inputs(0, n, seed=5, dev=cuda_device)
    dead = torch.arange(n, device=cuda_device) % 3 == 0
    t_max = torch.where(dead, -1.0, t_max)
    _, *srt = ci.sort_rays(cl, ro, rd, t_min, t_max, excl)

    n0 = dict(bi.launches)
    k = bi.walk(cl, *srt[:4], K, stats=True)
    torch.cuda.synchronize()
    p = bi.walk_plain(cl, *srt[:4], K, stats=True)
    same = ((k[0] == p[0]).all(dim=1) & (k[1] == p[1])
            & (k[2].view(torch.int32) == p[2].view(torch.int32)))
    assert same.double().mean().item() >= 0.9999
    assert (k[3] == p[3]).double().mean().item() >= 0.9999
    empty = ~(srt[3] > srt[2])
    assert bool((k[1][empty] == 0).all() and (k[3][empty] == 0).all())
    if K == 2:
        assert bool((k[1] > K).any())

    cid, pos = bi.make_pairs(k[0])
    ray_of = torch.div(pos, K, rounding_mode="floor").to(torch.int32)
    tk, ik = bi.sweep_pairs(cl, cid, ray_of, *srt)
    torch.cuda.synchronize()
    tp, ip = bi.sweep_plain(cl, cid, ray_of, *srt)
    assert bi.launches == {"walk": n0["walk"] + 1, "sweep": n0["sweep"] + 1}
    listed = cid != bi.SENT
    assert (ik == ip)[listed].double().mean().item() >= 0.9999
    assert not bool((ik[~listed] >= 0).any())
    both = (ik == ip) & (ip >= 0)
    ok = (tk[both] - tp[both]).abs() <= 1e-6 + 3e-4 * tp[both].abs()
    assert ok.double().mean().item() >= 0.9999

    args = [cl, tri_pack, ro, rd, t_min, t_max, excl]
    kb = bi.intersect_clusters_binned(*args, K=K)
    k2 = ci.intersect_clusters(*args)
    assert (kb[1] == k2[1]).double().mean().item() >= 0.9999
    assert (k2[1] >= 0).double().mean().item() > 0.05
    assert not bool((kb[1][dead] >= 0).any())
    x = [cl, tri_pack, ro, rd, t_min, t_max, k2[1].contiguous()]
    kbx = bi.intersect_clusters_binned(*x, K=K)
    assert (kbx[1] == ci.intersect_clusters(*x)[1]).double().mean() >= 0.9999
    assert not bool(((kbx[1] == k2[1]) & (k2[1] >= 0)).any())
    kba = bi.intersect_clusters_binned(*args, any_hit=True, K=K)
    k2a = ci.intersect_clusters(*args, any_hit=True)
    assert ((kba[1] >= 0) == (k2a[1] >= 0)).double().mean() >= 0.9999


def test_probes_match_plain(cuda_device):
    """P1: every shared-memory size up to the opt-in limit launches and
    one step past it is refused with an error code; the unpack gives
    5.0 and the row copies 4n - 1.  P2: every variant equals its plain
    version."""
    limit, rows = p1.smem_ceiling(cuda_device)
    assert limit >= 48 * 1024
    for b, rc, same in rows:
        assert (rc == 0 and same) if b <= limit else rc != 0, (b, rc)
    w, x = p1.unpack_inputs(cuda_device)
    assert bool((p1.unpack(w, x) == 5.0).all())
    for n in p1.ROW_SIZES:
        assert bool((p1.row_copy(p1.row_table(n, cuda_device)) == 4 * n - 1)
                    .all())
    rows = p2.run(cuda_device, iters=2000, reps=1, verbose=False)
    assert [r[0] for r in rows][:len(p2.VARIANTS)] == list(p2.VARIANTS)
    assert all(r[3] for r in rows), [r for r in rows if not r[3]]


def test_binned_colonnade_on_card_matches_cpu(cuda_device, tmp_path,
                                              monkeypatch):
    """The 33,960-triangle colonnade under RGK_BINNED=all: the card goes
    through K3 and K4 (K2 closest only, for pass 2), and its image passes
    parity against the port's CPU image."""
    smoke = _module("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    path, n_tris = smoke.write_colonnade(
        str(tmp_path / "scene"), 20000,
        **{"output-width": 32, "output-height": 18, "multisample": 2})
    assert n_tris == 33960
    monkeypatch.setenv("RGK_BINNED", "all")
    images = {}
    for name, extra in (("gpu", []), ("cpu", ["--cpu"])):
        before = dict(bi.launches), dict(ci.launches), dict(fi.launches)
        out = tmp_path / name
        assert cli.main([path, "-q", "-D", str(out), *extra]) == 0
        images[name] = read_exr(str(out / "colonnade.exr"))
        grew = {m: bi.launches[m] > before[0][m] for m in before[0]}
        assert grew == {"walk": name == "gpu", "sweep": name == "gpu"}
        assert ci.launches["any"] == before[1]["any"]
        assert fi.launches == before[2]
    stats = image_parity(images["gpu"], images["cpu"])
    assert stats["ok"], stats


# ------------------------------------------- K4 and K3 redesign: edge cases


def _soup_tree(dev, monkeypatch, cap, seed=3):
    if cap is not None:
        monkeypatch.setattr(tclusters, "CHUNK_CAP", cap)
    verts, tris, pack = _soup(8000, seed=seed)
    cl = tclusters.build_clusters(verts, tris, pack, device=dev)
    return cl, torch.from_numpy(pack).to(dev)


def _check_sweep(cl, cid, ray_of, rays):
    """K4 against sweep_plain on the same pairs: ids equal on >= 99.99% of
    the pairs with a chunk key and a ray in range, the others 3.4e38 /
    -1; t within rtol 3e-4 where ids agree and hit.  -> kernel ids."""
    n0 = bi.launches["sweep"]
    tk, ik = bi.sweep_pairs(cl, cid, ray_of, *rays)
    torch.cuda.synchronize()
    assert bi.launches["sweep"] == n0 + 1
    tp, ip = bi.sweep_plain(cl, cid, ray_of, *rays)
    real = ((cid >= 0) & (cid < bi._n_chunks(cl)) & (ray_of >= 0)
            & (ray_of < rays[0].shape[0]))
    if bool(real.any()):
        assert (ik == ip)[real].double().mean().item() >= 0.9999
    assert bool((ik[~real] == -1).all() and (tk[~real] == bi.BIG).all())
    both = (ik == ip) & (ip >= 0)
    if bool(both.any()):
        ok = (tk[both] - tp[both]).abs() <= 1e-6 + 3e-4 * tp[both].abs()
        assert ok.double().mean().item() >= 0.9999
    return ik


@pytest.mark.parametrize("cap,halves", [(None, 1), (16, 8)])
@pytest.mark.parametrize("case", ["long_run", "single_runs", "straddle",
                                  "sentinel_tail"])
def test_sweep_runs_and_windows(cuda_device, monkeypatch, cap, halves, case):
    """K4's warps of 32 sorted pairs on both layouts: one chunk listed by
    12,000 pairs (a run longer than any block's share of the work),
    back-to-back single-pair runs, runs of 300, 511, 513, 1 and 37 pairs
    that straddle the warps' 32-pair edges, and an all-SENT tail after
    keys and rays out of range."""
    cl, _ = _soup_tree(cuda_device, monkeypatch, cap)
    assert cl.chunk_halves == halves
    n_chunks = bi._n_chunks(cl)
    n = 1 << 14
    _, ro, rd, t_min, t_max, excl = _inputs(0, n, seed=17, dev=cuda_device)
    rays = [ro, rd, t_min, t_max, excl]
    rng = np.random.default_rng(n_chunks + len(case))
    if case == "long_run":
        # The chunk most rays' lists hold, for 12,000 pairs.
        ids = bi.walk(cl, ro, rd, t_min, t_max, 8)[0]
        listed = ids[ids >= 0].long()
        c = int(torch.bincount(listed).argmax())
        hold = torch.nonzero((ids == c).any(dim=1)).flatten()
        ray_of = hold[torch.arange(12_000, device=cuda_device) % hold.numel()]
        cid = torch.full((12_000,), c, dtype=torch.int32, device=cuda_device)
        ray_of = ray_of.to(torch.int32)
    elif case == "single_runs":
        cid = torch.arange(2500, device=cuda_device) % n_chunks
        ray_of = torch.from_numpy(rng.integers(0, n, 2500)).to(cuda_device)
    elif case == "straddle":
        lens = np.resize([300, 511, 513, 1, 37], n_chunks)
        cid = torch.from_numpy(np.repeat(np.arange(n_chunks), lens))
        ray_of = torch.from_numpy(rng.integers(0, n, cid.numel()))
    else:
        p = 5000
        cid = torch.from_numpy(np.sort(rng.integers(0, n_chunks, p)))
        cid[-700:] = bi.SENT
        cid[100] = n_chunks
        cid[101] = -5
        ray_of = torch.from_numpy(rng.integers(0, n, p))
        ray_of[200:203] = torch.tensor([-1, n, 10 ** 6])
    cid = cid.to(device=cuda_device, dtype=torch.int32).contiguous()
    ray_of = ray_of.to(device=cuda_device, dtype=torch.int32).contiguous()
    ik = _check_sweep(cl, cid, ray_of, rays)
    assert (ik >= 0).double().mean().item() > 0.01
    assert torch.equal(_check_sweep(cl, cid, ray_of, rays), ik)


@pytest.mark.parametrize("p", [0, 1, 31, 33, 4097])
def test_sweep_pair_counts(cuda_device, monkeypatch, p):
    """K4 at no pair, one pair, below and above one warp's 32 pairs, and
    a ragged block of 128."""
    cl, _ = _soup_tree(cuda_device, monkeypatch, None)
    _, ro, rd, t_min, t_max, excl = _inputs(0, 4096, seed=p, dev=cuda_device)
    rng = np.random.default_rng(p)
    cid = torch.from_numpy(np.sort(rng.integers(0, bi._n_chunks(cl), p)))
    ray_of = torch.from_numpy(rng.integers(0, 4096, p))
    cid = cid.to(device=cuda_device, dtype=torch.int32)
    ray_of = ray_of.to(device=cuda_device, dtype=torch.int32)
    if p == 0:
        t, tri = bi.sweep_pairs(cl, cid, ray_of, ro, rd, t_min, t_max, excl)
        assert t.shape == (0,) and tri.shape == (0,)
    else:
        _check_sweep(cl, cid, ray_of, [ro, rd, t_min, t_max, excl])


@pytest.mark.parametrize("cap,halves", [(None, 1), (16, 8)])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_walk_edges(cuda_device, monkeypatch, cap, halves, order):
    """K3 on both layouts: lists (written once, -1 in the unused slots),
    counts, skipmin and node counts equal walk_plain's, at K = 8 and at
    K = 2 (overflow), on rays in the sort key's order and in no order, a
    third with an empty interval, and on ray counts below one warp and
    one block."""
    cl, _ = _soup_tree(cuda_device, monkeypatch, cap)
    assert cl.chunk_halves == halves
    for n in (1, 33, 5000):
        _, ro, rd, t_min, t_max, excl = _inputs(0, n, seed=n + 40,
                                                dev=cuda_device)
        t_max = torch.where(torch.arange(n, device=cuda_device) % 3 == 0,
                            -1.0, t_max)
        if order == "sorted":
            _, ro, rd, t_min, t_max, excl = ci.sort_rays(cl, ro, rd, t_min,
                                                         t_max, excl)
        for K in (8, 2):
            n0 = bi.launches["walk"]
            k = bi.walk(cl, ro, rd, t_min, t_max, K, stats=True)
            torch.cuda.synchronize()
            assert bi.launches["walk"] == n0 + 1
            p = bi.walk_plain(cl, ro, rd, t_min, t_max, K, stats=True)
            same = ((k[0] == p[0]).all(dim=1) & (k[1] == p[1])
                    & (k[2].view(torch.int32) == p[2].view(torch.int32))
                    & (k[3] == p[3]))
            assert bool(same.all())


@pytest.mark.parametrize("scene", ["far", "tiny"])
def test_sweep_keeps_k2_winner(cuda_device, scene):
    """K4's accept decisions and in-kernel t are K2's (its prefilter only
    lets rows through to cluster_common.cuh's exact stages), where the
    prefilter's slack must grow with the magnitudes: a sphere of radius 1
    at coordinates in the hundreds seen from 200 units, and one of radius
    0.05 seen from 150.  On a ray whose list holds every leaf it passes
    (no overflow), the listed chunks include the one where K2 found its
    winner, so the best of the ray's K4 results is K2's winner or one K2
    pruned within rounding, never later in (t, id) order; the two differ
    on few rays.  Closest hit and an exclude pass.  The whole binned
    front end against K2's front end: the contract of ROADMAP.md section
    3, fault 1 (scenes.assert_binned_contract): where the ids differ,
    both hit the same point within rounding of the exhaustive oracle
    (either may be the later one in (t, id) here; on the plain route the
    binned hit never is)."""
    cl, pack, rays = scenes.far_sphere_tree(cuda_device, scene)
    _, *srt = ci.sort_rays(cl, *rays)
    K = bi.DEFAULT_K
    ids, cnt, _ = bi.walk(cl, *srt[:4], K)
    fits = cnt <= K
    assert fits.double().mean().item() > 0.3
    cid, pos = bi.make_pairs(ids)
    ray_of = torch.div(pos, K, rounding_mode="floor").to(torch.int32)
    for excl in (srt[4], None):
        if excl is None:  # the exclude pass over K2's winners
            excl = ci.traverse(cl, *srt)[1].contiguous()
        a = [*srt[:4], excl]
        kt, ki = ci.traverse(cl, *a)
        assert (ki >= 0).double().mean().item() > 0.9
        bt, bid = bi.reduce_pairs(*bi.sweep_pairs(cl, cid, ray_of, *a), pos,
                                  K)
        later = (bt > kt) | ((bt == kt) & (bid > ki))
        assert int(later[fits].sum()) == 0, (
            f"K4 lost K2's winner on {int(later[fits].sum())} rays")
        differ = (bid != ki) & fits
        assert int(differ.sum()) <= 1e-3 * differ.numel()
    # The whole binned front end against K2's (ROADMAP.md section 3).
    args = [cl, pack, *rays]
    n_diff, earlier, later = scenes.assert_binned_contract(
        pack, rays, bi.intersect_clusters_binned(*args),
        ci.intersect_clusters(*args), never_later=False)
    print(f"{scene}: K4's best differs from K2's winner on "
          f"{int(differ.sum())} of {int(fits.sum())} rays without overflow "
          f"(exclude pass), never later; the binned front end's id "
          f"differs from K2's on {n_diff} of {fits.numel()} rays, within "
          f"the contract (binned earlier on {earlier}, later on {later})")


# ------------------------------------------------ BDPT and thin glass


def _bdpt_box(tmp_path, res, ms, reverse, sphere=0, glass=False):
    """chip_smoke.write_bdpt's box (tools/bdpt_scene, plus a sphere OBJ
    of `sphere` triangles, with `glass` a tinted thin-glass pane)."""
    smoke = _module("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    return smoke.write_bdpt(str(tmp_path), f"box_r{reverse}_s{sphere}_g"
                            f"{int(glass)}_{res}", res, ms, reverse, sphere,
                            glass)


@pytest.mark.parametrize("sphere,reverse,tint", [(0, 2, False), (5000, 2, False),
                                                 (0, 0, True), (5000, 2, True)])
def test_bdpt_and_glass_renders_on_card_match_cpu(cuda_device, tmp_path,
                                                  sphere, reverse, tint):
    """BDPT and tint-thinglass renders (the box, and the box plus a
    5000-triangle sphere, a BVH scene) at 32x32, 4 spp: the card goes
    through K1 only on the flat scene and K2 only on the BVH scene, and
    its image passes parity against its CPU twin (the plain kernels)."""
    path = _bdpt_box(tmp_path, 32, 4, reverse, sphere, tint)
    images = {}
    for name, extra in (("gpu", []), ("cpu", ["--cpu"])):
        before = dict(fi.launches), dict(ci.launches)
        out = tmp_path / name
        assert cli.main([path, "-q", "-D", str(out), *extra]) == 0
        images[name] = read_exr(str(out / "bdpt_box.exr"))
        k1 = fi.launches["any"] > before[0]["any"]
        k2 = ci.launches["any"] > before[1]["any"]
        on_card = name == "gpu"
        assert (k1, k2) == (on_card and not sphere, on_card and bool(sphere))
    stats = image_parity(images["gpu"], images["cpu"])
    assert stats["ok"], stats


def test_splat_scatter_contract(cuda_device, tmp_path):
    """The splat image of one BDPT block on the card, scattered twice
    from the same splats: the two agree within rtol 1e-5 (atomics add in
    another order each run), and with the CPU's scatter of the same
    splats to the same bound; a whole card render twice, too."""
    from rgk_tpu_torch.integrator import path as tpath
    from rgk_tpu_torch.scene import config as tconfig

    cfg = tconfig.load_config(_bdpt_box(tmp_path, 64, 16, 4))
    arrays, meta, _ = tconfig.build_scene(cfg, cuda_device)
    cam = cfg.get_camera().to(cuda_device)
    pix = torch.arange(64 * 64, device=cuda_device)
    n = 16 * pix.numel()
    ctx = tpath.smp.SampleCtx(seed=42, pixel=pix.repeat(16),
                              sample=torch.arange(16, device=cuda_device)
                              .repeat_interleave(pix.numel()), n_set=16)
    su = tpath._setup(arrays, meta, cfg.settings)
    _, spix, sval, _ = tpath._trace_light_subpaths(
        arrays, meta, cfg.settings, cam, ctx, su,
        tpath._sample_path_light(arrays, ctx),
        tpath.smp.sample_2d(ctx, tpath.smp.DIM_LIGHTDIR), 4)
    assert spix.shape == (n, 4)
    spix, sval = spix.reshape(-1), sval.reshape(-1, 3)
    assert (spix >= 0).double().mean().item() > 0.1
    a = tpath._splat_image(spix, sval, 64 * 64)
    b = tpath._splat_image(spix, sval, 64 * 64)
    c = tpath._splat_image(spix.cpu(), sval.cpu(), 64 * 64)
    for x in (b, c.to(cuda_device)):
        torch.testing.assert_close(x, a, rtol=1e-5, atol=1e-6)
    images = []
    for run in ("a", "b"):
        out = tmp_path / run
        assert cli.main([_bdpt_box(tmp_path, 32, 4, 2), "-q", "-D",
                         str(out)]) == 0
        images.append(read_exr(str(out / "bdpt_box.exr")))
    np.testing.assert_allclose(images[1], images[0], rtol=1e-5, atol=1e-6)


def test_4m_ray_any_hit_query(cuda_device, tmp_path):
    """The BDPT splat visibility query at the smoke's size: 65,536
    pixels x 16 samples x 4 light vertices = 4,194,304 any-hit rays in
    one K1 launch (launch grid and int32 offsets at that size), against
    flat_plain on every 4th ray."""
    from rgk_tpu_torch.scene import config as tconfig

    cfg = tconfig.load_config(_bdpt_box(tmp_path, 16, 1, 4))
    arrays, _, _ = tconfig.build_scene(cfg, cuda_device)
    n = 65_536 * 16 * 4
    rng = np.random.default_rng(9)
    lo = np.asarray([-2.1, 0.05, -2.1], np.float32)
    hi = np.asarray([2.1, 2.55, 2.1], np.float32)
    pts = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).astype(np.float32)
                           ).to(cuda_device)
    cam = torch.tensor([0.0, 1.6, 4.2], device=cuda_device).expand(n, 3)
    d = pts - cam
    dist = torch.linalg.norm(d, dim=1)
    eps = float(arrays.epsilon) * 20.0
    args = [arrays.tri_pack, cam.contiguous(), (d / dist[:, None]).contiguous(),
            torch.full((n,), eps, device=cuda_device),
            (dist - eps).contiguous(),
            torch.full((n,), -1, dtype=torch.int32, device=cuda_device)]
    n0 = fi.launches["any"]
    k = fi.intersect_flat(*args, any_hit=True)
    torch.cuda.synchronize()
    assert fi.launches["any"] == n0 + 1 and k[1].shape == (n,)
    sub = [a[::4].contiguous() for a in args[1:]]
    p = fi.flat_plain(arrays.tri_pack, *sub, any_hit=True)
    assert torch.equal(k[1][::4], p[1])
    assert 0.02 < (p[1] >= 0).double().mean().item() < 0.98


# ---- gradients, the debug replay and distribution on the card ---------


def _grad_scene(tmp_path, dev):
    from rgk_tpu_torch.diff.params import extract_params, make_loss_fn
    from rgk_tpu_torch.scene import config as tconfig

    cfg = tconfig.load_config(scenes.write_config(tmp_path,
                                                  scenes.GRAD_SCENE))
    arrays, meta, _ = tconfig.build_scene(cfg, dev, build_bvh=False)
    i = torch.arange(64)
    loss_fn = make_loss_fn(arrays, meta, cfg.settings, cfg.get_camera(),
                           (i % 8).to(torch.int32), (i // 8).to(torch.int32),
                           torch.zeros(64, dtype=torch.int64), 3,
                           torch.zeros(64, 3))
    return loss_fn, extract_params(arrays)


@pytest.mark.parametrize("key,idx,eps,rtol", [
    ("mat_diffuse", 0, 1e-3, 0.03), ("mat_emission", 3, 1e-3, 0.03),
    ("light_intensity", 0, 1e-3, 0.03), ("sky_intensity", 0, 1e-3, 0.03),
    ("mat_roughness", 2, 2e-4, 0.08), ("mat_specular", 6, 1e-3, 0.05)])
def test_grad_through_k1_matches_finite_differences(cuda_device, tmp_path,
                                                    key, idx, eps, rtol):
    """tests/test_grad.py's scene on the card: the forward goes through
    K1, the backward gives finite gradients, and the checked leaf's
    gradient matches central differences of the card's own loss (eps
    and rtol as tests/test_grad.py's, + 1e-6).  The roughness moves the
    glossy bounce's rays, so its gradient needs K1's hit points
    differentiated along the ray, as on the CPU."""
    loss_fn, params = _grad_scene(tmp_path, cuda_device)
    n0 = fi.launches["closest"] + fi.launches["any"]
    loss = loss_fn(params)
    assert fi.launches["closest"] + fi.launches["any"] > n0
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    for g in grads:
        assert g is None or bool(torch.isfinite(g).all())
    g_val = float(dict(zip(params, grads))[key].reshape(-1)[idx])
    flat = params[key].detach().reshape(-1).double()

    def loss_at(v):
        arr = flat.clone()
        arr[idx] = v
        with torch.no_grad():
            return float(loss_fn({**params, key: arr.reshape(
                params[key].shape).float()}))

    fd = (loss_at(float(flat[idx]) + eps)
          - loss_at(float(flat[idx]) - eps)) / (2 * eps)
    assert abs(g_val - fd) <= rtol * max(abs(fd), abs(g_val)) + 1e-6, (
        g_val, fd)


def test_grad_through_k1_matches_cpu(cuda_device, tmp_path):
    """The same scene's gradients on the card and on the CPU: every leaf
    within 5e-3 * max|g_cpu| + 1e-6.  Dropping the hit point's term
    along the ray moves the roughness's gradient by 2.5% on the CPU."""
    grads = []
    for dev in (cuda_device, "cpu"):
        loss_fn, params = _grad_scene(tmp_path, dev)
        got = torch.autograd.grad(loss_fn(params), list(params.values()),
                                  allow_unused=True)
        grads.append({k: (torch.zeros_like(v) if g is None else g).cpu()
                      for (k, v), g in zip(params.items(), got)})
    card, cpu = grads

    def top(x):
        return float(x.abs().max()) if x.numel() else 0.0

    for k, want in cpu.items():
        assert top(card[k] - want) <= 5e-3 * top(want) + 1e-6, k


def test_debug_replay_on_card_matches_cpu(cuda_device, tmp_path):
    """The -d replay of one pixel on the card and on the CPU: the same
    triangles, materials and decisions, positions within rtol 1e-4."""
    from rgk_tpu_torch.integrator.debug import trace_pixel_debug

    path = scenes.write_config(tmp_path, scenes.box_config(
        res=16, ms=4, **{"recursion-max": 6}))
    recs = {}
    for dev in ("cpu", cuda_device):
        arrays, meta, cfg = scenes.port_build(path, dev)
        recs[str(dev)] = trace_pixel_debug(
            arrays, meta, cfg.settings, cfg.get_camera(), 8, 10,
            printer=lambda *_: None)
    cpu, gpu = recs["cpu"], recs[str(cuda_device)]
    assert len(cpu) >= 2
    for a, b in zip(cpu, gpu):
        for k in ("tri", "mat_id", "hit", "sky"):
            assert a[k] == b[k], k
    np.testing.assert_allclose(gpu[0]["pos"], cpu[0]["pos"], rtol=1e-4,
                               atol=1e-6)


def test_distributed_world_size_one_equals_plain(cuda_device, tmp_path):
    """One NCCL process (`--coordinator ... --num-processes 1`) and a
    one-card mesh (`--devices 1`) write the EXR and checkpoint of a plain
    CLI render bit for bit."""
    import socket
    import subprocess
    import sys

    path = scenes.write_config(tmp_path, scenes.box_config(res=32, ms=2))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    runs = {"plain": [], "devices": ["--devices", "1"],
            "nccl": ["--coordinator", f"localhost:{port}",
                     "--num-processes", "1", "--process-id", "0"]}
    out = {}
    for name, extra in runs.items():
        d = tmp_path / name
        proc = subprocess.run(
            [sys.executable, "-m", "rgk_tpu_torch.driver.cli", path, "-q",
             "-D", str(d), *extra], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        with np.load(str(d / "bdpt_box.exr.ckpt.npz")) as ck:
            out[name] = (read_exr(str(d / "bdpt_box.exr")),
                         {k: ck[k] for k in ck.files})
    for name in ("devices", "nccl"):
        np.testing.assert_array_equal(out[name][0], out["plain"][0])
        for k, v in out["plain"][1].items():
            np.testing.assert_array_equal(out[name][1][k], v, err_msg=k)


def test_initialize_defaults_to_nccl(cuda_device):
    """`multihost.initialize` without a device joins an NCCL group."""
    import socket

    from rgk_tpu_torch.parallel import multihost

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    multihost.initialize(f"localhost:{port}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
    finally:
        torch.distributed.destroy_process_group()


# ---- the queued loop as CUDA graphs (integrator/graph.py)


def _graph_scene(tmp_path, case):
    """The box at 64x64, 4 spp: flat (K1), plus a 5000-triangle sphere
    (K2), BDPT at reverse 2 (K1)."""
    cfg = scenes.box_config(res=64, ms=4, reverse=2 if case == "bdpt" else 0)
    if case == "sphere":
        cfg = scenes.add_sphere(tmp_path, cfg, n_tris=5000)
    arrays, meta, c = scenes.port_build(
        scenes.write_config(tmp_path, cfg, f"{case}.json"), "cuda")
    return arrays, meta, c.settings, c.get_camera().to("cuda")


def _graph_block(n=1024, first=300):
    pix = torch.arange(first, first + n, device="cuda")
    return (pix % 64).to(torch.int32), (pix // 64).to(torch.int32)


@pytest.mark.parametrize("case", ["flat", "sphere", "bdpt"])
def test_queued_graph_equals_eager(cuda_device, tmp_path, case):
    """Graph replays against the eager loop on the card, two blocks
    through one runner: radiance and rays bit-equal, the BDPT splat
    image within rtol 1e-5 (its scatter adds with atomics)."""
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.integrator import path as tpath

    arrays, meta, s, cam = _graph_scene(tmp_path, case)
    eager = (tpath.trace_wavefront_queued_bdpt_eager if case == "bdpt"
             else tpath.trace_wavefront_queued_eager)
    runner = graph.QueuedGraph(arrays, meta, s, cam, 1024, 4)
    for first, s0, seed in ((300, 0, 42), (2000, 8, 9)):
        px, py = _graph_block(first=first)
        got = [t.clone() for t in runner.trace(px, py, s0, seed, cam)]
        want = eager(arrays, meta, s, cam, px, py, s0, 4, seed)
        assert torch.equal(got[0], want[0]) and torch.equal(got[-1], want[-1])
        if case == "bdpt":
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)


def _queued_runner(route, k, *args):
    """A queued runner through the WHILE graph ("device"), or
    chip_smoke's HostReadGraph reading the end test every k replays
    ("host")."""
    from rgk_tpu_torch.integrator import graph

    if route == "device":
        return graph.QueuedGraph(*args)
    smoke = _module("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    return smoke.HostReadGraph(*args, k=k)


@pytest.mark.parametrize("route", ["device", "host"])
def test_queued_graph_replay_does_not_sync(cuda_device, tmp_path, route):
    """A block under set_sync_debug_mode("warn"): through the WHILE graph
    nothing syncs (no end-test read, no step past the end); on the host
    route (k = 2) the only syncs are its end-test reads."""
    import warnings

    from rgk_tpu_torch.integrator import graph

    arrays, meta, s, cam = _graph_scene(tmp_path, "sphere")
    runner = _queued_runner(route, 2, arrays, meta, s, cam, 1024, 4)
    px, py = _graph_block()
    acc = torch.zeros((64 * 64 + 1, 3), device="cuda")
    rays = torch.zeros((), dtype=torch.int64, device="cuda")
    runner.accumulate(acc, rays, torch.arange(1024, device="cuda"))
    graph.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runner.block(px, py, 0, 42, cam)
            runner.accumulate(acc, rays, torch.arange(1024, device="cuda"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    st = graph.read_stats()
    if route == "host":
        assert len(syncs) == st["flag_reads"] == -(-st["replays"] // 2)
        assert 0 <= st["overshoot"] < 2
    else:
        assert len(syncs) == st["flag_reads"] == st["overshoot"] == 0
        assert st["replays"] == st["iterations"] > 0
        assert st["setter_runs"] == st["iterations"] + 1


@pytest.mark.parametrize("route", ["device", "host"])
def test_queued_graph_launch_counts(cuda_device, tmp_path, route):
    """The launch counters after a block through the WHILE graph (read
    with the statistics) or through replays read every step equal the
    eager loop's for the same block."""
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.integrator import path as tpath

    arrays, meta, s, cam = _graph_scene(tmp_path, "flat")
    runner = _queued_runner(route, 1, arrays, meta, s, cam, 1024, 4)
    px, py = _graph_block()
    n0 = dict(fi.launches)
    tpath.trace_wavefront_queued_eager(arrays, meta, s, cam, px, py, 0, 4, 42)
    eager = {m: fi.launches[m] - n0[m] for m in n0}
    graph.reset_stats()
    n0 = dict(fi.launches)
    runner.block(px, py, 0, 42, cam)
    st = graph.read_stats()
    got = {m: fi.launches[m] - n0[m] for m in n0}
    assert st["replays"] == st["iterations"] and st["overshoot"] == 0
    # One closest-hit and one any-hit query an iteration.
    assert got == eager == {"closest": st["iterations"],
                            "any": st["iterations"]}


@pytest.mark.parametrize("case", ["flat", "sphere", "bdpt"])
def test_queued_while_equals_host_route(cuda_device, tmp_path, case):
    """Two blocks through the WHILE graph and through the host route
    (k = 4): radiance and rays bit-equal, the BDPT splat image within
    rtol 1e-5 (atomics), the same iterations; no end-test read and no
    step past the end on the device route."""
    from rgk_tpu_torch.integrator import graph

    arrays, meta, s, cam = _graph_scene(tmp_path, case)
    dev_r = graph.QueuedGraph(arrays, meta, s, cam, 1024, 4)
    host_r = _queued_runner("host", 4, arrays, meta, s, cam, 1024, 4)
    for first, s0, seed in ((300, 0, 42), (2000, 8, 9)):
        px, py = _graph_block(first=first)
        graph.reset_stats()
        got = [t.clone() for t in dev_r.trace(px, py, s0, seed, cam)]
        st = graph.read_stats()
        graph.reset_stats()
        want = host_r.trace(px, py, s0, seed, cam)
        st_host = graph.read_stats()
        assert torch.equal(got[0], want[0]) and torch.equal(got[-1], want[-1])
        if case == "bdpt":
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
        assert st["flag_reads"] == st["overshoot"] == 0
        assert st["iterations"] == st_host["iterations"] > 0
        assert st_host["flag_reads"] > 0


def test_while_graph_runs_a_counting_loop(cuda_device):
    """A WHILE graph around three tiny captures: the body runs while the
    flag holds (x counts to n), the setter's counter gains bodies + 1 a
    launch, and a flag false after the prologue runs no body."""
    from rgk_tpu_torch.ops import graph_while as gw

    x = torch.zeros((), dtype=torch.int64, device="cuda")
    n = torch.full((), 10, dtype=torch.int64, device="cuda")
    flag = torch.ones((), dtype=torch.bool, device="cuda")
    runs = torch.zeros((), dtype=torch.int64, device="cuda")
    side = torch.cuda.Stream()

    def capture(fn):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, stream=side):
            fn()
        return g

    pro = capture(lambda: (x.zero_(), flag.copy_(x < n)))
    body = capture(lambda: (x.add_(1), flag.copy_(x < n)))
    epi = capture(lambda: x.mul_(2))
    loop = gw.WhileGraph(body, flag, runs, pro, epi)
    loop.launch()
    torch.cuda.synchronize()
    assert int(x) == 20 and int(runs) == 11
    n.fill_(0)
    loop.launch()
    torch.cuda.synchronize()
    assert int(x) == 0 and int(runs) == 12
    assert gw.node_count(body) >= 2
    assert gw.driver_version() >= 12040  # conditional WHILE nodes


def test_while_graph_refuses_an_event_record(cuda_device):
    """A capture that holds an event record node (an external event
    recorded on the capturing stream) is refused by name; nothing is
    built."""
    from rgk_tpu_torch.ops import graph_while as gw

    flag = torch.ones((), dtype=torch.bool, device="cuda")
    runs = torch.zeros((), dtype=torch.int64, device="cuda")
    ev = torch.cuda.Event(external=True)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=torch.cuda.Stream()):
        flag.fill_(False)
        ev.record()
    with pytest.raises(RuntimeError, match="event record"):
        gw.WhileGraph(g, flag, runs)


def test_stamp_kernel_times_a_stretch(cuda_device):
    """The phase stamp on the card: a mark, then a stamp after a sleep of
    the device adds the sleep's length into its slot, and a stamp into
    another slot adds the rest; slot -1 only marks."""
    from rgk_tpu_torch.ops import graph_while as gw

    acc = torch.zeros(4, dtype=torch.int64, device="cuda")
    gw.stamp(acc)
    torch.cuda._sleep(2_000_000)
    gw.stamp(acc, 2)
    gw.stamp(acc, 3)
    torch.cuda.synchronize()
    got = acc.tolist()
    assert got[2] > 100_000 and 0 <= got[3] < got[2]
    assert got[1] > 0 and got[0] == 0


# The queued step's captured body on the 512x512 box with a 3,900-triangle
# sphere (K1), its stamp and counter nodes included: a change to the
# step's ops or to what it counts changes it (686 before the BxDF kernel).
STAMPED_BODY_NODES = 384


def test_queued_graph_stamps_match_events(cuda_device, tmp_path):
    """A block of the box with a 3,900-triangle sphere at 512x512 (K1):
    the stamped step time `step_ns` lies within 2% of CUDA events around
    the block's WHILE launch; `live_lanes` is the block's ray counter;
    the captured body with its stamp nodes passes the WHILE graph's
    node-type check and holds STAMPED_BODY_NODES nodes."""
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.ops import graph_while as gw

    res = 512
    cfg = scenes.add_sphere(tmp_path, scenes.box_config(res=res, ms=1),
                            n_tris=3900)
    arrays, meta, c = scenes.port_build(
        scenes.write_config(tmp_path, cfg, "stamps.json"), "cuda")
    s, cam = c.settings, c.get_camera().to("cuda")
    pix = torch.arange(res * res, device="cuda")
    px, py = (pix % res).to(torch.int32), (pix // res).to(torch.int32)
    runner = graph.QueuedGraph(arrays, meta, s, cam, res * res, 1)
    runner.block(px, py, 0, 42, cam)
    torch.cuda.synchronize()
    graph.reset_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.no_grad():
        runner._load(px, py, 1, 43, cam)
        ev[0].record()
        runner._launch()
        ev[1].record()
    torch.cuda.synchronize()
    st = graph.read_stats()
    ms = ev[0].elapsed_time(ev[1])
    assert st["iterations"] > 0 and st["intersect_ns"] > 0
    assert abs(st["step_ns"] / 1e6 - ms) <= 0.02 * ms, (st["step_ns"], ms)
    assert st["live_lanes"] == int(runner.state.rays) > 0
    assert st["lane_steps"] == res * res * st["iterations"]
    assert gw.node_count(runner._graphs["step"][0], "body") == (
        STAMPED_BODY_NODES)


def test_bdpt_graph_stamps_match_events(cuda_device, tmp_path):
    """A BDPT block of the box with a 3,900-triangle sphere at 256x256, 2
    samples, reverse 4 (K1): the light phase's and the steps' stamped
    time lies within 2% of CUDA events around the block's WHILE launch,
    the connections have slots of their own, and the light phase's
    counts are positive."""
    from rgk_tpu_torch.integrator import graph

    res = 256
    cfg = scenes.add_sphere(tmp_path, scenes.box_config(res=res, ms=2,
                                                        reverse=4),
                            n_tris=3900)
    arrays, meta, c = scenes.port_build(
        scenes.write_config(tmp_path, cfg, "bdpt_stamps.json"), "cuda")
    s, cam = c.settings, c.get_camera().to("cuda")
    pix = torch.arange(res * res, device="cuda")
    px, py = (pix % res).to(torch.int32), (pix // res).to(torch.int32)
    runner = graph.QueuedGraph(arrays, meta, s, cam, res * res, 2)
    assert runner.bdpt
    runner.block(px, py, 0, 42, cam)
    torch.cuda.synchronize()
    graph.reset_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.no_grad():
        runner._load(px, py, 2, 43, cam)
        ev[0].record()
        runner._launch()
        ev[1].record()
    torch.cuda.synchronize()
    st = graph.read_stats()
    ms = ev[0].elapsed_time(ev[1])
    stamped = (st["step_ns"] + st["light_ns"] + st["light_intersect_ns"]) / 1e6
    assert abs(stamped - ms) <= 0.02 * ms, (st, ms)
    for key in ("connect_ns", "connect_intersect_ns", "connect_rays",
                "light_vertices", "splats", "light_live_rays"):
        assert st[key] > 0, key
    assert st["step_ns"] == (st["intersect_ns"] + st["other_ns"]
                             + st["connect_ns"] + st["connect_intersect_ns"])


def test_lane_graph_stops_at_the_last_live_bounce(cuda_device, tmp_path,
                                                  monkeypatch):
    """The per-sample path at the JSON defaults (recursion-max 40,
    russian 0.74) through the WHILE graph: bit-equal to render_lanes
    (the host loop), no sync, and as many bounces as the host loop ran,
    fewer than 40."""
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.integrator import path as tpath

    cfg = scenes.box_config(res=64, ms=4, russian=0.74,
                            **{"recursion-max": 40})
    arrays, meta, c = scenes.port_build(
        scenes.write_config(tmp_path, cfg, "deep.json"), "cuda")
    s, cam = c.settings, c.get_camera().to("cuda")
    runner = graph.LaneGraph(arrays, meta, s, cam, 2048)
    px, py, si = _lanes_on_card()
    n = []
    orig = tpath._lane_bounce
    monkeypatch.setattr(tpath, "_lane_bounce",
                        lambda *a: n.append(1) or orig(*a))
    want = tpath.render_lanes(arrays, meta, s, cam, px, py, si, 42)
    monkeypatch.setattr(tpath, "_lane_bounce", orig)
    graph.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [t.clone() for t in runner.trace(px, py, si, 42, cam)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    st = graph.read_stats()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert st["lane_bounces"] == len(n) < 40 and st["flag_reads"] == 0


def test_queued_graph_tail_follows_the_accumulator(cuda_device, tmp_path):
    """A driver whose accumulator is replaced (as a checkpoint load
    replaces it) captures its accumulation again: two rounds through the
    graphs, the second into a new accumulator, add up to the eager
    loop's image bit for bit."""
    from rgk_tpu_torch.driver.render import RenderDriver
    from rgk_tpu_torch.integrator import path as tpath

    arrays, meta, s, cam = _graph_scene(tmp_path, "flat")
    drv = RenderDriver(s, arrays, meta, cam, chunk_lanes=1500)
    drv.render_round(0)
    drv._acc_dev = drv._acc_dev.clone()
    drv._rays_dev = drv._rays_dev.clone()
    drv.render_round(1)
    acc = torch.zeros_like(drv._acc_dev)
    for r in (0, 1):
        for px, py, pix in zip(drv._px, drv._py, drv._pix_idx):
            rad, _ = tpath.trace_wavefront_queued_eager(
                arrays, meta, s, cam, px, py, r * 4, 4, 42)
            acc.index_add_(0, pix, rad)
    assert len(drv._px) == 3
    assert torch.equal(drv._acc_dev[:-1], acc[:-1])


# ---- the per-sample path and the gradient step as CUDA graphs


def _lanes_on_card(n=2048, first=300, s0=0):
    pix = (torch.arange(first, first + n, device="cuda") % 4096)
    return ((pix % 64).to(torch.int32), (pix // 64).to(torch.int32),
            torch.arange(n, device="cuda") % 4 + s0)


@pytest.mark.parametrize("case", ["flat", "sphere", "bdpt"])
def test_lane_graph_equals_eager(cuda_device, tmp_path, case):
    """The per-sample path as one graph (every bounce) against
    render_lanes (the host loop with its early exit) on the card, two
    calls through one runner: radiance, rays and each lane's splats
    bit-equal (a dead lane adds nothing)."""
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.integrator import path as tpath

    arrays, meta, s, cam = _graph_scene(tmp_path, case)
    runner = graph.LaneGraph(arrays, meta, s, cam, 2048)
    for first, s0, seed in ((300, 0, 42), (2000, 8, 9)):
        px, py, si = _lanes_on_card(first=first, s0=s0)
        got = [t.clone() for t in runner.trace(px, py, si, seed, cam)]
        want = tpath.render_lanes(arrays, meta, s, cam, px, py, si, seed)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_lane_graph_round_does_not_sync(cuda_device, tmp_path):
    """Two rounds of render_image_round through one LaneGraph under
    set_sync_debug_mode("error"): no sync from the lanes' set-up to the
    image, and each round's image, counts and rays (not the runner's
    buffers, which the next round rewrites) equal
    render_image_round_eager's."""
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.integrator import path as tpath

    arrays, meta, s, cam = _graph_scene(tmp_path, "bdpt")
    runner = graph.LaneGraph(arrays, meta, s, cam, 64 * 64 * 4, seed=42)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tpath.render_image_round(arrays, meta, s, cam, r,
                                        runner=runner) for r in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for r, g in zip((1, 2), got):
        want = tpath.render_image_round_eager(arrays, meta, s, cam, r)
        assert torch.equal(g[1], want[1]) and torch.equal(g[2], want[2])
        # The splats add with atomics on the card (path._splat_image).
        torch.testing.assert_close(g[0], want[0], rtol=1e-5, atol=1e-6)


def _vg_case(tmp_path, dev):
    from rgk_tpu_torch.diff.graph import make_value_and_grad
    from rgk_tpu_torch.diff.params import extract_params, make_loss_fn
    from rgk_tpu_torch.scene import config as tconfig

    cfg = tconfig.load_config(scenes.write_config(tmp_path,
                                                  scenes.GRAD_SCENE))
    arrays, meta, _ = tconfig.build_scene(cfg, dev, build_bvh=False)
    i = torch.arange(64)
    args = (arrays, meta, cfg.settings, cfg.get_camera(),
            (i % 8).to(torch.int32), (i // 8).to(torch.int32),
            torch.zeros(64, dtype=torch.int64), 3, torch.zeros(64, 3))
    return make_value_and_grad(*args), make_loss_fn(*args), \
        extract_params(arrays)


def test_value_and_grad_graph_equals_eager(cuda_device, tmp_path):
    """The gradient step as one graph against the eager step on the
    card, two parameter values through one runner: the loss within rtol
    1e-5, each leaf's gradient within 1e-5 * max|eager| + 1e-9 (the
    backward's scatter-adds use atomics); the replay makes no sync and
    adds its capture's K1 launches."""
    fn, loss_fn, params = _vg_case(tmp_path, cuda_device)
    for f in (1.0, 1.25):
        p = {k: (v.detach() * f).requires_grad_(True)
             for k, v in params.items()}
        n0 = fi.launches["closest"] + fi.launches["any"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, grads = fn(p)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert fi.launches["closest"] + fi.launches["any"] > n0
        want_l = loss_fn(p)
        want = torch.autograd.grad(want_l, list(p.values()),
                                   allow_unused=True)
        torch.testing.assert_close(loss, want_l.detach(), rtol=1e-5, atol=0)
        for k, w in zip(p, want):
            assert (grads[k] is None) == (w is None), k
            if w is not None:
                tol = 1e-5 * float(w.abs().max()) + 1e-9
                assert float((grads[k] - w).abs().max()) <= tol, k


def _take_case(dev, m, k, r, seed, one_row=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(m, k)).astype(np.float32)
    idx = (np.zeros(r, np.int32) if one_row
           else rng.integers(0, m, r).astype(np.int32))
    g = rng.normal(size=(r, k)).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (table, idx, g)]


@pytest.mark.parametrize("r", [1, 1000, 1 << 20])
@pytest.mark.parametrize("m,k", [(1, 8), (7, 20), (40, 15), (1024, 20),
                                 (1024, 64)])
def test_take_rows_kernel_equals_plain(cuda_device, m, k, r):
    """K5's forward against take_rows_plain bit for bit, float32 and
    int32 tables (the 1024 x 64 table is not staged in shared memory),
    with ids outside [0, M) on every 9th lane."""
    table, idx, _ = _take_case(cuda_device, m, k, r, seed=m + k + r)
    idx[::9] = torch.where(idx[::9] % 2 == 0, -1, m)
    for t in (table, (table * 1000).to(torch.int32)):
        n0 = vm.launches["forward"]
        got = vm.take_rows(t, idx)
        assert vm.launches["forward"] == n0 + 1
        want = vm.take_rows_plain(t.cpu(), idx.cpu())
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.parametrize("r", [1, 1000, 1 << 20])
@pytest.mark.parametrize("m,k,one_row", [(7, 20, False), (1024, 20, False),
                                         (5, 8, True)])
def test_take_rows_backward_is_deterministic(cuda_device, m, k, one_row, r):
    """K5's backward twice: bit-equal; within 1e-5 x max|ref| of the
    float64 sum of the same terms.  `one_row` sends every lane to row 0,
    the worst case of the sort-based index_put_ route."""
    table, idx, g = _take_case(cuda_device, m, k, r, seed=3 * r + m,
                               one_row=one_row)
    n0 = vm.launches["backward"]
    a = vm.take_rows_backward(g, idx, m)
    b = vm.take_rows_backward(g, idx, m)
    assert vm.launches["backward"] == n0 + 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ref = vm.take_rows_backward_plain(g.double().cpu(), idx.cpu(), m)
    tol = 1e-5 * float(ref.abs().max())
    assert float((a.cpu().double() - ref).abs().max()) <= tol


def _offset(x, words):
    """`x` copied into a fresh buffer `words` floats in: contiguous, and
    not 16-byte aligned for an odd `words`."""
    buf = torch.empty(x.numel() + words, dtype=x.dtype, device=x.device)
    view = buf[words:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("r", [37, (1 << 20) + 3])
@pytest.mark.parametrize("k", [4, 8, 13, 15, 20, 24, 45])
@pytest.mark.parametrize("m,aligned", [(5, True), (9, True), (64, True),
                                       (64, False)])
def test_take_rows_forward_routes(cuda_device, m, k, r, aligned):
    """K5's forward on the widths it fixes at compile time (4, 8, 15, 20,
    24) and others (13, 45), 16-byte and word units, staged tables and a
    [64, k] one read from device memory (also from a table that is not
    16-byte aligned): bit-equal to take_rows_plain, float32 and int32,
    ids outside [0, M) on every 9th lane."""
    table, idx, _ = _take_case(cuda_device, m, k, r, seed=m * k + r)
    idx[::9] = torch.where(idx[::9] % 2 == 0, -1, m)
    for t in (table, (table * 1000).to(torch.int32)):
        t = t if aligned else _offset(t, 1)
        got = vm.take_rows(t, idx)
        want = vm.take_rows_plain(t.cpu(), idx.cpu())
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.parametrize("r", [1, 4099, 1 << 20])
@pytest.mark.parametrize("k", [8, 15, 20, 45])
@pytest.mark.parametrize("m", [1, 5, 8, 9])
@pytest.mark.parametrize("aligned", [True, False])
def test_take_rows_backward_routes(cuda_device, m, k, r, aligned):
    """K5's backward either side of the small-table bound (8 rows), with
    16-byte loads and (g not 16-byte aligned) the word stream, R no
    multiple of a tile, ids outside [0, M) on every 11th lane: two runs
    bit-equal, within 1e-5 x max|ref| of the float64 sum."""
    _, idx, g = _take_case(cuda_device, m, k, r, seed=7 * r + m + k)
    idx[::11] = torch.where(idx[::11] % 2 == 0, -1, m + 2)
    if not aligned:
        g = _offset(g, 1)
    a = vm.take_rows_backward(g, idx, m)
    b = vm.take_rows_backward(g, idx, m)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ref = vm.take_rows_backward_plain(g.double().cpu(), idx.cpu(), m)
    tol = 1e-5 * float(ref.abs().max())
    assert float((a.cpu().double() - ref).abs().max()) <= tol


def test_bdpt_value_and_grad_graph_equals_eager(cuda_device, tmp_path):
    """The BDPT box (16x16, 4 spp, reverse 2, 1024 lanes) through
    diff.graph.make_value_and_grad against the eager step: every leaf's
    gradient finite, and the graph's loss and gradients equal to the
    eager step's bit for bit (K5's backward sums in a fixed order)."""
    from rgk_tpu_torch.diff.graph import make_value_and_grad
    from rgk_tpu_torch.diff.params import extract_params, make_loss_fn
    from rgk_tpu_torch.scene import config as tconfig

    path = scenes.write_config(tmp_path, scenes.box_config(
        res=16, ms=4, reverse=2), "bdpt_grad.json")
    cfg = tconfig.load_config(path)
    arrays, meta, _ = tconfig.build_scene(cfg, cuda_device)
    pix = torch.arange(256)
    args = (arrays, meta, cfg.settings, cfg.get_camera(),
            (pix % 16).to(torch.int32).repeat(4),
            (pix // 16).to(torch.int32).repeat(4),
            torch.arange(4).repeat_interleave(256), 3, torch.zeros(1024, 3))
    fn, loss_fn = make_value_and_grad(*args), make_loss_fn(*args)
    params = extract_params(arrays)
    loss, grads = fn(params)
    want_l = loss_fn(params)
    want = dict(zip(params, torch.autograd.grad(
        want_l, list(params.values()), allow_unused=True)))
    assert torch.equal(loss, want_l.detach())
    for k, w in want.items():
        assert (grads[k] is None) == (w is None), k
        if w is not None:
            assert bool(torch.isfinite(w).all()), k
            assert torch.equal(grads[k], w), k


def test_take_rows_autograd_on_the_card(cuda_device):
    """Under autograd a table of at most 1024 rows launches K5 forward
    and backward; the gradient is K5's backward of the rows' gradient."""
    table, idx, g = _take_case(cuda_device, 12, 20, 1 << 16, seed=41)
    t = table.clone().requires_grad_(True)
    f0, b0 = vm.launches["forward"], vm.launches["backward"]
    rows = vm.take_rows(t, idx.reshape(256, 256))
    (got,) = torch.autograd.grad(rows, [t], g.reshape(256, 256, 20))
    assert (vm.launches["forward"], vm.launches["backward"]) == (f0 + 1,
                                                                 b0 + 1)
    assert torch.equal(got, vm.take_rows_backward(g, idx, 12))


def test_take_rows_backward_limit_raises(cuda_device):
    """Beyond 1024 rows, or beyond the shared memory a block opts in to
    (1024 x 64 floats), K5's backward raises; it never switches route."""
    _, idx, g = _take_case(cuda_device, 1024, 64, 1000, seed=7)
    with pytest.raises(ValueError, match="shared memory"):
        vm.take_rows_backward(g, idx, 1024)
    with pytest.raises(ValueError, match="1024 rows"):
        vm.take_rows_backward(g, idx, 1025)


# ---- the sampler kernel (csrc/sampler.cu, ops/sampler.py)

SAMPLER_MODES = (0, 1, 2, 3, 4)   # independent, Halton, stratified, LHS, VdC
SAMPLER_DIMS = tuple(range(13)) + (255, 256, 257)
SAMPLER_N_SETS = (1, 2, 4, 8, 9)


def _sampler_lanes(n=64, seed=20):
    """(pixel, sample) int64 [n] on the CPU: the edges (samples 0, 2^31-1,
    2^32-1, 2^32+5; pixel ids up to 2^22), then random values."""
    rng = np.random.default_rng(seed)
    pixel = np.concatenate([[0, 1, 2**22 - 1, 2**22, 2**22, 0, 7, 2**21],
                            rng.integers(0, 2**22 + 1, n)])[:n]
    sample = np.concatenate([[0, 2**31 - 1, 2**32 - 1, 2**32 + 5, 1, 2**31,
                              3, 2**32 + 2**31 - 1],
                             rng.integers(0, 2**20, n // 2),
                             rng.integers(0, 2**33, n)])[:n]
    return (torch.from_numpy(pixel.astype(np.int64)),
            torch.from_numpy(sample.astype(np.int64)))


def _sampler_seeds(n):
    """(name, seed) for each shape a seed takes, on the CPU: Python ints
    and 0-d tensors at 0 and 2^32-1, and a seed a lane."""
    per_lane = torch.tensor([0, 2**32 - 1, 12345, 2**31]).repeat(n)[:n]
    out = []
    for s in (0, 2**32 - 1):
        out += [(f"int {s}", s), (f"0-d {s}", torch.tensor(s))]
    return out + [("lanes", per_lane)]


def _to_card(x):
    return x.cuda() if isinstance(x, torch.Tensor) else x


def _card_ctx(ctx):
    return ctx._replace(seed=_to_card(ctx.seed), pixel=ctx.pixel.cuda(),
                        sample=ctx.sample.cuda())


def _same_bits(got, want, what):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), what


@pytest.mark.parametrize("mode", SAMPLER_MODES)
def test_sampler_kernel_equals_plain(cuda_device, mode):
    """sample_1d and sample_2d on CUDA tensors (one launch a call)
    against the plain version on the CPU, bit for bit, at the edges:
    n_set 1-9, dims 0-12 and 255-257, every seed shape."""
    from rgk_tpu_torch.ops import sampler as smp

    pixel, sample = _sampler_lanes()
    for n_set in SAMPLER_N_SETS:
        for name, seed in _sampler_seeds(pixel.shape[0]):
            ctx = smp.SampleCtx(seed=seed, pixel=pixel, sample=sample,
                                mode=mode, n_set=n_set)
            card = _card_ctx(ctx)
            for dim in SAMPLER_DIMS:
                what = f"mode {mode} n_set {n_set} seed {name} dim {dim}"
                for entry in ("sample_1d", "sample_2d"):
                    n0 = smp.launches[entry]
                    got = getattr(smp, entry)(card, dim)
                    assert smp.launches[entry] == n0 + 1
                    want = getattr(smp, f"{entry}_plain")(ctx, dim)
                    _same_bits(got, want, f"{entry} {what}")


def test_sampler_kernel_hashes_equal_plain(cuda_device):
    """hash_u32 (int64 u32 values, one launch) and hash01 on CUDA tensors
    against the plain version on the CPU: every part shape, negative
    int32 parts (cast to int64) and wide int64 parts, eight parts (the most a launch takes), a
    0-d result; nine parts raise."""
    from rgk_tpu_torch.ops import sampler as smp

    pixel, sample = _sampler_lanes()
    neg = -torch.arange(1, 65, dtype=torch.int32)
    cases = [(pixel, sample, 7, torch.tensor(2**32 - 1)),
             (torch.tensor(5), 1, sample + 1),
             (neg, pixel, 2**40 + 3, -1),
             tuple([sample] + list(range(7))),
             (torch.tensor(3), 4)]
    for parts in cases:
        card = tuple(_to_card(p) for p in parts)
        for entry in ("hash_u32", "hash01"):
            n0 = smp.launches["hash_u32"]
            got = getattr(smp, entry)(*card)
            assert smp.launches["hash_u32"] == n0 + 1
            want = getattr(smp, f"{entry}_plain")(*parts)
            _same_bits(got, want, f"{entry} of {len(parts)} parts")
    with pytest.raises(ValueError, match="at most 8 parts"):
        smp.hash_u32(sample.cuda(), *range(8))


@pytest.mark.parametrize("n", [0, 1, (1 << 20) + 3])
def test_sampler_kernel_lane_counts_and_views(cuda_device, n):
    """0, 1 and 2^20+3 lanes in every mode at n_set 9, and strided views
    of the pixel and sample (copied by the wrapper), bit for bit the
    plain version's."""
    from rgk_tpu_torch.ops import sampler as smp

    pixel, sample = _sampler_lanes(max(n, 1), seed=n)
    pixel, sample = pixel[:n], sample[:n]
    for mode in SAMPLER_MODES:
        for seed in (3, torch.tensor(2**32 - 1),
                     torch.arange(n, dtype=torch.int64) * 977):
            ctx = smp.SampleCtx(seed=seed, pixel=pixel, sample=sample,
                                mode=mode, n_set=9)
            for dim in (0, 4, 11):
                for entry in ("sample_1d", "sample_2d"):
                    got = getattr(smp, entry)(_card_ctx(ctx), dim)
                    want = getattr(smp, f"{entry}_plain")(ctx, dim)
                    _same_bits(got, want, f"{entry} mode {mode} n {n}")
    both = torch.stack([pixel, sample]).cuda()
    ctx = smp.SampleCtx(seed=5, pixel=both[0, ::2], sample=both[1, ::2],
                        mode=1)
    assert not ctx.pixel.is_contiguous() or n <= 2
    plain = smp.SampleCtx(seed=5, pixel=pixel[::2], sample=sample[::2],
                          mode=1)
    _same_bits(smp.sample_2d(ctx, 2), smp.sample_2d_plain(plain, 2), "views")
    _same_bits(smp.hash_u32(ctx.pixel, ctx.sample),
               smp.hash_u32_plain(plain.pixel, plain.sample), "hash views")


def test_sampler_kernel_in_a_captured_graph(cuda_device):
    """The queued step's calls captured once (a 0-d device seed, per-lane
    sample and bounce), replayed with other seeds and samples: each
    replay equals the plain version on the CPU bit for bit; the capture
    records one launch a call."""
    from rgk_tpu_torch.ops import sampler as smp

    n = 4096
    seed = torch.zeros((), dtype=torch.int64, device="cuda")
    pixel = torch.arange(n, dtype=torch.int64, device="cuda") * 31
    sample = torch.zeros(n, dtype=torch.int64, device="cuda")
    bounce = torch.zeros(n, dtype=torch.int64, device="cuda")

    def body(seed, pixel, sample, bounce):
        ctx = smp.SampleCtx(seed=seed, pixel=pixel, sample=sample, mode=1,
                            n_set=4)
        bseed = smp.hash_u32(seed, 1, bounce + 1)
        bctx = ctx._replace(seed=bseed, mode=0)
        return (smp.sample_2d(ctx, 0), smp.sample_2d(ctx, 4),
                smp.sample_2d(bctx, 11), smp.sample_1d(bctx, 13), bseed)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(seed, pixel, sample, bounce)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    n0 = dict(smp.launches)
    with torch.cuda.graph(g):
        outs = body(seed, pixel, sample, bounce)
    assert {k: smp.launches[k] - n0[k] for k in n0} == {
        "hash_u32": 1, "sample_1d": 1, "sample_2d": 3}
    for s, s0 in ((42, 0), (2**32 - 1, 2**31 - 1), (7, 2**32 + 5)):
        seed.fill_(s)
        sample.copy_(torch.arange(n, device="cuda") + s0)
        bounce.copy_(torch.arange(n, device="cuda") % 7)
        g.replay()
        torch.cuda.synchronize()
        plain = body(torch.tensor(s), pixel.cpu(), sample.cpu(), bounce.cpu())
        for got, want in zip(outs, plain):
            # body's calls on CPU tensors take the plain version.
            _same_bits(got, want, f"replay seed {s} sample0 {s0}")


def _plain_sampler(monkeypatch):
    """The sampler's public functions replaced by its plain version, as
    the port ran it on the card before the kernel."""
    from rgk_tpu_torch.ops import sampler as smp

    for name in ("hash_u32", "sample_1d", "sample_2d"):
        monkeypatch.setattr(smp, name, getattr(smp, f"{name}_plain"))


@pytest.mark.parametrize("case", ["nee", "bdpt", "lanes", "grad"])
def test_render_paths_equal_the_plain_sampler(cuda_device, tmp_path,
                                              monkeypatch, case):
    """A queued NEE block, a queued BDPT block (the light phase too), a
    LaneGraph round and the gradient step through the sampler kernel,
    against the same run with the plain sampler in its place: outputs
    bit-equal (the BDPT splat image within rtol 1e-5: atomics).  The
    sampler's launches are counted per step of the captured body (at
    most 10 a queued NEE step) and none with the plain sampler."""
    from rgk_tpu_torch.diff.graph import make_value_and_grad
    from rgk_tpu_torch.diff.params import extract_params
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.ops import sampler as smp

    if case == "grad":
        path = scenes.write_config(tmp_path, scenes.box_config(
            res=16, ms=4, reverse=0), "grad.json")
        from rgk_tpu_torch.scene import config as tconfig

        cfg = tconfig.load_config(path)
        arrays, meta, _ = tconfig.build_scene(cfg, cuda_device)
        pix = torch.arange(256)
        args = (arrays, meta, cfg.settings, cfg.get_camera(),
                (pix % 16).to(torch.int32).repeat(4),
                (pix // 16).to(torch.int32).repeat(4),
                torch.arange(4).repeat_interleave(256), 3,
                torch.zeros(1024, 3))
    else:
        arrays, meta, s, cam = _graph_scene(
            tmp_path, "bdpt" if case == "bdpt" else "flat")

    def run():
        """-> (outputs, sampler launches a body, bodies run)."""
        if case == "grad":
            fn = make_value_and_grad(*args)
            n0 = sum(smp.launches.values())
            loss, grads = fn(extract_params(arrays))
            torch.cuda.synchronize()
            out = [loss.clone()] + [g.clone() for g in grads.values()
                                    if g is not None]
            return out, sum(smp.launches.values()) - n0, 1
        if case == "lanes":
            runner = graph.LaneGraph(arrays, meta, s, cam, 2048)
            px, py, si = _lanes_on_card()
            graph.settle()
            n0 = sum(smp.launches.values())
            graph.reset_stats()
            out = [t.clone() for t in runner.trace(px, py, si, 42, cam)]
            st = graph.read_stats()
            return out, sum(smp.launches.values()) - n0, st["lane_bounces"]
        runner = graph.QueuedGraph(arrays, meta, s, cam, 1024, 4)
        px, py = _graph_block()
        graph.settle()
        n0 = sum(smp.launches.values())
        graph.reset_stats()
        out = [t.clone() for t in runner.trace(px, py, 0, 42, cam)]
        st = graph.read_stats()
        at = [c is smp.launches for c in graph._COUNTERS].index(True)
        body = runner._graphs["step"][1][at]
        launched = sum(smp.launches.values()) - n0
        assert launched - sum(body.values()) * st["iterations"] == (
            sum(runner._graphs["light"][1][at].values())
            if case == "bdpt" else 0)
        return out, sum(body.values()), st["iterations"]

    got, per_body, bodies = run()
    assert bodies > 0 and per_body > 0
    if case == "nee":
        assert per_body <= 10
    _plain_sampler(monkeypatch)
    want, plain_launches, _ = run()
    assert plain_launches == 0
    for i, (a, b) in enumerate(zip(got, want)):
        if case == "bdpt" and i == 1:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a, b), f"{case}: output {i}"


# ---- the BxDF kernel (csrc/bxdf.cu, ops/bxdf.py)


def _bxdf_lanes(n, seed, mix, dev):
    from rgk_tpu_torch.ops import ltc as ltc_ops

    pack, mid, vi, vr, u2 = scenes.bxdf_lanes(
        n, seed, types=scenes.BXDF_TYPES if mix else scenes.BXDF_TYPES[:-1])
    rows = torch.from_numpy(np.array(ltc_ops.load_tables_np())).to(dev)
    return (pack.to(dev), mid.to(dev), vi.to(dev), vr.to(dev), u2.to(dev),
            ltc_ops.LTCTables(rows=rows))


def _lane_bits(t):
    b = t.view(torch.int32) if t.dtype == torch.float32 else t
    return b if b.dim() == 1 else b.reshape(b.shape[0], -1)


@pytest.mark.parametrize("n", [1, 7, (1 << 18) + 3])
@pytest.mark.parametrize("mix,ltc", [(False, False), (False, True),
                                     (True, False), (True, True)])
def test_bxdf_kernel_equals_plain(cuda_device, n, mix, ltc):
    """eval_bxdf and sample_bxdf through the kernel against the plain
    version on the card, bit for bit on every lane: each type, the mix
    (and a mix over a mix), grazing and below-horizon directions, TIR,
    the mirror and refraction tolerances' edges, roughness 0 and 1.  One
    launch a call, none through the plain version."""
    from rgk_tpu_torch.ops import bxdf

    pack, mid, vi, vr, u2, tb = _bxdf_lanes(n, 11 + n, mix, cuda_device)
    before = dict(bxdf.launches)
    got = (bxdf.eval_bxdf(None, pack, mid, vi, vr, None, tb, mix, ltc,
                          False),) + bxdf.sample_bxdf(
        None, pack, mid, vi, None, u2, tb, mix, ltc, False)
    assert bxdf.launches["eval"] == before["eval"] + 1
    assert bxdf.launches["sample"] == before["sample"] + 1
    want = (bxdf.eval_bxdf_plain(None, pack, mid, vi, vr, None, tb, mix,
                                 ltc, False),) + bxdf.sample_bxdf_plain(
        None, pack, mid, vi, None, u2, tb, mix, ltc, False)
    assert bxdf.launches["eval"] == before["eval"] + 1
    typ = pack[mid.long(), 12].long()
    for name, a, b in zip(("f", "dir", "thr", "leak"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        off = (_lane_bits(a) != _lane_bits(b))
        off = off.any(-1) if off.dim() > 1 else off
        assert not off.any(), (name, torch.bincount(
            typ[off], minlength=9).tolist())


def _bxdf_grads(which, lanes, mix, ltc, g_out, dtype=torch.float32,
                dev=None):
    """Gradients of sum(g_out[0] * f) for an eval, and of sum(g_out[0] *
    dir + g_out[1] * thr) for a sample, by the leaves diffuse, specular,
    roughness (of the pack) and the directions."""
    from rgk_tpu_torch.ops import bxdf
    from rgk_tpu_torch.ops import ltc as ltc_ops

    pack0, mid, vi0, vr0, u2, tb = lanes
    dev = dev or pack0.device
    pack0, vi0, vr0, u2 = (t.to(dev, dtype) for t in (pack0, vi0, vr0, u2))
    tb = ltc_ops.LTCTables(rows=tb.rows.to(dev, dtype))
    mid = mid.to(dev)
    g_out = [g.to(dev, dtype) for g in g_out]
    out = []
    for entry in ("eval", "sample"):
        d = pack0[:, 3:6].clone().requires_grad_(True)
        s = pack0[:, 6:9].clone().requires_grad_(True)
        r = pack0[:, 9].clone().requires_grad_(True)
        vi = vi0.clone().requires_grad_(True)
        vr = vr0.clone().requires_grad_(True)
        pack = torch.cat([pack0[:, 0:3], d, s, r[:, None], pack0[:, 10:]], 1)
        if entry == "eval":
            fn = bxdf.eval_bxdf if which == "kernel" else bxdf.eval_bxdf_plain
            f = fn(None, pack, mid, vi, vr, None, tb, mix, ltc, False)
            loss, leaves = (f * g_out[0]).sum(), [d, s, r, vi, vr]
        else:
            fn = (bxdf.sample_bxdf if which == "kernel"
                  else bxdf.sample_bxdf_plain)
            dd, tt, _ = fn(None, pack, mid, vi, None, u2, tb, mix, ltc,
                           False)
            loss = (dd * g_out[0]).sum() + (tt * g_out[1]).sum()
            leaves = [d, s, r, vi]
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        out.append([torch.zeros_like(x) if g is None else g
                    for x, g in zip(leaves, got)])
    return out


@pytest.mark.parametrize("mix,ltc", [(False, False), (False, True),
                                     (True, False), (True, True)])
def test_bxdf_kernel_backward_matches_autograd(cuda_device, mix, ltc):
    """The kernel's backward (one launch an entry) against autograd of
    the plain version on the card, for the pack's diffuse, specular and
    roughness and for vi and vr, where the plain gradient is finite (the
    elements skipped are counted).  At least 99% of each direction's
    gradient elements lie within rtol 1e-5 of the plain version's (the
    pack's rows sum every lane's).  The rest are lanes where the two
    float32 backwards round apart (an LTC lobe's table slope and the
    Fresnel derivative cancel): over them the kernel lies no farther from
    autograd of the plain version in float64 than twice the plain float32
    gradient does, plus rtol 1e-5 (sums of the distances), and no element
    departs from the plain version by more than 5% (+ 1e-3 x the
    largest)."""
    from rgk_tpu_torch.ops import bxdf

    n = (1 << 16) + 5
    lanes = _bxdf_lanes(n, 5, mix, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    g_out = [torch.randn(n, 3, device=cuda_device, generator=gen)
             for _ in range(2)]
    before = dict(bxdf.launches)
    got = _bxdf_grads("kernel", lanes, mix, ltc, g_out)
    assert bxdf.launches["eval_bwd"] == before["eval_bwd"] + 1
    assert bxdf.launches["sample_bwd"] == before["sample_bwd"] + 1
    want = _bxdf_grads("plain", lanes, mix, ltc, g_out)
    ref = _bxdf_grads("plain", lanes, mix, ltc, g_out, torch.float64,
                      torch.device("cpu"))
    stats, bad = {}, []
    for entry, gs, ws, rs in zip(("eval", "sample"), got, want, ref):
        for name, a, b, r in zip(("diffuse", "specular", "roughness", "vi",
                                  "vr"), gs, ws, rs):
            key = f"{entry}.{name}"
            r = r.to(cuda_device)
            fin = torch.isfinite(b)
            far = fin & ((a - b).abs() > 1e-5 * b.abs())
            scale = float(b[fin].abs().max()) if fin.any() else 0.0
            wild = far & ((a - b).abs() > 0.05 * b.abs() + 1e-3 * scale)
            err_k = float((a[far].double() - r[far]).abs().sum())
            err_p = float((b[far].double() - r[far]).abs().sum())
            size = float(r[far].abs().sum())
            stats[key] = (int((~fin).sum()), int(far.sum()),
                          int((a == b).sum()), b.numel(),
                          f"{err_k / max(size, 1e-300):.2e}",
                          f"{err_p / max(size, 1e-300):.2e}")
            lanes_far = name in ("vi", "vr") and int(far.sum()) > 0.01 * \
                b.numel()
            if lanes_far or wild.any() or err_k > 2 * err_p + 1e-5 * size:
                bad.append(key)
    print(f"mix {mix} ltc {ltc}: (plain non-finite, skipped; beyond rtol "
          f"1e-5 of the plain float32 gradient; bit-equal; elements; there "
          f"the kernel's and the plain version's distance from float64, "
          f"relative) {stats}")
    assert not bad, bad


def _plain_bxdf(monkeypatch):
    """eval_bxdf and sample_bxdf replaced by their plain version, as the
    port ran them on the card before the kernel."""
    from rgk_tpu_torch.ops import bxdf

    for name in ("eval_bxdf", "sample_bxdf"):
        monkeypatch.setattr(bxdf, name, getattr(bxdf, f"{name}_plain"))


def test_texel_gather_backward_on_the_card(cuda_device):
    """The texel gather's backward at the colonnade's sizes (a 512x512
    texture, 1,036,800 lanes, 60% of them untextured, all on texel 0)
    against plain indexing's, bit for bit: those lanes' gradient is 0,
    and their rows go past the table instead of into one serial run."""
    from rgk_tpu_torch.ops import textures

    g = torch.Generator(device="cuda").manual_seed(3)
    n, lanes = 512 * 512, 1_036_800
    texels = torch.rand(n, 3, device="cuda", generator=g)
    idx = torch.randint(0, n, (lanes,), device="cuda", generator=g)
    live = torch.rand(lanes, device="cuda", generator=g) < 0.4
    idx = torch.where(live, idx, 0)
    up = torch.where(live[:, None], torch.randn(lanes, 3, device="cuda",
                                                generator=g), 0.0)
    a = texels.clone().requires_grad_(True)
    b = texels.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(a[idx], a, up)
    (got,) = torch.autograd.grad(textures._Gather.apply(b, idx), b, up)
    assert float(want.abs().sum()) > 0 and torch.equal(got, want)


def test_textured_ltc_value_and_grad_graph_equals_eager(cuda_device,
                                                        tmp_path):
    """The gradient step on the 33,960-triangle colonnade (K2, the stone
    texture, LTC-GGX lobes, sun, sky, emissive panels; 64x16 x 2 spp,
    roulette off) as one graph against the eager step, two parameter
    values through one runner, with no sync in the replay: the loss and
    each leaf's gradient within `test_value_and_grad_graph_equals_eager`'s
    bounds.  The replays stamp the texel backward (`tex_bwd_ns`) and the
    BxDF kernel's backward (`bxdf_bwd_ns`), both inside `grad_bwd_ns`,
    and count the textured lookups (`tex_fetches`)."""
    from rgk_tpu_torch.diff.graph import make_value_and_grad
    from rgk_tpu_torch.diff.params import extract_params, make_loss_fn
    from rgk_tpu_torch.integrator import graph

    smoke = _module("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    path, _ = smoke.write_colonnade(
        str(tmp_path / "scene"), 20000,
        **{"output-width": 64, "output-height": 16, "multisample": 2,
           "russian": -1.0})
    arrays, meta, c = scenes.port_build(path, "cuda")
    assert meta.has_ltc and meta.has_textures and meta.has_bvh
    pix = torch.arange(64 * 16)
    args = (arrays, meta, c.settings, c.get_camera(),
            (pix % 64).to(torch.int32).repeat(2),
            (pix // 64).to(torch.int32).repeat(2),
            torch.arange(2).repeat_interleave(64 * 16), 5,
            torch.zeros(2 * 64 * 16, 3))
    fn, loss_fn = make_value_and_grad(*args), make_loss_fn(*args)
    params = extract_params(arrays)
    graph.reset_stats()
    for f in (1.0, 0.8):
        p = {k: (v.detach() * f).requires_grad_(True)
             for k, v in params.items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, grads = fn(p)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want_l = loss_fn(p)
        want = torch.autograd.grad(want_l, list(p.values()),
                                   allow_unused=True)
        torch.testing.assert_close(loss, want_l.detach(), rtol=1e-5, atol=0)
        for k, w in zip(p, want):
            assert (grads[k] is None) == (w is None), k
            if w is not None:
                assert bool(torch.isfinite(grads[k]).all()), k
                tol = 1e-5 * float(w.abs().max()) + 1e-9
                assert float((grads[k] - w).abs().max()) <= tol, k
        assert float(grads["texels"].abs().max()) > 0
    st = graph.read_stats()
    assert st["grad_steps"] == 2
    assert st["tex_bwd_ns"] > 0 and st["bxdf_bwd_ns"] > 0
    assert st["tex_fetches"] > 0
    assert st["grad_bwd_ns"] >= st["tex_bwd_ns"] + st["bxdf_bwd_ns"]


@pytest.mark.parametrize("case", ["nee", "colonnade", "bdpt", "lanes",
                                  "grad"])
def test_render_paths_equal_the_plain_bxdf(cuda_device, tmp_path,
                                           monkeypatch, case):
    """A queued NEE block of the box and of the colonnade-class scene
    (LTC-GGX, a texture), a queued BDPT block (the light phase too), a
    LaneGraph round, and three SGD steps of the box's gradient step,
    through the BxDF kernel against the same runs with the plain BxDF in
    its place: outputs bit-equal (the BDPT splat image within rtol 1e-5:
    atomics).  A queued NEE step launches one eval and one sample; the
    plain runs launch none."""
    from rgk_tpu_torch.diff.graph import make_value_and_grad
    from rgk_tpu_torch.diff.params import extract_params
    from rgk_tpu_torch.integrator import graph
    from rgk_tpu_torch.ops import bxdf

    if case == "grad":
        path = scenes.write_config(tmp_path, scenes.box_config(
            res=16, ms=4, reverse=0), "grad.json")
        from rgk_tpu_torch.scene import config as tconfig

        cfg = tconfig.load_config(path)
        arrays, meta, _ = tconfig.build_scene(cfg, cuda_device)
        pix = torch.arange(256)
        args = (arrays, meta, cfg.settings, cfg.get_camera(),
                (pix % 16).to(torch.int32).repeat(4),
                (pix // 16).to(torch.int32).repeat(4),
                torch.arange(4).repeat_interleave(256), 3,
                torch.zeros(1024, 3))
    elif case == "colonnade":
        smoke = _module("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
        path, _ = smoke.write_colonnade(
            str(tmp_path / "scene"), 20000,
            **{"output-width": 64, "output-height": 16, "multisample": 4})
        arrays, meta, c = scenes.port_build(path, "cuda")
        assert meta.has_ltc and meta.has_textures
        s, cam = c.settings, c.get_camera().to("cuda")
    else:
        arrays, meta, s, cam = _graph_scene(
            tmp_path, "bdpt" if case == "bdpt" else "flat")

    def run(kernel=True):
        """-> (outputs, BxDF launches a body, bodies run)."""
        if case == "grad":
            fn = make_value_and_grad(*args)
            params = extract_params(arrays)
            n0 = sum(bxdf.launches.values())
            out = []
            for _ in range(3):
                loss, grads = fn(params)
                out += [loss.clone()] + [g.clone() for g in grads.values()
                                         if g is not None]
                params = {k: (v - 0.05 * grads[k]).detach().requires_grad_()
                          if grads[k] is not None else v
                          for k, v in params.items()}
            torch.cuda.synchronize()
            return out + list(params.values()), \
                sum(bxdf.launches.values()) - n0, 3
        if case == "lanes":
            runner = graph.LaneGraph(arrays, meta, s, cam, 2048)
            px, py, si = _lanes_on_card()
            graph.settle()
            n0 = sum(bxdf.launches.values())
            graph.reset_stats()
            out = [t.clone() for t in runner.trace(px, py, si, 42, cam)]
            st = graph.read_stats()
            return out, sum(bxdf.launches.values()) - n0, st["lane_bounces"]
        runner = graph.QueuedGraph(arrays, meta, s, cam, 1024, 4)
        px, py = _graph_block()
        graph.settle()
        n0 = sum(bxdf.launches.values())
        graph.reset_stats()
        out = [t.clone() for t in runner.trace(px, py, 0, 42, cam)]
        st = graph.read_stats()
        at = [c is bxdf.launches for c in graph._COUNTERS].index(True)
        body = runner._graphs["step"][1][at]
        launched = sum(bxdf.launches.values()) - n0
        assert launched - sum(body.values()) * st["iterations"] == (
            sum(runner._graphs["light"][1][at].values())
            if case == "bdpt" else 0)
        if case in ("nee", "colonnade") and kernel:
            assert body == {"eval": 1, "sample": 1, "eval_bwd": 0,
                            "sample_bwd": 0}, body
        return out, sum(body.values()), st["iterations"]

    got, per_body, bodies = run()
    assert bodies > 0 and per_body > 0
    _plain_bxdf(monkeypatch)
    want, plain_launches, _ = run(kernel=False)
    assert plain_launches == 0
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if case == "bdpt" and i == 1:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a, b), f"{case}: output {i}"
