"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc: it carries the `cuda`
marker and skips without a card.  The file imports no JAX, so it also
runs where JAX is not installed (tests/conftest.py imports JAX, hence
`--noconftest` there):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: triangle ids equal on >= 99.99% of rays (nvcc contracts
multiply-adds to FMA, the plain versions do not, which can flip a hit
exactly on an edge); t within rtol 3e-4 / atol 1e-6 where ids agree
(for K2 the reported t, recomputed from the winner's row; its in-kernel
t on >= 99.99% of the hits, since grazing hits cancel in rd.n); any-hit
validity equal on >= 99.99% of rays.  Whole images: the bounds of
bench.py parity_gate (rgk_tpu_torch/parity.py).  The binned kernels
K3/K4: lists, counts and skipmin equal the plain walk's on >= 99.99% of
lanes, K4 as K2; the binned front end's ids equal K2's on >= 99.99% of
rays (they share the slab and row tests).  The probes: equal to their
plain versions (the sweeps' t within rtol 3e-4).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from rgk_tpu.io.exr import read_exr
from rgk_tpu_torch.driver import cli
from rgk_tpu_torch.ops import binned_intersect as bi
from rgk_tpu_torch.ops import cluster_intersect as ci
from rgk_tpu_torch.ops import flat_intersect as fi
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
