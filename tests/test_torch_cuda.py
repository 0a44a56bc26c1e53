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
bench.py parity_gate (rgk_tpu_torch/parity.py).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from rgk_tpu.io.exr import read_exr
from rgk_tpu_torch.driver import cli
from rgk_tpu_torch.ops import cluster_intersect as ci
from rgk_tpu_torch.ops import flat_intersect as fi
from rgk_tpu_torch.parity import image_parity
from rgk_tpu_torch.scene import clusters as tclusters
from rgk_tpu_torch.scene.builder import build_tri_pack

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
