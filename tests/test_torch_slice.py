"""Port parity for the whole slice: the queued wavefront tracer, the
render driver and the CLI of rgk_tpu_torch against rgk_tpu on the CPU.

Tolerances:
* per-lane radiance of trace_wavefront_queued: rtol 1e-4 / atol 1e-5
  on >= 99% of lanes (the plain sweep and the reference's matmul sweep
  sum in another order, which may flip a hit exactly on an edge and
  send that lane down another path); extension-ray count within 0.5%;
* whole images: the bounds of bench.py parity_gate
  (rgk_tpu_torch/parity.py);
* the port against itself (same seed twice, resume against a straight
  run): bitwise.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.driver import cli as jcli
from rgk_tpu.integrator import path as jpath
from rgk_tpu.io.exr import read_exr
from rgk_tpu_torch.driver import cli
from rgk_tpu_torch.driver.render import RenderDriver
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.ops.intersect import make_intersector
from rgk_tpu_torch.parity import image_parity
from rgk_tpu_torch.scene import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _box(tmp_path, res=16, ms=4, **overrides):
    return scenes.write_config(tmp_path,
                               scenes.box_config(res=res, ms=ms, **overrides))


def _bvh_box(tmp_path, res=16, ms=4):
    """The box plus a 5000-triangle sphere: above the flat-sweep size."""
    cfg = scenes.add_sphere(tmp_path, scenes.box_config(res=res, ms=ms),
                            n_tris=5000)
    return scenes.write_config(tmp_path, cfg, "box_bvh.json")


def test_trace_matches_reference(tmp_path):
    """Box at 16x16, 4 spp, depth 4: per-lane radiance and ray count."""
    _assert_trace_matches(_box(tmp_path), has_bvh=False)


def test_trace_matches_reference_bvh(tmp_path):
    """The same on the BVH scene: both sides walk their intersect_bvh."""
    _assert_trace_matches(_bvh_box(tmp_path), has_bvh=True)


def _assert_trace_matches(path, has_bvh):
    _, jarrays, jmeta, jcfg = scenes.jax_build(path)
    tarrays, tmeta, tcfg = scenes.port_build(path)
    assert jcfg.settings.recursion_max == 4
    assert tmeta.has_bvh == jmeta.has_bvh == has_bvh

    n = 16 * 16
    pix = np.arange(n)
    px = (pix % 16).astype(np.int32)
    py = (pix // 16).astype(np.int32)
    jrad, jrays = jpath.trace_wavefront_queued(
        jarrays, jmeta, jcfg.settings, jcfg.get_camera(), jnp.asarray(px),
        jnp.asarray(py), 0, 4, 42, sampler_mode=1)
    trad, trays = tpath.trace_wavefront_queued(
        tarrays, tmeta, tcfg.settings, tcfg.get_camera(),
        torch.from_numpy(px), torch.from_numpy(py), 0, 4, 42,
        sampler_mode=1)
    assert trays.dtype == torch.int64
    jrad = np.asarray(jrad)
    trad = trad.numpy()
    close = np.isclose(trad, jrad, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert jrad.mean() > 0.0


def _port_render(cfg_path, out_dir, *extra):
    assert cli.main([cfg_path, "--cpu", "-q", "-D", str(out_dir),
                     *extra]) == 0
    return read_exr(os.path.join(str(out_dir), "bdpt_box.exr"))


def test_cli_image_matches_reference(tmp_path):
    path = _box(tmp_path, res=32)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert jcli.main([path, "--cpu", "--devices", "1", "-q", "-D",
                      str(ref_dir)]) == 0
    ref = read_exr(os.path.join(str(ref_dir), "bdpt_box.exr"))
    img = _port_render(path, port_dir)
    assert img.shape == ref.shape == (32, 32, 3)
    stats = image_parity(img, ref)
    assert stats["ok"], stats


def test_cli_colonnade_matches_reference(tmp_path):
    """The 33,960-triangle colonnade (textured floor, LTC columns and
    orbs, emissive panels, sun and sky) at 32x18, 2 spp, depth 2, through
    both CLIs on the CPU."""
    path = scenes.colonnade(tmp_path, 20000, **{"output-width": 32,
                                                "output-height": 18,
                                                "multisample": 2})
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert jcli.main([path, "--cpu", "--devices", "1", "-q", "-D",
                      str(ref_dir)]) == 0
    assert cli.main([path, "--cpu", "-q", "-D", str(port_dir)]) == 0
    ref = read_exr(os.path.join(str(ref_dir), "colonnade.exr"))
    img = read_exr(os.path.join(str(port_dir), "colonnade.exr"))
    assert img.shape == ref.shape == (18, 32, 3)
    assert np.isfinite(img).all() and img.mean() > 0.0
    stats = image_parity(img, ref)
    assert stats["ok"], stats


def test_smoke_colonnade_is_the_generators(tmp_path):
    """chip_smoke.py composes the colonnade without PIL: the same OBJ
    files and config as tools/make_bigscene.generate, and a stone
    texture that loads to the same linear texels as the PNG."""
    import importlib.util

    from rgk_tpu.io.texture_io import load_texture

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    a, b = tmp_path / "smoke", tmp_path / "gen"
    path, n_tris = smoke.write_colonnade(str(a), 20000)
    ref = scenes.tool("make_bigscene").generate(str(b), 20000)
    assert n_tris == 33960
    for name in ("ground.obj", "columns.obj", "spheres.obj", "panels.obj"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    with open(path) as f:
        cfg = json.load(f)
    with open(ref) as f:
        cfg_ref = json.load(f)
    assert cfg["materials"][0].pop("diffuse-texture") == "stone.exr"
    assert cfg_ref["materials"][0].pop("diffuse-texture") == "stone.png"
    assert cfg == cfg_ref
    np.testing.assert_array_equal(load_texture(str(a / "stone.exr")),
                                  load_texture(str(b / "stone.png")))


def test_image_parity_bounds():
    """Rounding noise that follows brightness passes; a fault confined
    to one region, or a shifted mean, fails."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0.0, 1.0, (32, 32, 3))
    img[:8, :8] *= 50.0  # a bright tile, where rounding noise is largest
    noisy = img * (1.0 + rng.normal(0.0, 1e-7, img.shape))
    assert image_parity(noisy, img)["ok"]
    broken = img.copy()
    broken[16:24, 16:24] += 0.3
    stats = image_parity(broken, img)
    assert not stats["ok"]
    assert stats["max_outliers_per_tile"] > stats["tile_cap"]
    assert not image_parity(img * 1.1, img)["ok"]


def test_same_seed_is_bitwise_repeatable(tmp_path):
    path = _box(tmp_path)
    a = _port_render(path, tmp_path / "a", "--seed", "7")
    b = _port_render(path, tmp_path / "b", "--seed", "7")
    c = _port_render(path, tmp_path / "c", "--seed", "8")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_resume_matches_straight_run(tmp_path):
    """Two rounds, then a resume to four, equals four rounds straight
    (fresh sample indices after the checkpoint), through the CLI."""
    straight = _box(tmp_path, ms=2, rounds=4)
    first = scenes.write_config(tmp_path, scenes.box_config(ms=2, rounds=2),
                                "first.json")
    img4 = _port_render(straight, tmp_path / "straight")

    out = tmp_path / "resumed"
    _port_render(first, out)
    ckpt = os.path.join(str(out), "bdpt_box.exr.ckpt.npz")
    with np.load(ckpt) as d:
        assert int(d["next_round"]) == 2
    img = _port_render(straight, out, "--resume")
    np.testing.assert_array_equal(img, img4)
    with np.load(ckpt) as d:
        assert int(d["next_round"]) == 4
        rays_resumed = int(d["rays"])
    with np.load(os.path.join(str(tmp_path / "straight"),
                              "bdpt_box.exr.ckpt.npz")) as d:
        assert int(d["rays"]) == rays_resumed > 0


def test_unported_paths_raise(tmp_path, monkeypatch):
    # Bidirectional rendering.
    path = _box(tmp_path, reverse=2)
    arrays, meta, cfg = scenes.port_build(path)
    with pytest.raises(NotImplementedError, match="reverse"):
        RenderDriver(cfg.settings, arrays, meta, cfg.get_camera())

    # Above the flat-sweep size the scene commits with a BVH; only the
    # binned pipeline (kernels K3 and K4) is not ported.
    cfg = tconfig.load_config(_bvh_box(tmp_path))
    arrays, meta, _ = tconfig.build_scene(cfg, "cpu")
    assert meta.has_bvh and meta.n_triangles > 4096
    monkeypatch.setenv("RGK_BINNED", "any")
    with pytest.raises(NotImplementedError, match="K3"):
        RenderDriver(cfg.settings, arrays, meta, cfg.get_camera()
                     ).render_frame()
    monkeypatch.setenv("RGK_BINNED", "all")
    with pytest.raises(NotImplementedError, match="K4"):
        make_intersector(meta)
    monkeypatch.setenv("RGK_BINNED", "off")
    assert make_intersector(meta) is not None

    # The tint-thinglass extension.
    tinted = scenes.box_config(thinglass=["mirror"])
    tinted["tint-thinglass"] = True
    path = scenes.write_config(tmp_path, tinted, "tint.json")
    arrays, meta, cfg = scenes.port_build(path)
    assert meta.has_thinglass
    with pytest.raises(NotImplementedError, match="tint-thinglass"):
        RenderDriver(cfg.settings, arrays, meta, cfg.get_camera())


def test_cli_needs_cuda_or_cpu_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.main([_box(tmp_path), "-q", "-D", str(tmp_path)])
    assert not os.path.exists(tmp_path / "bdpt_box.exr")


def test_port_render_imports_no_jax(tmp_path):
    """A process that imports the port and renders a flat and a BVH
    scene keeps JAX out."""
    path = _box(tmp_path, res=8, ms=1)
    bvh_path = _bvh_box(tmp_path, res=4, ms=1)
    bvh_dir = str(tmp_path / "bvh")
    code = (
        "import sys\n"
        "from rgk_tpu_torch.driver.cli import main\n"
        f"main([{path!r}, '--cpu', '-q', '-D', {str(tmp_path)!r}])\n"
        f"main([{bvh_path!r}, '--cpu', '-q', '-D', {bvh_dir!r}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "print(repr(bad))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    assert os.path.exists(tmp_path / "bdpt_box.exr")
    assert os.path.exists(tmp_path / "bvh" / "bdpt_box.exr")
