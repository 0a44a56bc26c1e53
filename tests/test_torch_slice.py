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
from rgk_tpu_torch.driver import cli
from rgk_tpu_torch.driver.render import RenderDriver
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.io import load_texture, read_exr
from rgk_tpu_torch.ops import intersect as isect
from rgk_tpu_torch.parity import image_parity
from rgk_tpu_torch.scene import config as tconfig
from rgk_tpu_torch.scene.json_utils import ConfigError
from rgk_tpu_torch.scene.rtc import ConfigRTC

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
    """Box at 16x16, 4 spp, depth 4 through both tracers; returns the
    port's (radiance, ray count)."""
    ref = _reference_trace(path, has_bvh)
    port = _port_trace(path, has_bvh)
    _assert_close(port, ref)
    return port


def _trace_args(has_bvh, meta, cfg):
    assert cfg.settings.recursion_max == 4
    assert meta.has_bvh == has_bvh
    pix = np.arange(16 * 16)
    return ((pix % 16).astype(np.int32), (pix // 16).astype(np.int32))


def _reference_trace(path, has_bvh):
    _, jarrays, jmeta, jcfg = scenes.jax_build(path)
    px, py = _trace_args(has_bvh, jmeta, jcfg)
    jrad, jrays = jpath.trace_wavefront_queued(
        jarrays, jmeta, jcfg.settings, jcfg.get_camera(), jnp.asarray(px),
        jnp.asarray(py), 0, 4, 42, sampler_mode=1)
    return np.asarray(jrad), int(jrays)


def _port_trace(path, has_bvh):
    tarrays, tmeta, tcfg = scenes.port_build(path)
    px, py = _trace_args(has_bvh, tmeta, tcfg)
    trad, trays = tpath.trace_wavefront_queued(
        tarrays, tmeta, tcfg.settings, tcfg.get_camera(),
        torch.from_numpy(px), torch.from_numpy(py), 0, 4, 42,
        sampler_mode=1)
    assert trays.dtype == torch.int64
    return trad, trays


def _assert_close(port, ref):
    trad, trays = port[0].numpy(), int(port[1])
    jrad, jrays = ref
    close = np.isclose(trad, jrad, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(trays - jrays) <= 0.005 * jrays
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


def test_unported_paths_raise(tmp_path):
    """Nothing the reference renders is refused any more: a line-based
    .rtc scene loads and renders through the CLI, and a malformed one
    raises ConfigError from load_config and from the CLI, before any
    output.  BDPT (reverse > 0) and the tint-thinglass extension set up a
    render driver."""
    rtc = scenes.write_rtc_scene(tmp_path, res=(8, 6), ms=1, sphere=60)
    assert isinstance(tconfig.load_config(rtc), ConfigRTC)
    assert cli.main([rtc, "--cpu", "-q", "-D", str(tmp_path / "rtc")]) == 0
    img = read_exr(os.path.join(str(tmp_path / "rtc"), "rtc.exr"))
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    bad = tmp_path / "bad.rtc"
    bad.write_text("output-file x.exr\n")
    with pytest.raises(ConfigError, match="Unexpected end"):
        tconfig.load_config(str(bad))
    with pytest.raises(ConfigError, match="Unexpected end"):
        cli.main([str(bad), "--cpu", "-q", "-D", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")

    tinted = scenes.box_config(thinglass=["mirror"])
    tinted["tint-thinglass"] = True
    for path in (_box(tmp_path, reverse=2),
                 scenes.write_config(tmp_path, tinted, "tint.json")):
        arrays, meta, cfg = scenes.port_build(path)
        drv = RenderDriver(cfg.settings, arrays, meta, cfg.get_camera())
        assert drv.bdpt == (int(cfg.settings.reverse) > 0)
    assert meta.has_thinglass and cfg.settings.tint_thinglass


def _tree_through(front_end, calls):
    """An `intersect_bvh` stand-in that sends the CPU's BVH queries
    through a cluster front end (its kernels' plain versions), counting
    them in `calls`."""
    def tree(scene, ro, rd, t_min, t_max, exclude=None, any_hit=False):
        calls.append(any_hit)
        r, dev = ro.shape[0], ro.device
        return isect.Hit(*front_end(
            scene.clusters, scene.tri_pack, ro.contiguous(), rd.contiguous(),
            isect._lanes(t_min, r, torch.float32, dev),
            isect._lanes(t_max, r, torch.float32, dev),
            isect._lanes(-1 if exclude is None else exclude, r, torch.int32,
                         dev), any_hit=any_hit))
    return tree


def test_trace_through_binned_pipeline(tmp_path, monkeypatch):
    """The BVH box traced with every query through the binned front end
    (walk_plain, sweep_plain, pass 2 through cluster_plain) equals the
    trace through the K2 front end bit for bit, and matches rgk_tpu."""
    path = _bvh_box(tmp_path)
    traces, calls = {}, []
    for name, fn in (("k2", isect.intersect_clusters),
                     ("binned", isect.intersect_clusters_binned)):
        monkeypatch.setattr(isect, "intersect_bvh", _tree_through(fn, calls))
        traces[name] = _port_trace(path, has_bvh=True)
    assert True in calls and False in calls  # both kinds of query
    assert torch.equal(traces["binned"][0], traces["k2"][0])
    assert int(traces["binned"][1]) == int(traces["k2"][1])
    _assert_close(traces["binned"], _reference_trace(path, has_bvh=True))


def test_colonnade_routes_agree_on_the_cpu(tmp_path, monkeypatch):
    """The small colonnade of chip_smoke.py phase 8 (33,960 triangles,
    depth 2; here 32x18, 2 spp) renders to the same image bit for bit
    through intersect_bvh and through the K2 front end's plain version:
    where the card's image parts from the CPU's (ROADMAP.md section 3,
    fault 2), the intersection route is not the cause."""
    path = scenes.colonnade(tmp_path, 20000, **{"output-width": 32,
                                                "output-height": 18,
                                                "multisample": 2})
    images, calls = {}, []
    for name in ("bvh", "k2"):
        if name == "k2":
            monkeypatch.setattr(isect, "intersect_bvh", _tree_through(
                isect.intersect_clusters, calls))
        out = tmp_path / name
        assert cli.main([path, "--cpu", "-q", "-D", str(out)]) == 0
        images[name] = read_exr(os.path.join(str(out), "colonnade.exr"))
    assert True in calls and False in calls
    np.testing.assert_array_equal(images["k2"], images["bvh"])
    assert images["bvh"].mean() > 0.0


def test_cpu_render_ignores_rgk_binned(tmp_path, monkeypatch):
    """On the CPU a BVH scene walks intersect_bvh whatever RGK_BINNED
    says, as the reference does off the TPU: `all` renders the same
    image as `off`, bit for bit, and never reaches the binned front
    end."""
    path = _bvh_box(tmp_path)

    def refuse(*a, **kw):
        raise AssertionError("the CPU reached the binned front end")

    monkeypatch.setattr(isect, "intersect_clusters_binned", refuse)
    images = {}
    for mode in ("off", "all"):
        monkeypatch.setenv("RGK_BINNED", mode)
        images[mode] = _port_render(path, tmp_path / mode)
    np.testing.assert_array_equal(images["all"], images["off"])
    assert images["off"].mean() > 0.0


def test_cli_needs_cuda_or_cpu_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.main([_box(tmp_path), "-q", "-D", str(tmp_path)])
    assert not os.path.exists(tmp_path / "bdpt_box.exr")


def test_smoke_imports_only_the_port():
    """chip_smoke.py takes everything of this repo from rgk_tpu_torch
    (and tools/' scene generators), nothing from the JAX package: neither
    the smoke nor any module of the port that it reaches through its
    imports names rgk_tpu, jax or jaxlib."""
    import ast

    refused = ("rgk_tpu", "jax", "jaxlib")

    def source(name):
        """-> (file, is a package) of a module of this repo, or None."""
        base = os.path.join(REPO, *name.split("."))
        if os.path.exists(base + ".py"):
            return base + ".py", False
        init = os.path.join(base, "__init__.py")
        return (init, True) if os.path.exists(init) else None

    def imports(name, path, is_pkg):
        """Absolute names a module imports (`from a import b` gives a and
        a.b, which may be a submodule)."""
        with open(path) as f:
            tree = ast.parse(f.read())
        here = name.split(".")[:None if is_pkg else -1]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module
                if node.level:
                    parts = here[:len(here) - node.level + 1]
                    mod = ".".join(parts + ([mod] if mod else []))
                yield mod
                yield from (f"{mod}.{a.name}" for a in node.names)

    names, seen, todo = set(), set(), ["chip_smoke"]
    while todo:
        name = todo.pop()
        found = source(name)
        if found is None or name in seen:
            continue
        seen.add(name)
        for mod in imports(name, *found):
            names.add(mod)
            if mod.split(".")[0] == "rgk_tpu_torch":
                todo.append(mod)
    assert "rgk_tpu_torch.io" in names
    assert len([n for n in seen if n.startswith("rgk_tpu_torch")]) >= 30
    bad = sorted(n for n in names if n.split(".")[0] in refused)
    assert bad == []


def test_port_render_imports_no_jax(tmp_path):
    """A process that imports the port and renders a flat and a BVH
    scene, the latter under RGK_BINNED=all, keeps JAX and the JAX
    package rgk_tpu out."""
    path = _box(tmp_path, res=8, ms=1)
    bvh_path = _bvh_box(tmp_path, res=4, ms=1)
    bvh_dir = str(tmp_path / "bvh")
    code = (
        "import os, sys\n"
        "from rgk_tpu_torch.driver.cli import main\n"
        f"main([{path!r}, '--cpu', '-q', '-D', {str(tmp_path)!r}])\n"
        "os.environ['RGK_BINNED'] = 'all'\n"
        f"main([{bvh_path!r}, '--cpu', '-q', '-D', {bvh_dir!r}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('rgk_tpu', 'jax', 'jaxlib'))\n"
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
