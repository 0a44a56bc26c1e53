"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It drives rgk_tpu_torch, never JAX,
through five phases and exits non-zero at the first that fails:

1. device: the card's name and power limit (nvidia-smi), torch/CUDA;
2. build: compiles the port's CUDA kernels from `rgk_tpu_torch/csrc`;
3. the flat-sweep kernel (K1) against its plain PyTorch version on a
   random soup of 4000 triangles and 2^20 rays, closest hit (with a t
   window and an exclude pass) and any hit, with median times;
4. the slice render: the bdpt_scene box plus a sphere, 3870 triangles,
   at 512x512, 16 spp, one round, through the port's CLI on the card;
   every K1 launch of that run is counted, and the first closest-hit
   and any-hit queries it made are replayed through kernel and plain
   version at the shapes the render gave them;
5. the card's image against the port's CPU image of the same scene
   (64x64, 4 spp, depth 3) under bench.py parity_gate's bounds.

Kernel tolerances: triangle ids equal on >= 99.99% of rays (nvcc
contracts multiply-adds to FMA, the plain version does not, which can
flip a hit exactly on an edge); t within rtol 3e-4 / atol 1e-6 where ids
agree; any-hit validity equal on >= 99.99% of rays.

Prints one line per phase, then a JSON line of the kernels, and last
`{"ok": true, "device": {...}}`.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from bdpt_scene import scene_dict  # noqa: E402
from make_bigscene import _write_obj, make_sphere  # noqa: E402

from rgk_tpu.io.exr import read_exr  # noqa: E402
from rgk_tpu_torch import kernels  # noqa: E402
from rgk_tpu_torch.driver import cli  # noqa: E402
from rgk_tpu_torch.ops import flat_intersect as fi  # noqa: E402
from rgk_tpu_torch.ops import intersect as isect  # noqa: E402
from rgk_tpu_torch.parity import image_parity  # noqa: E402
from rgk_tpu_torch.scene.builder import build_tri_pack  # noqa: E402

K1_SOURCE = "rgk_tpu_torch/csrc/flat_intersect.cu"
K1_REPLACES = "rgk_tpu/ops/pallas_intersect.py:122"
MIN_AGREE = 0.9999
T_RTOL, T_ATOL = 3e-4, 1e-6
TIMED_RUNS = 20


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, runs=TIMED_RUNS):
    """Median device time of `fn` in ms over `runs`, after a warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(args, any_hit):
    """Kernel against plain version on the same inputs.  Returns
    (kernel outputs, share of rays whose id/validity agree, max abs
    error of t and barycentrics where closest-hit ids agree)."""
    k = fi.intersect_flat(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    p = fi.flat_plain(*args, any_hit=any_hit)
    same = k[1] == p[1]
    agree = same.double().mean().item()
    check(agree >= MIN_AGREE, f"{'any' if any_hit else 'closest'}-hit ids "
          f"agree on {agree:.6f} of rays, below {MIN_AGREE}")
    if any_hit:
        return k, agree, 0.0 if bool(same.all()) else 1.0
    both = same & (p[1] >= 0)
    kt, pt = k[0][both], p[0][both]
    bad = (kt - pt).abs() > T_ATOL + T_RTOL * pt.abs()
    check(not bool(bad.any()), f"closest-hit t outside rtol {T_RTOL} on "
          f"{int(bad.sum())} rays: kernel {kt[bad][:4].tolist()} plain "
          f"{pt[bad][:4].tolist()}")
    err = max(float((a[both] - b[both]).abs().max()) if bool(both.any())
              else 0.0 for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])))
    return k, agree, err


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"[1/5 device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}")


def phase_build():
    t0 = time.perf_counter()
    info = kernels.build()
    kernels.load()
    secs = time.perf_counter() - t0
    print(f"[2/5 build] {os.path.relpath(info['path'], ROOT)} "
          f"nvcc {info['seconds']:.3f} s, build+load {secs:.3f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")


def random_soup(n_tris, n_rays, seed, dev):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n_tris, 3))
    verts = (centers[:, None, :]
             + rng.normal(0, 0.6, (n_tris, 3, 3))).reshape(-1, 3)
    pack = np.zeros((n_tris, 13), np.float32)
    pack[:, :12] = build_tri_pack(verts.astype(np.float32),
                                  np.arange(3 * n_tris).reshape(-1, 3))
    pack[::97, 12] = 1.0  # a few thin-glass rows, which never block
    ro = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = rng.uniform(4.0, 30.0, n_rays).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (pack, ro, rd, t_max)]


def phase_k1(dev):
    n_tris, n_rays = 4000, 1 << 20
    pack, ro, rd, t_max = random_soup(n_tris, n_rays, seed=1, dev=dev)
    n_tris, n_rays = pack.shape[0], ro.shape[0]
    none = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    window = [pack, ro, rd, torch.full_like(t_max, 0.5), t_max, none]
    k, agree1, err1 = compare(window, any_hit=False)
    hits = k[1] >= 0
    check(0.05 < hits.double().mean().item() < 0.95,
          "the soup's hit rate is degenerate")
    check(bool(((k[0][hits] > 0.5) & (k[0][hits] < t_max[hits])).all()),
          "a closest hit lies outside its t window")
    check(not bool((pack[k[1][hits].long(), 12] > 0.5).any()),
          "a thin-glass row won a closest hit")

    # The exclude pass keeps the window: near t = 0 the plane distance
    # cancels, and t carries an absolute error that no rtol bounds.
    excl = k[1].contiguous()
    k2, agree2, err2 = compare(window[:5] + [excl], any_hit=False)
    check(not bool(((k2[1] == excl) & (excl >= 0)).any()),
          "an excluded triangle id was returned")

    _, agree3, _ = compare(window, any_hit=True)
    ms = {m: median_ms(lambda: fi.intersect_flat(*window, any_hit=m))
          for m in (False, True)}
    plain = {m: median_ms(lambda: fi.flat_plain(*window, any_hit=m))
             for m in (False, True)}
    print(f"[3/5 K1 {n_tris} tris x {n_rays} rays] closest agree "
          f"{agree1:.6f} (excl pass {agree2:.6f}) max|err| "
          f"{max(err1, err2):.3g}; any-hit agree {agree3:.6f}; median ms "
          f"closest kernel {ms[False]:.3f} plain {plain[False]:.3f}, any "
          f"kernel {ms[True]:.3f} plain {plain[True]:.3f}")


def write_scene(d, res, ms, **overrides):
    cfg = scene_dict(res=res, ms=ms, reverse=0)
    cfg.update(overrides)
    verts, nrms, faces = make_sphere(3900, 0.0, 0.9, 0.6, 0.6)
    _write_obj(os.path.join(d, "sphere.obj"), verts, nrms, faces)
    cfg["scene"].append({"file": "sphere.obj", "material": "white"})
    path = os.path.join(d, f"box_sphere_{res}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def render(cfg_path, out_dir, *extra):
    check(cli.main([cfg_path, "-q", "-D", out_dir, *extra]) == 0,
          f"the CLI failed on {cfg_path}")
    img = read_exr(os.path.join(out_dir, "bdpt_box.exr"))
    with np.load(os.path.join(out_dir, "bdpt_box.exr.ckpt.npz")) as ck:
        rays = int(ck["rays"])
    return img, rays


class FirstCalls:
    """Keeps a copy of the first closest-hit and any-hit query the
    integrator makes, to replay them at the render's own shapes."""

    def __init__(self):
        self.args = {}
        self._orig = isect.intersect_flat

    def __call__(self, *args, any_hit=False):
        if any_hit not in self.args:
            self.args[any_hit] = [a.clone() for a in args]
        return self._orig(*args, any_hit=any_hit)

    def __enter__(self):
        isect.intersect_flat = self
        return self

    def __exit__(self, *exc):
        isect.intersect_flat = self._orig


def phase_render(d):
    path = write_scene(d, res=512, ms=16)
    out_dir = os.path.join(d, "render")
    fi.launches.update(closest=0, any=0)
    with FirstCalls() as first:
        t0 = time.perf_counter()
        img, rays = render(path, out_dir)
        wall = time.perf_counter() - t0
    launches = dict(fi.launches)
    check(img.shape == (512, 512, 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "the image has non-finite pixels")
    check(float(img.mean()) > 0.0, "the image is black")
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the render did not go through K1: launches {launches}")
    n_tris = first.args[False][0].shape[0]
    check(n_tris == 3870, f"scene has {n_tris} triangles, not 3870")
    print(f"[4/5 render 512x512 16spp {n_tris} tris] wall {wall:.3f} s, "
          f"{rays} extension rays, {rays / wall:.1f} rays/s, K1 launches "
          f"{launches}, image mean {float(img.mean()):.5f}")

    entries = []
    for any_hit in (False, True):
        args = first.args[any_hit]
        _, agree, err = compare(args, any_hit)
        kms = median_ms(lambda: fi.intersect_flat(*args, any_hit=any_hit))
        pms = median_ms(lambda: fi.flat_plain(*args, any_hit=any_hit))
        mode = "any" if any_hit else "closest"
        print(f"    K1 {mode} at the render's shapes ({args[1].shape[0]} "
              f"rays x {n_tris} tris): agree {agree:.6f} max|err| "
              f"{err:.3g}, median ms kernel {kms:.3f} plain {pms:.3f}")
        entries.append({"name": f"flat_intersect_{mode}", "route": "cuda",
                        "source": K1_SOURCE, "replaces": K1_REPLACES,
                        "launches": launches[mode], "max_abs_err": err,
                        "ms": kms, "plain_ms": pms})
    return entries


def phase_cpu_parity(d):
    path = write_scene(d, res=64, ms=4, **{"recursion-max": 3})
    gpu, _ = render(path, os.path.join(d, "gpu64"))
    cpu, _ = render(path, os.path.join(d, "cpu64"), "--cpu")
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"card vs CPU image parity failed: {stats}")
    print(f"[5/5 card vs CPU 64x64 4spp depth 3] corr {stats['corr']:.6f} "
          f"trimmed {stats['corr_trim']:.6f} mean rel diff "
          f"{stats['mean_rel_diff']:.3g} max|diff| {stats['max_abs_diff']:.3g} "
          f"outlier pixels {stats['outlier_pixels']}, max per tile "
          f"{stats['max_outliers_per_tile']} (cap {stats['tile_cap']})")


def main():
    phase_device()
    phase_build()
    dev = torch.device("cuda")
    phase_k1(dev)
    with tempfile.TemporaryDirectory() as d:
        entries = phase_render(d)
        phase_cpu_parity(d)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
