"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It drives rgk_tpu_torch, never JAX,
through twelve phases and exits non-zero at the first that fails:

1. device: the card's name and power limit (nvidia-smi), torch/CUDA;
2. build: compiles the port's CUDA kernels from `rgk_tpu_torch/csrc`,
   one nvcc per source, all started together;
3. the flat-sweep kernel (K1) against its plain PyTorch version on a
   random soup of 4000 triangles and 2^20 rays, closest hit (with a t
   window and an exclude pass) and any hit, with median times;
4. the cluster kernel (K2) against its plain version `cluster_plain` on
   a random soup of 200,000 triangles and 2^20 rays, on both leaf
   layouts (64-triangle halves, and 8-half chunks of 4 tiles through
   CHUNK_CAP = 512): closest hit in a t window, an exclude pass, any
   hit, a third of the lanes with an empty interval; per-ray counters;
   median times (plain over fewer runs);
5. the flat render: the bdpt_scene box plus a sphere, 3870 triangles,
   at 512x512, 16 spp, one round, through the port's CLI on the card;
   every K1 launch of that run is counted (no K2 launch), and the first
   closest-hit and any-hit queries are replayed through kernel and plain
   version at the render's shapes;
6. the flat card image against the port's CPU image (64x64, 4 spp,
   depth 3) under the image parity bounds (rgk_tpu_torch/parity.py);
7. the colonnade render: tools/make_bigscene's scene at 995,628
   triangles, 960x540, depth 2, one round, through the CLI on the card,
   multisample cut from the config's 40 to 8 for the time limit; every
   K2 launch is counted (no K1 launch), the host build seconds and the
   K2 stream time of the round are reported, and the first closest-hit
   and any-hit queries are replayed, with counters;
8. the colonnade card image against the port's CPU image (33,960
   triangles, 64x36, 4 spp, depth 2);
9. the binned kernels, walk-emit (K3) and chunk sweep (K4), against
   their plain versions on phase 4's soup and layouts, with K = 8 and
   K = 2 (which overflows and runs pass 2): closest hit in the window,
   an exclude pass, any hit, the empty lanes.  The plain versions run
   on every 4th sorted ray (2^18) for the time limit; the whole binned
   front end is held to K2's on all 2^20 rays;
10. the colonnade of phase 7 rendered again through the CLI with
   RGK_BINNED=any and then all (the environment restored after each):
   K3/K4 launches counted (K1 none, K2 as the mode implies), round wall
   time, rays/s, the stream time of K3, K4, pass 2 and the glue, the
   first binned query replayed against the plain versions and against
   K2, and each image against phase 7's K2 image;
11. the small colonnade of phase 8 rendered on the card with
   RGK_BINNED=all, against phase 8's CPU image;
12. the probes P1 (shared memory per block, the u16 unpack, the cp.async
   row copy) and P2 (block votes, sweeps, tile fetches) through their
   tools' functions, against their plain versions, with the card's
   numbers.

The colonnade is composed from tools/make_bigscene's functions with its
budget split; its stone texture is written as the linear EXR that the
texture loader makes of the generator's PNG, so no PIL is needed.

Kernel tolerances: triangle ids equal on >= 99.99% of rays (nvcc
contracts multiply-adds to FMA, the plain versions do not, which can
flip a hit exactly on an edge); t within rtol 3e-4 / atol 1e-6 where
closest-hit ids agree; any-hit validity equal on >= 99.99% of rays;
lanes with an empty interval never hit; K4's any-hit t within rtol on
>= 99.99% of the hits whose plane distance is well conditioned
(`well_conditioned`: shadow rays start on a surface, where it cancels).
K3's lists, counts and skipmin equal the plain walk's on >= 99.99% of
lanes; the binned front end's ids equal K2's on >= 99.999% of rays (they
share the slab and row tests).

Prints one line per phase with its wall seconds, then a JSON line of
the kernels (launch counts from the renders, for K3/K4 the sum of the
two binned renders, for the probes their tool runs), and last
`{"ok": true, "device": {...}}`.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import contextlib
import copy
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

import make_bigscene as mb  # noqa: E402
from bdpt_scene import scene_dict  # noqa: E402

from rgk_tpu_torch import kernels  # noqa: E402
from rgk_tpu_torch.driver import cli  # noqa: E402
from rgk_tpu_torch.io import gamma_decode, read_exr, write_exr  # noqa: E402
from rgk_tpu_torch.ops import binned_intersect as bi  # noqa: E402
from rgk_tpu_torch.ops import cluster_intersect as ci  # noqa: E402
from rgk_tpu_torch.ops import flat_intersect as fi  # noqa: E402
from rgk_tpu_torch.ops import intersect as isect  # noqa: E402
from rgk_tpu_torch.parity import image_parity  # noqa: E402
from rgk_tpu_torch.scene import clusters as tclusters  # noqa: E402
from rgk_tpu_torch.scene.builder import build_tri_pack  # noqa: E402
from rgk_tpu_torch.tools import prof_smem_probe as p1  # noqa: E402
from rgk_tpu_torch.tools import prof_sync as p2  # noqa: E402

K1_SOURCE = "rgk_tpu_torch/csrc/flat_intersect.cu"
K1_REPLACES = "rgk_tpu/ops/pallas_intersect.py:122"
K2_SOURCE = "rgk_tpu_torch/csrc/cluster_intersect.cu"
K2_REPLACES = "rgk_tpu/ops/pallas_cluster.py:127"
K3_SOURCE = "rgk_tpu_torch/csrc/binned_walk.cu"
K3_REPLACES = "rgk_tpu/ops/pallas_binned.py:80"
K4_SOURCE = "rgk_tpu_torch/csrc/binned_sweep.cu"
K4_REPLACES = "rgk_tpu/ops/pallas_binned.py:323"
PROBE_SOURCE = "rgk_tpu_torch/csrc/probes.cu"
P1_REPLACES = "tools/prof_smem_probe.py:23"
P2_REPLACES = "tools/prof_sync.py:24"
MIN_AGREE = 0.9999
BINNED_AGREE = 0.99999
BINNED_KS = (8, 2)     # the default cap, and one that overflows
PLAIN_STRIDE = 4       # the plain K3/K4 run on every 4th sorted ray
T_RTOL, T_ATOL = 3e-4, 1e-6
TIMED_RUNS = 20
PLAIN_RUNS = 3
K1_SOUP = (4000, 1 << 20)            # triangles, rays
K2_SOUP = (200_000, 1 << 20)
# (name, CHUNK_CAP or None, the chunk_halves it gives on K2_SOUP)
K2_LAYOUTS = (("halves", None, 1), ("tiles", 512, 8))
FLAT_RES, FLAT_MS = 512, 16
# make_bigscene's triangle budget, the triangles it gives, the config's
# own resolution, and its multisample of 40 cut for the time limit.
COLONNADE_BUDGET, COLONNADE_TRIS = 1_000_000, 995_628
COLONNADE_RES, COLONNADE_MS = (960, 540), 8


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, runs=TIMED_RUNS, warmup=True):
    """Median ms of `fn` over `runs`, from CUDA events around each call
    (stream time: idle gaps between its launches count)."""
    if warmup:
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


def reset_launches():
    fi.launches.update(closest=0, any=0)
    ci.launches.update(closest=0, any=0)
    bi.launches.update(walk=0, sweep=0)
    p1.launches.update(smem=0, unpack=0, row_copy=0)
    p2.launches.update(sync=0, fetch=0)


def compare(args, any_hit):
    """K1 against its plain version on the same inputs.  Returns (kernel
    outputs, share of rays whose id/validity agree, max abs error of t
    and barycentrics where closest-hit ids agree)."""
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


def compare_k2(args, any_hit, tri_pack):
    """K2 (`traverse` on the card) against `cluster_plain` on the same
    sorted inputs (cl, ro, rd, t_min, t_max, exclude).  The kernel's t
    only selects the winner; the front end reports t and barycentrics
    recomputed from the winner's tri_pack row (`hit_record`), which is
    held to rtol where ids agree.  The kernel's own t may differ from the
    plain version's beyond rtol on grazing hits (FMA against separate
    roundings when rd.n cancels), and must agree on >= MIN_AGREE of the
    rays that hit.  Returns (kernel outputs with counters, a dict of
    agreement and counter statistics, max abs error of the reported t
    and barycentrics where closest-hit ids agree)."""
    mode = "any" if any_hit else "closest"
    k = ci.traverse(*args, any_hit=any_hit, stats=True)
    torch.cuda.synchronize()
    p = ci.cluster_plain(*args, any_hit=any_hit, stats=True)
    ro, rd, t_min, t_max = args[1:5]
    empty = ~(t_max > t_min)
    check(not bool((k[1][empty] >= 0).any()),
          f"K2 {mode}: a lane with an empty interval hit")
    valid_k, valid_p = k[1] >= 0, p[1] >= 0
    same = (valid_k == valid_p) if any_hit else (k[1] == p[1])
    agree = same.double().mean().item()
    check(agree >= MIN_AGREE, f"K2 {mode}-hit ids agree on {agree:.6f} of "
          f"rays, below {MIN_AGREE}")
    nodes, leaves = k[2].double(), k[3].double()
    stats = {"agree": agree, "hit_rate": valid_k.double().mean().item(),
             "nodes_mean": nodes.mean().item(),
             "nodes_max": int(nodes.max()),
             "leaves_mean": leaves.mean().item(),
             "leaves_max": int(leaves.max()),
             "counters_equal": ((k[2] == p[2]) & (k[3] == p[3]))
             .double().mean().item(), "raw_t_agree": 1.0,
             "raw_t_err": 0.0}
    if any_hit:
        return k, stats, 0.0 if bool(same.all()) else 1.0
    both = same & valid_p
    if bool(both.any()):
        kt, pt = k[0][both], p[0][both]
        raw_ok = (kt - pt).abs() <= T_ATOL + T_RTOL * pt.abs()
        stats["raw_t_agree"] = raw_ok.double().mean().item()
        stats["raw_t_err"] = float((kt - pt).abs().max())
        check(stats["raw_t_agree"] >= MIN_AGREE, f"K2 in-kernel t within "
              f"rtol {T_RTOL} on {stats['raw_t_agree']:.6f} of the hits")
    rk = ci.hit_record(tri_pack, ro, rd, k[0], k[1])
    rp = ci.hit_record(tri_pack, ro, rd, p[0], p[1])
    kt, pt = rk[0][both], rp[0][both]
    bad = (kt - pt).abs() > T_ATOL + T_RTOL * pt.abs()
    check(not bool(bad.any()), f"K2 reported closest-hit t outside rtol "
          f"{T_RTOL} on {int(bad.sum())} rays")
    err = max(float((rk[i][both] - rp[i][both]).abs().max())
              if bool(both.any()) else 0.0 for i in (0, 2, 3))
    return k, stats, err


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"[1/12 device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}")


def phase_build():
    t0 = time.perf_counter()
    info = kernels.build()
    kernels.load()
    secs = time.perf_counter() - t0
    print(f"[2/12 build] {os.path.relpath(info['path'], ROOT)} "
          f"nvcc {info['seconds']:.3f} s, build+load {secs:.3f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"    ptxas: {line.strip()}")


def random_soup(n_tris, seed, glass_every=97):
    """-> (vertices f32 [3n, 3], tri_vidx i32 [n, 3], tri_pack [n, 13])."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n_tris, 3))
    verts = (centers[:, None, :]
             + rng.normal(0, 0.6, (n_tris, 3, 3))).reshape(-1, 3)
    verts = verts.astype(np.float32)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    pack = np.zeros((n_tris, 13), np.float32)
    pack[:, :12] = build_tri_pack(verts, tris)
    pack[::glass_every, 12] = 1.0  # thin glass, which never blocks
    return verts, tris, pack


def random_rays(n_rays, seed, dev):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = rng.uniform(4.0, 30.0, n_rays).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, t_max)]


def phase_k1(dev):
    t_phase = time.perf_counter()
    n_tris, n_rays = K1_SOUP
    pack = torch.from_numpy(random_soup(n_tris, seed=1)[2]).to(dev)
    ro, rd, t_max = random_rays(n_rays, seed=1, dev=dev)
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
    print(f"[3/12 K1 {n_tris} tris x {n_rays} rays] closest agree "
          f"{agree1:.6f} (excl pass {agree2:.6f}) max|err| "
          f"{max(err1, err2):.3g}; any-hit agree {agree3:.6f}; median ms "
          f"closest kernel {ms[False]:.3f} plain {plain[False]:.3f}, any "
          f"kernel {ms[True]:.3f} plain {plain[True]:.3f} "
          f"({time.perf_counter() - t_phase:.1f} s)")


def phase_k2(dev):
    """-> {layout: ClusterArrays} of the soup, for phase 9."""
    t_phase = time.perf_counter()
    n_tris, n_rays = K2_SOUP
    verts, tris, pack = random_soup(n_tris, seed=2)
    tri_pack = torch.from_numpy(pack).to(dev)
    ro, rd, t_max = random_rays(n_rays, seed=2, dev=dev)
    t_max = torch.where(torch.arange(n_rays, device=dev) % 3 == 0, -1.0,
                        t_max)
    t_min = torch.full_like(t_max, 0.5)
    none = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    trees = {}
    for layout, cap, want_halves in K2_LAYOUTS:
        saved = tclusters.CHUNK_CAP
        if cap is not None:
            tclusters.CHUNK_CAP = cap
        try:
            t0 = time.perf_counter()
            cl = tclusters.build_clusters(verts, tris, pack, device=dev)
            build_s = time.perf_counter() - t0
        finally:
            tclusters.CHUNK_CAP = saved
        halves = cl.chunk_halves
        check(halves == want_halves, f"{layout}: chunk_halves {halves}")
        trees[layout] = cl
        _, *srt = ci.sort_rays(cl, ro, rd, t_min, t_max, none)
        args = [cl, *srt]
        k, s1, err1 = compare_k2(args, False, tri_pack)
        hits = k[1] >= 0
        check(0.05 < hits.double().mean().item() < 0.95,
              f"{layout}: the soup's hit rate is degenerate")
        check(not bool(torch.from_numpy(pack[:, 12] > 0.5).to(dev)[
            k[1][hits].long()].any()), "a thin-glass row won a closest hit")
        excl = k[1].contiguous()
        k2, s2, err2 = compare_k2(args[:5] + [excl], False, tri_pack)
        check(not bool(((k2[1] == excl) & (excl >= 0)).any()),
              "an excluded triangle id was returned")
        _, s3, _ = compare_k2(args, True, tri_pack)
        ms = {m: median_ms(lambda: ci.traverse(*args, any_hit=m))
              for m in (False, True)}
        plain = {m: median_ms(lambda: ci.cluster_plain(*args, any_hit=m),
                              runs=PLAIN_RUNS, warmup=False)
                 for m in (False, True)}
        tpc = max(1, halves // 2)
        print(f"[4/12 K2 {n_tris} tris x {n_rays} rays, {layout}: "
              f"chunk_halves {halves}, tpc {tpc}, "
              f"{cl.boxes_q.shape[0] // 3} nodes, host build {build_s:.3f} s]"
              f" closest agree {s1['agree']:.6f} (excl pass "
              f"{s2['agree']:.6f}), reported max|err| {max(err1, err2):.3g},"
              f" in-kernel t within rtol on {s1['raw_t_agree']:.6f}/"
              f"{s2['raw_t_agree']:.6f} of hits (max|t err| "
              f"{max(s1['raw_t_err'], s2['raw_t_err']):.3g}); any "
              f"agree {s3['agree']:.6f}; counters equal {s1['counters_equal']:.6f}"
              f"/{s3['counters_equal']:.6f}; nodes/ray closest "
              f"{s1['nodes_mean']:.1f} (max {s1['nodes_max']}), leaves "
              f"{s1['leaves_mean']:.2f} (max {s1['leaves_max']}); median ms "
              f"closest kernel {ms[False]:.3f} plain {plain[False]:.3f}, any "
              f"kernel {ms[True]:.3f} plain {plain[True]:.3f} "
              f"(plain over {PLAIN_RUNS} runs)")
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return trees


def write_box(d, res, ms, **overrides):
    cfg = scene_dict(res=res, ms=ms, reverse=0)
    cfg.update(overrides)
    verts, nrms, faces = mb.make_sphere(3900, 0.0, 0.9, 0.6, 0.6)
    mb._write_obj(os.path.join(d, "sphere.obj"), verts, nrms, faces)
    cfg["scene"].append({"file": "sphere.obj", "material": "white"})
    path = os.path.join(d, f"box_sphere_{res}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def stone_texture(n=512):
    """make_bigscene.make_stone_texture's image, as the texture loader
    decodes its PNG: 8-bit sRGB values gamma-decoded to linear."""
    rng = np.random.default_rng(7)
    img = np.zeros((n, n))
    for octave in range(4):
        k = 8 << octave
        coarse = rng.standard_normal((k, k))
        img += np.kron(coarse, np.ones((n // k, n // k))) / (1.6 ** octave)
    img = (img - img.min()) / (img.max() - img.min())
    line = ((np.arange(n) % 64) < 3).astype(float)
    mortar = np.maximum(line[None, :], line[:, None])
    base = 0.45 + 0.35 * img
    rgb = np.stack([base * 1.02, base * 0.98, base * 0.92], axis=-1)
    rgb = rgb * (1.0 - 0.45 * mortar[..., None])
    u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return gamma_decode(u8.astype(np.float32) / 255.0)


def write_colonnade(d, n_tris, **overrides):
    """make_bigscene.generate(d, n_tris) without PIL: the same OBJs and
    config, the stone texture as EXR.  Returns (config path, triangles)."""
    os.makedirs(d, exist_ok=True)
    gn = max(64, int(np.sqrt(0.30 * n_tris / 2 / 2.5)))
    gv, gnrm, gf, guv = mb.make_ground(gn)
    per_col = int(0.55 * n_tris / 12)
    nh = max(8, int(np.sqrt(per_col / 2 / 2.6)))
    ntheta = max(12, per_col // (2 * max(nh - 1, 1)))
    columns = mb._merge([mb.make_column(ntheta, nh, x, -15.0 + 6.0 * i)
                         for i in range(6) for x in (-3.2, 3.2)])
    per_s = int(0.15 * n_tris / 3)
    spheres = mb._merge([
        mb.make_sphere(per_s, 0.0, 1.2, -9.0, 1.2),
        mb.make_sphere(per_s, -1.5, 0.9, -1.0, 0.9),
        mb.make_sphere(per_s, 1.6, 1.0, 7.0, 1.0),
    ])
    mb._write_obj(os.path.join(d, "ground.obj"), gv, gnrm, gf, uvs=guv)
    total = len(gf)
    for name, (v, n, f) in (("columns.obj", columns),
                            ("spheres.obj", spheres),
                            ("panels.obj", mb.make_panels())):
        mb._write_obj(os.path.join(d, name), v, n, f)
        total += len(f)
    write_exr(os.path.join(d, "stone.exr"), stone_texture())
    cfg = copy.deepcopy(mb.CONFIG)
    cfg["materials"][0]["diffuse-texture"] = "stone.exr"
    cfg.update(overrides)
    path = os.path.join(d, "colonnade.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, total


def render(cfg_path, out_dir, *extra):
    check(cli.main([cfg_path, "-q", "-D", out_dir, *extra]) == 0,
          f"the CLI failed on {cfg_path}")
    with open(cfg_path) as f:
        name = json.load(f)["output-file"]
    img = read_exr(os.path.join(out_dir, name))
    with np.load(os.path.join(out_dir, name + ".ckpt.npz")) as ck:
        rays = int(ck["rays"])
    return img, rays


class FirstCalls:
    """Wraps `module.name`: keeps a copy of the arguments of the first
    closest-hit and any-hit call (a call without `any_hit` counts as
    closest), to replay them at the render's shapes, the host time of the
    first call and, with `timed`, CUDA events around every call.  With
    `within`, another FirstCalls, each call's events are tagged with
    whether it ran inside a call of that one."""

    def __init__(self, module, name, timed=False, within=None):
        self.module, self.name, self.timed = module, name, timed
        self.within, self.active = within, False
        self.args, self.events, self.first_t = {}, [], None
        self._orig = getattr(module, name)

    def __call__(self, *args, **kw):
        any_hit = kw.get("any_hit", False)
        if self.first_t is None:
            self.first_t = time.perf_counter()
        if any_hit not in self.args:
            self.args[any_hit] = [a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args]
        if not self.timed:
            return self._orig(*args, **kw)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        inside = self.within is not None and self.within.active
        self.active = True
        ev[0].record()
        try:
            out = self._orig(*args, **kw)
        finally:
            self.active = False
        ev[1].record()
        self.events.append((*ev, inside))
        return out

    def stream_ms(self, inside=None):
        """Summed ms between the events around each call, which include
        the stream's idle gaps while the host issues the call's launches
        (only the calls inside `within`, or only those outside, when
        `inside` is given)."""
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b, w in self.events
                   if inside is None or w == inside)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


def phase_render(d):
    t_phase = time.perf_counter()
    res, ms = FLAT_RES, FLAT_MS
    path = write_box(d, res=res, ms=ms)
    out_dir = os.path.join(d, "render")
    reset_launches()
    with FirstCalls(isect, "intersect_flat") as first:
        t0 = time.perf_counter()
        img, rays = render(path, out_dir)
        wall = time.perf_counter() - t0
    launches, k2 = dict(fi.launches), dict(ci.launches)
    check(img.shape == (res, res, 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "the image has non-finite pixels")
    check(float(img.mean()) > 0.0, "the image is black")
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the render did not go through K1: launches {launches}")
    check(k2 == {"closest": 0, "any": 0}, f"a flat scene launched K2: {k2}")
    n_tris = first.args[False][0].shape[0]
    check(n_tris == 3870, f"scene has {n_tris} triangles, not 3870")
    print(f"[5/12 flat render {res}x{res} {ms}spp {n_tris} tris] wall "
          f"{wall:.3f} s, "
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
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return entries


def phase_cpu_parity(d):
    t_phase = time.perf_counter()
    path = write_box(d, res=64, ms=4, **{"recursion-max": 3})
    gpu, _ = render(path, os.path.join(d, "gpu64"))
    cpu, _ = render(path, os.path.join(d, "cpu64"), "--cpu")
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"card vs CPU image parity failed: {stats}")
    print(f"[6/12 flat card vs CPU 64x64 4spp depth 3] corr {stats['corr']:.6f}"
          f" trimmed {stats['corr_trim']:.6f} mean rel diff "
          f"{stats['mean_rel_diff']:.3g} max|diff| {stats['max_abs_diff']:.3g}"
          f" outlier pixels {stats['outlier_pixels']}, max per tile "
          f"{stats['max_outliers_per_tile']} (cap {stats['tile_cap']}) "
          f"({time.perf_counter() - t_phase:.1f} s)")


def phase_colonnade(d):
    t_phase = time.perf_counter()
    res = COLONNADE_RES
    t0 = time.perf_counter()
    path, n_tris = write_colonnade(
        os.path.join(d, "colonnade"), COLONNADE_BUDGET,
        **{"multisample": COLONNADE_MS, "output-width": res[0],
           "output-height": res[1]})
    gen_s = time.perf_counter() - t0
    check(n_tris == COLONNADE_TRIS, f"colonnade of {n_tris} triangles")
    with open(path) as f:
        check(json.load(f)["recursion-max"] == 2, "colonnade depth")
    print(f"    colonnade: {n_tris} triangles, {res[0]}x{res[1]}, depth 2, "
          f"multisample cut from {mb.CONFIG['multisample']} to "
          f"{COLONNADE_MS}; OBJ + texture written in {gen_s:.3f} s")

    built = []
    build_scene = cli.build_scene

    def keep_builder(*a, **kw):
        out = build_scene(*a, **kw)
        built.append(out)
        return out

    out_dir = os.path.join(d, "colonnade_out")
    reset_launches()
    cli.build_scene = keep_builder
    try:
        with FirstCalls(ci, "traverse", timed=True) as first:
            t0 = time.perf_counter()
            img, rays = render(path, out_dir)
            t1 = time.perf_counter()
    finally:
        cli.build_scene = build_scene
    launches, k1 = dict(ci.launches), dict(fi.launches)
    check(img.shape == (res[1], res[0], 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "the image has non-finite pixels")
    check(float(img.mean()) > 0.0, "the image is black")
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the render did not go through K2: launches {launches}")
    check(k1 == {"closest": 0, "any": 0}, f"the colonnade launched K1: {k1}")
    arrays, _, builder = built[0]
    check(builder.sah_builder == "native",
          f"SAH builder {builder.sah_builder}")
    host = builder.timings
    round_s = t1 - first.first_t
    k2_ms = first.stream_ms()
    print(f"[7/12 colonnade {res[0]}x{res[1]} {COLONNADE_MS}spp depth 2 "
          f"{n_tris} tris]"
          f" CLI wall {t1 - t0:.3f} s, of which host build "
          f"{sum(host.values()):.3f} s ({builder.sah_builder} SAH builder: "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
          + f"); round (first query to EXR) {round_s:.3f} s, {rays} "
          f"extension rays, {rays / round_s:.1f} rays/s; K2 launches "
          f"{launches}, K2 stream time {k2_ms:.3f} ms "
          f"({k2_ms / 10 / round_s:.2f}% of the round); image mean "
          f"{float(img.mean()):.5f}")

    entries = []
    for any_hit in (False, True):
        args = first.args[any_hit]
        _, st, err = compare_k2(args, any_hit, arrays.tri_pack)
        kms = median_ms(lambda: ci.traverse(*args, any_hit=any_hit))
        pms = median_ms(lambda: ci.cluster_plain(*args, any_hit=any_hit),
                        runs=PLAIN_RUNS, warmup=False)
        mode = "any" if any_hit else "closest"
        live = int((args[4] > args[3]).sum())
        print(f"    K2 {mode} at the render's shapes ({args[1].shape[0]} "
              f"rays, {live} with a non-empty interval, x {n_tris} tris): "
              f"agree {st['agree']:.6f}, reported max|err| {err:.3g}, "
              f"in-kernel t within rtol on {st['raw_t_agree']:.6f} of hits "
              f"(max|t err| {st['raw_t_err']:.3g}), hit rate "
              f"{st['hit_rate']:.4f}; per ray nodes {st['nodes_mean']:.1f} "
              f"(max {st['nodes_max']}), leaves {st['leaves_mean']:.2f} (max "
              f"{st['leaves_max']}), counters equal {st['counters_equal']:.6f};"
              f" median ms kernel {kms:.3f} plain {pms:.3f} (plain over "
              f"{PLAIN_RUNS} runs)")
        # The kernel's own output: in-kernel t (closest), validity (any).
        entries.append({"name": f"cluster_intersect_{mode}", "route": "cuda",
                        "source": K2_SOURCE, "replaces": K2_REPLACES,
                        "launches": launches[mode],
                        "max_abs_err": err if any_hit else st["raw_t_err"],
                        "ms": kms, "plain_ms": pms})
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return entries, path, img


def phase_colonnade_parity(d):
    """-> (config path, the port's CPU image), for phase 11."""
    t_phase = time.perf_counter()
    path, n_tris = write_colonnade(
        os.path.join(d, "colonnade_small"), 20000,
        **{"output-width": 64, "output-height": 36, "multisample": 4})
    check(n_tris == 33960, f"small colonnade of {n_tris} triangles")
    reset_launches()
    gpu, _ = render(path, os.path.join(d, "col_gpu"))
    check(ci.launches["closest"] > 0 and fi.launches["closest"] == 0,
          f"the small colonnade did not go through K2: {ci.launches}")
    cpu, _ = render(path, os.path.join(d, "col_cpu"), "--cpu")
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"colonnade card vs CPU image parity failed: {stats}")
    print(f"[8/12 colonnade card vs CPU {n_tris} tris 64x36 4spp depth 2] "
          f"corr {stats['corr']:.6f} trimmed {stats['corr_trim']:.6f} mean "
          f"rel diff {stats['mean_rel_diff']:.3g} max|diff| "
          f"{stats['max_abs_diff']:.3g} outlier pixels "
          f"{stats['outlier_pixels']}, max per tile "
          f"{stats['max_outliers_per_tile']} (cap {stats['tile_cap']}) "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return path, cpu


# ------------------------------------------------ the binned pipeline


def compare_k3(cl, srt, K):
    """K3 (`walk`) against `walk_plain` on sorted rays srt = (ro, rd,
    t_min, t_max, ...).  -> (kernel outputs, share of lanes whose list,
    count and skipmin (bitwise) agree, max |count difference|)."""
    ro, rd, t_min, t_max = srt[:4]
    k = bi.walk(cl, ro, rd, t_min, t_max, K)
    torch.cuda.synchronize()
    p = bi.walk_plain(cl, ro, rd, t_min, t_max, K)
    same = ((k[0] == p[0]).all(dim=1) & (k[1] == p[1])
            & (k[2].view(torch.int32) == p[2].view(torch.int32)))
    agree = same.double().mean().item()
    check(agree >= MIN_AGREE, f"K3 K={K}: lists agree on {agree:.6f} of "
          f"lanes, below {MIN_AGREE}")
    empty = ~(t_max > t_min)
    check(not bool((k[1][empty] != 0).any()),
          "K3: a lane with an empty interval listed a chunk")
    return k, agree, int((k[1] - p[1]).abs().max())


def pairs_of(ids, K):
    cid, pos = bi.make_pairs(ids)
    return cid, torch.div(pos, K, rounding_mode="floor").to(torch.int32)


def well_conditioned(tri_pack, ro, rd, tri):
    """True where float32 rounding cannot move t = -(ro.n + d) / (rd.n)
    by rtol: the cancellation factors of numerator and denominator
    (sum of the terms' magnitudes over the magnitude of the sum, in
    float64), times 16 float32 epsilons for the two roundings' worth of
    kernel and plain version, stay within T_RTOL."""
    rows = tri_pack[tri.long()].double()
    n, d = rows[:, 0:3], rows[:, 3]
    o, v = ro.double(), rd.double()
    num = (o * n).sum(1) + d
    den = (v * n).sum(1)
    kappa = (((o * n).abs().sum(1) + d.abs()) / num.abs()
             + (v * n).abs().sum(1) / den.abs())
    return kappa * 16 * float(torch.finfo(torch.float32).eps) <= T_RTOL


def compare_k4(cl, tri_pack, srt, cid, ray_of, any_hit):
    """K4 (`sweep_pairs`) against `sweep_plain` on the same sorted pairs.
    -> (share of listed pairs whose id agrees, share of their hits whose
    t is within rtol, share of the well-conditioned hits whose t is
    within rtol, share of hits that are well conditioned, max |t error|
    where ids agree).  As for K2, the in-kernel t is held to rtol on
    every hit of a closest-hit query; a shadow ray starts on a surface,
    and on hits near its origin the plane distance cancels, so FMA and
    separate roundings part by more than any rtol.  Any-hit t is held
    to rtol where the computation is well conditioned
    (`well_conditioned`), which excludes that region."""
    k = bi.sweep_pairs(cl, cid, ray_of, *srt)
    torch.cuda.synchronize()
    p = bi.sweep_plain(cl, cid, ray_of, *srt)
    listed = cid != bi.SENT
    same = k[1] == p[1]
    agree = same[listed].double().mean().item() if bool(listed.any()) else 1.0
    check(agree >= MIN_AGREE, f"K4 ids agree on {agree:.6f} of the pairs")
    check(not bool((k[1][~listed] >= 0).any()), "K4: a sentinel pair hit")
    both = same & (p[1] >= 0)
    t_ok, t_cond, share_cond, err = 1.0, 1.0, 1.0, 0.0
    if bool(both.any()):
        kt, pt = k[0][both], p[0][both]
        within = (kt - pt).abs() <= T_ATOL + T_RTOL * pt.abs()
        t_ok = within.double().mean().item()
        err = float((kt - pt).abs().max())
        rays = ray_of[both].long()
        cond = well_conditioned(tri_pack, srt[0][rays], srt[1][rays],
                                p[1][both])
        share_cond = cond.double().mean().item()
        if bool(cond.any()):
            t_cond = within[cond].double().mean().item()
        check(t_ok >= MIN_AGREE or any_hit,
              f"K4 t within rtol on {t_ok:.6f} of hits")
        check(t_cond >= MIN_AGREE, f"K4 t within rtol on {t_cond:.6f} of "
              f"the well-conditioned hits ({share_cond:.6f} of hits)")
    return agree, t_ok, t_cond, share_cond, err


def compare_front(args, any_hit, K=bi.DEFAULT_K):
    """The binned front end against K2's on one unsorted query (cl,
    tri_pack, ro, rd, t_min, t_max, exclude).  -> (K2's outputs, share
    of rays whose id (closest) or validity (any) agrees)."""
    b = bi.intersect_clusters_binned(*args, any_hit=any_hit, K=K)
    k = ci.intersect_clusters(*args, any_hit=any_hit)
    same = ((b[1] >= 0) == (k[1] >= 0)) if any_hit else (b[1] == k[1])
    agree = same.double().mean().item()
    mode = "any" if any_hit else "closest"
    check(agree >= BINNED_AGREE, f"binned {mode} ids agree with K2 on "
          f"{agree:.7f} of rays, below {BINNED_AGREE}")
    if not any_hit:
        both = same & (k[1] >= 0)
        check(bool(torch.equal(b[0][both], k[0][both])),
              "binned reported t differs from K2's where ids agree")
    return k, agree


def phase_binned_soup(dev, trees):
    t_phase = time.perf_counter()
    n_tris, n_rays = K2_SOUP
    tri_pack = torch.from_numpy(random_soup(n_tris, seed=2)[2]).to(dev)
    ro, rd, t_max = random_rays(n_rays, seed=2, dev=dev)
    t_max = torch.where(torch.arange(n_rays, device=dev) % 3 == 0, -1.0,
                        t_max)
    t_min = torch.full_like(t_max, 0.5)
    none = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    for layout, cl in trees.items():
        _, *srt = ci.sort_rays(cl, ro, rd, t_min, t_max, none)
        sub = [x[::PLAIN_STRIDE].contiguous() for x in srt]
        args = [cl, tri_pack, ro, rd, t_min, t_max, none]
        for K in BINNED_KS:
            k3, a3, _ = compare_k3(cl, sub, K)
            over = (k3[1] > K).double().mean().item()
            a4, t4, c4, s4, e4 = compare_k4(cl, tri_pack, sub,
                                            *pairs_of(k3[0], K), False)
            k2, af = compare_front(args, False, K)
            _, ax = compare_front(args[:6] + [k2[1].contiguous()], False, K)
            _, aa = compare_front(args, True, K)
            line = (f"[9/12 K3+K4 {n_tris} tris x {n_rays} rays, {layout}, "
                    f"K={K}] K3 lists agree {a3:.6f} (lanes overflowing "
                    f"{over:.4f}); K4 ids agree {a4:.6f}, t within rtol "
                    f"{t4:.6f}, {c4:.6f} of the {s4:.6f} well-conditioned "
                    f"(max|t err| {e4:.3g}); front end vs K2: "
                    f"closest {af:.7f}, excl pass {ax:.7f}, any {aa:.7f}")
            if K == bi.DEFAULT_K:
                cid, ray_of = pairs_of(bi.walk(cl, *srt[:4], K)[0], K)
                scid, sray = pairs_of(k3[0], K)
                ms = {
                    "K3": median_ms(lambda: bi.walk(cl, *srt[:4], K)),
                    "K3 plain": median_ms(
                        lambda: bi.walk_plain(cl, *sub[:4], K),
                        runs=PLAIN_RUNS, warmup=False),
                    "K4": median_ms(
                        lambda: bi.sweep_pairs(cl, cid, ray_of, *srt)),
                    "K4 plain": median_ms(
                        lambda: bi.sweep_plain(cl, scid, sray, *sub),
                        runs=PLAIN_RUNS, warmup=False),
                    "binned front end": median_ms(
                        lambda: bi.intersect_clusters_binned(*args, K=K),
                        runs=5),
                    "K2 front end": median_ms(
                        lambda: ci.intersect_clusters(*args), runs=5)}
                line += ("; median ms " + ", ".join(
                    f"{k} {v:.3f}" for k, v in ms.items())
                    + f" (plain on every {PLAIN_STRIDE}th sorted ray, "
                    f"{int(cid.ne(bi.SENT).sum())} listed pairs in all)")
            print(line)
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")


@contextlib.contextmanager
def binned_mode(mode):
    """RGK_BINNED=mode inside the block, the caller's value after."""
    saved = os.environ.get("RGK_BINNED")
    os.environ["RGK_BINNED"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("RGK_BINNED", None)
        else:
            os.environ["RGK_BINNED"] = saved


def render_binned(path, out_dir, mode):
    """One CLI render with RGK_BINNED=mode (restored after).  -> (image,
    rays, launches, stats of the round)."""
    reset_launches()
    with binned_mode(mode), \
            FirstCalls(isect, "intersect_clusters_binned",
                       timed=True) as front, \
            FirstCalls(isect, "intersect_clusters") as k2_front, \
            FirstCalls(bi, "walk", timed=True) as k3, \
            FirstCalls(bi, "sweep_pairs", timed=True) as k4, \
            FirstCalls(ci, "traverse", timed=True, within=front) as k2:
        t0 = time.perf_counter()
        img, rays = render(path, out_dir)
        t1 = time.perf_counter()
    launches = {"K1": dict(fi.launches), "K2": dict(ci.launches),
                "K3/K4": dict(bi.launches)}
    firsts = [c.first_t for c in (front, k2_front) if c.first_t is not None]
    ms = {"front": front.stream_ms(), "K3": k3.stream_ms(),
          "K4": k4.stream_ms(), "pass 2": k2.stream_ms(inside=True),
          "K2 closest queries": k2.stream_ms(inside=False)}
    ms["glue"] = ms["front"] - ms["K3"] - ms["K4"] - ms["pass 2"]
    return img, rays, launches, {
        "wall": t1 - t0, "round": t1 - min(firsts), "ms": ms,
        "n_binned": len(front.events), "n_k2_front": len(k2.events) - len(
            front.events), "args": front.args}


def phase_binned_colonnade(d, path, k2_img):
    """Phase 7's colonnade under RGK_BINNED=any, then all.  -> the K3/K4
    entries of the kernels line, timed at the `all` run's first
    (closest-hit) binned query."""
    t_phase = time.perf_counter()
    res = COLONNADE_RES
    total = {"walk": 0, "sweep": 0}
    for mode in ("any", "all"):
        img, rays, launches, st = render_binned(
            path, os.path.join(d, f"colonnade_{mode}"), mode)
        check(img.shape == (res[1], res[0], 3), f"image shape {img.shape}")
        check(bool(np.isfinite(img).all()), "non-finite pixels")
        check(float(img.mean()) > 0.0, "the image is black")
        nb = st["n_binned"]
        k34 = launches["K3/K4"]
        check(nb > 0 and k34 == {"walk": nb, "sweep": nb},
              f"RGK_BINNED={mode}: {nb} binned queries, K3/K4 launches "
              f"{k34}")
        check(launches["K1"] == {"closest": 0, "any": 0},
              f"the colonnade launched K1: {launches['K1']}")
        k2 = launches["K2"]
        n_closest = 0 if mode == "all" else st["n_k2_front"]
        check(k2 == {"closest": nb + n_closest, "any": 0} and (
            mode == "all" or n_closest > 0),
              f"RGK_BINNED={mode}: K2 launches {k2} for {nb} binned and "
              f"{n_closest} closest-hit queries")
        for key in total:
            total[key] += k34[key]
        stats = image_parity(img, k2_img)
        check(stats["ok"], f"RGK_BINNED={mode} image against the K2 image: "
              f"{stats}")
        ms = st["ms"]
        print(f"[10/12 colonnade RGK_BINNED={mode} {res[0]}x{res[1]} "
              f"{COLONNADE_MS}spp] CLI wall {st['wall']:.3f} s, round "
              f"(first query to EXR) {st['round']:.3f} s, {rays} extension "
              f"rays, {rays / st['round']:.1f} rays/s; launches K3 "
              f"{k34['walk']}, K4 {k34['sweep']}, K2 {k2}; stream ms "
              "(events around each call, host gaps included): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"; image vs K2's: max|diff| {stats['max_abs_diff']:.3g}, "
              f"corr {stats['corr']:.6f}, outlier pixels "
              f"{stats['outlier_pixels']}")

        any_hit = mode == "any"
        args = st["args"][any_hit]
        _, af = compare_front(args, any_hit)
        cl = args[0]
        _, *srt = ci.sort_rays(cl, *args[2:7])
        k3, a3, e3 = compare_k3(cl, srt, bi.DEFAULT_K)
        cid, ray_of = pairs_of(k3[0], bi.DEFAULT_K)
        a4, t4, c4, s4, e4 = compare_k4(cl, args[1], srt, cid, ray_of,
                                        any_hit)
        ms = {"K3": median_ms(lambda: bi.walk(cl, *srt[:4])),
              "K3 plain": median_ms(lambda: bi.walk_plain(cl, *srt[:4]),
                                    runs=PLAIN_RUNS, warmup=False),
              "K4": median_ms(lambda: bi.sweep_pairs(cl, cid, ray_of, *srt)),
              "K4 plain": median_ms(
                  lambda: bi.sweep_plain(cl, cid, ray_of, *srt),
                  runs=PLAIN_RUNS, warmup=False)}
        live = int((srt[3] > srt[2]).sum())
        print(f"    first {'any' if any_hit else 'closest'}-hit binned query "
              f"({srt[0].shape[0]} rays, {live} live, "
              f"{int(cid.ne(bi.SENT).sum())} listed pairs, lanes "
              f"overflowing {(k3[1] > bi.DEFAULT_K).double().mean():.4f}): "
              f"front end vs K2 {af:.7f}; K3 lists agree {a3:.6f}; K4 ids "
              f"agree {a4:.6f}, t within rtol {t4:.6f}, {c4:.6f} of the "
              f"{s4:.6f} well-conditioned (max|t err| {e4:.3g}); median ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f" (plain over {PLAIN_RUNS} runs)")
        if mode == "all":
            entries = [
                {"name": "binned_walk", "route": "cuda", "source": K3_SOURCE,
                 "replaces": K3_REPLACES, "launches": total["walk"],
                 "max_abs_err": e3, "ms": ms["K3"],
                 "plain_ms": ms["K3 plain"]},
                {"name": "binned_sweep", "route": "cuda",
                 "source": K4_SOURCE, "replaces": K4_REPLACES,
                 "launches": total["sweep"], "max_abs_err": e4,
                 "ms": ms["K4"], "plain_ms": ms["K4 plain"]}]
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return entries


def phase_binned_small(d, path, cpu):
    t_phase = time.perf_counter()
    reset_launches()
    with binned_mode("all"):
        gpu, _ = render(path, os.path.join(d, "col_gpu_binned"))
    check(bi.launches["walk"] > 0 and bi.launches["sweep"] > 0
          and ci.launches["any"] == 0 and fi.launches["closest"] == 0,
          f"the small colonnade did not go through K3/K4: {bi.launches}, "
          f"K2 {ci.launches}")
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"binned colonnade card vs CPU parity failed: {stats}")
    print(f"[11/12 colonnade RGK_BINNED=all card vs CPU 33960 tris 64x36 "
          f"4spp depth 2] launches K3/K4 {dict(bi.launches)}, K2 "
          f"{dict(ci.launches)}; corr {stats['corr']:.6f} trimmed "
          f"{stats['corr_trim']:.6f} mean rel diff "
          f"{stats['mean_rel_diff']:.3g} max|diff| "
          f"{stats['max_abs_diff']:.3g} outlier pixels "
          f"{stats['outlier_pixels']}, max per tile "
          f"{stats['max_outliers_per_tile']} (cap {stats['tile_cap']}) "
          f"({time.perf_counter() - t_phase:.1f} s)")


def phase_probes(dev):
    """P1 and P2 through their tools' entry points (launches counted
    there), then one kernel of each timed against its plain version."""
    t_phase = time.perf_counter()
    reset_launches()
    print("[12/12 probes] P1 (rgk_tpu_torch/tools/prof_smem_probe.py):")
    check(p1.main([]) == 0, "P1 failed")
    print("    P2 (rgk_tpu_torch/tools/prof_sync.py):")
    check(p2.main([]) == 0, "P2 failed")
    counts = {**p1.launches, **p2.launches}
    check(all(v > 0 for v in counts.values()), f"probe launches {counts}")

    x = torch.arange(p1.THREADS, dtype=torch.float32, device=dev) + 0.5
    w, xu = p1.unpack_inputs(dev)
    table = p1.row_table(p1.ROW_SIZES[-1], dev)
    px, ptab, tile, tiles = p2.inputs(dev)
    n = p2.DEFAULT_ITERS
    thr = p2.thresh("f", n)
    cases = (
        ("probe_smem", P1_REPLACES, "smem",
         lambda: p1.smem(x, 48 * 1024), lambda: p1.smem_plain(x, 0)),
        ("probe_unpack", P1_REPLACES, "unpack",
         lambda: p1.unpack(w, xu), lambda: p1.unpack_plain(w, xu)),
        ("probe_row_copy", P1_REPLACES, "row_copy",
         lambda: p1.row_copy(table), lambda: p1.row_copy_plain(table, p1.ROW)),
        ("probe_sync_f", P2_REPLACES, "sync",
         lambda: p2.sync("f", px, ptab, n, thr)[0],
         lambda: p2.sync_plain("f", px, ptab, n, thr)[0]),
        ("probe_fetch_depth4", P2_REPLACES, "fetch",
         lambda: p2.fetch(tiles, 4, n, 0.0),
         lambda: p2.fetch_plain(tiles, 4, n, 0.0)))
    entries = []
    for name, replaces, key, kernel, plain in cases:
        k = kernel()
        torch.cuda.synchronize()
        err = float((k.double() - plain().double()).abs().max())
        check(err == 0.0, f"{name} differs from its plain version by {err}")
        kms, pms = median_ms(kernel), median_ms(plain)
        print(f"    {name}: kernel {kms:.3f} ms, plain {pms:.3f} ms, "
              f"equal")
        entries.append({"name": name, "route": "cuda", "source": PROBE_SOURCE,
                        "replaces": replaces, "launches": counts[key],
                        "max_abs_err": err, "ms": kms, "plain_ms": pms})
    print(f"    launches in the tools' runs {counts} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return entries


def main():
    t_all = time.perf_counter()
    phase_device()
    phase_build()
    dev = torch.device("cuda")
    phase_k1(dev)
    trees = phase_k2(dev)
    with tempfile.TemporaryDirectory() as d:
        entries = phase_render(d)
        phase_cpu_parity(d)
        k2_entries, col_path, col_img = phase_colonnade(d)
        entries += k2_entries
        small = phase_colonnade_parity(d)
        phase_binned_soup(dev, trees)
        entries += phase_binned_colonnade(d, col_path, col_img)
        phase_binned_small(d, *small)
    entries += phase_probes(dev)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
