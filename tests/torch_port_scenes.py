"""In-repo scenes for the port parity tests (tests/test_torch_*.py).

Each builds a JSON config under a test's tmp_path: the BDPT box of
tools/bdpt_scene.py at reverse 0, the box plus a sphere OBJ from
tools/make_bigscene.py, the procedural colonnade of that tool, and a
"zoo" with every BxDF type, textures, a bump map, an envmap sky, sized
point lights, thin glass and a thin lens.  `jax_build` and `port_build`
commit one config through rgk_tpu and rgk_tpu_torch.  `soup` and
`rays` make the random triangle soups and rays of
tests/test_intersect.py; `assert_same` compares two committed trees
bit for bit.  `far_sphere_tree` and `assert_binned_contract` hold the
binned front end to K2's on far scenes, on the CPU and on the card.
`GRAD_SCENE` is tests/test_grad.py's scene; `write_rtc_scene` writes a
line-based `.rtc` scene.

JAX and rgk_tpu are imported only by `jax_build`, so the card tests and
chip_smoke.py, which run where JAX is not installed, can use the rest.
"""

import importlib.util
import json
import os

import numpy as np
import torch

from rgk_tpu_torch.ops import flat_intersect as fi
from rgk_tpu_torch.scene import clusters as tclusters
from rgk_tpu_torch.scene import config as tconfig
from rgk_tpu_torch.scene.builder import build_tri_pack

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_config(tmp_path, cfg, name="scene.json"):
    path = os.path.join(str(tmp_path), name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def box_config(res=16, ms=4, **overrides):
    cfg = tool("bdpt_scene").scene_dict(res=res, ms=ms, reverse=0)
    cfg.update(overrides)
    return cfg


def add_sphere(tmp_path, cfg, n_tris=600, material="white"):
    """Append a make_sphere OBJ (written by _write_obj) to `cfg`."""
    big = tool("make_bigscene")
    verts, nrms, faces = big.make_sphere(n_tris, 0.0, 0.9, 0.6, 0.6)
    big._write_obj(os.path.join(str(tmp_path), "sphere.obj"), verts, nrms,
                   faces)
    cfg["scene"].append({"file": "sphere.obj", "material": material})
    return cfg


def colonnade(tmp_path, n_tris=20000, **overrides):
    """tools/make_bigscene.generate's colonnade (20000 -> 33,960
    triangles) with config overrides; returns the config path."""
    path = tool("make_bigscene").generate(str(tmp_path), n_tris)
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(overrides)
    return write_config(tmp_path, cfg, "colonnade_small.json")


# tests/test_grad.py's scene: a floor, a glossy cube and an emissive
# triangle under a point light and the sky, 8x8, depth 2, no roulette.
GRAD_SCENE = {
    "output-file": "t.exr", "output-width": 8, "output-height": 8,
    "multisample": 4, "recursion-max": 2, "russian": -1.0,
    "camera": {"position": [0, 1.5, 1.5], "lookat": [0, 0, 0], "fov": 50},
    "sky": {"color": [0.3, 0.3, 0.4], "intensity": 1.0},
    "materials": [
        {"name": "floor", "brdf": "diffuse", "diffuse": [0.6, 0.4, 0.3]},
        {"name": "glow", "brdf": "diffuse", "diffuse": [0.2, 0.2, 0.2],
         "emission": [1.0, 0.8, 0.6]},
        {"name": "shiny", "brdf": "ltc_ggx_diffuse", "roughness": 0.35,
         "specular": [0.4, 0.4, 0.4], "diffuse": [0.2, 0.3, 0.2]},
    ],
    "scene": [
        {"primitive": "plane", "axis": "Y", "scale": [4, 1, 4],
         "material": "floor"},
        {"primitive": "cube", "translate": [-0.4, 0.25, 0],
         "scale": [0.5, 0.5, 0.5], "material": "shiny"},
        {"primitive": "tri", "translate": [0.5, 0.8, 0],
         "rotate": [0, 0, 180], "scale": [0.3, 1, 0.3], "material": "glow"},
    ],
    "lights": [{"position": [1, 2, 1], "color": [1, 0.9, 0.8],
                "intensity": 2.0}],
}


def write_rtc_scene(tmp_path, res=(32, 24), ms=2, depth=3, sphere=600):
    """A line-based .rtc scene under `tmp_path`, `res` = (width, height):
    tests/test_rtc_config.py's floor quad and a make_sphere ball of
    `sphere` triangles in one OBJ, a point light and the sky.  -> the
    .rtc path."""
    d = str(tmp_path)
    verts, nrms, faces = tool("make_bigscene").make_sphere(sphere, 0.0, 0.6,
                                                           0.0, 0.6)
    lines = ["mtllib box.mtl", "v -1 0 -1", "v 1 0 -1", "v 1 0 1",
             "v -1 0 1", "vn 0 1 0", "usemtl white", "f 1//1 2//1 3//1",
             "f 1//1 3//1 4//1"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vn {x:.5f} {y:.5f} {z:.5f}" for x, y, z in nrms]
    lines.append("usemtl ball")
    lines += ["f " + " ".join(f"{i + 5}//{i + 2}" for i in f) for f in faces]
    with open(os.path.join(d, "box.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "box.mtl"), "w") as f:
        f.write("newmtl white\nKd 0.7 0.7 0.7\nNs 10\nnewmtl ball\n"
                "Kd 0.6 0.3 0.2\nKs 0.3 0.3 0.3\nNs 100\n")
    rtc = ["rtc smoke scene", "box.obj", "rtc.exr", str(depth),
           f"{res[0]} {res[1]}", "0 2 -5", "0 0.4 0", "0 1 0", "1.2",
           "L 1 3 -1 255 240 220 60 0.2", f"ms {ms}", "sky 60 80 120 1.5",
           "clamp 50", "rounds 1"]
    path = os.path.join(d, "scene.rtc")
    with open(path, "w") as f:
        f.write("\n".join(rtc) + "\n")
    return path


def soup(n_tris, seed, spread=10.0):
    """-> (vertices f32 [3n, 3], tri_vidx i32 [n, 3]) of a random soup."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_tris, 3))
    offsets = rng.normal(0, 0.6, (n_tris, 3, 3))
    verts = (centers[:, None, :] + offsets).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)


def rays(n, seed, spread=12.0):
    """-> (ro, rd) f32 [n, 3], origins in a cube, unit directions."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def assert_same(a, b, name=""):
    """Trees of tensors equal in dtype, shape and bits (float tensors
    are compared as int32 bit patterns: the cluster pack carries ids,
    -1 among them, as NaN-patterned floats); other leaves by ==."""
    if isinstance(a, tuple):
        for f in a._fields:
            assert_same(getattr(a, f), getattr(b, f), f"{name}.{f}")
        return
    if not isinstance(a, torch.Tensor):
        assert a == b, (name, a, b)
        return
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), name


def _png(path, w, h, seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)


def zoo_config(tmp_path, res=8, ms=2):
    d = str(tmp_path)
    _png(os.path.join(d, "tex.png"), 7, 5, 1)
    _png(os.path.join(d, "bump.png"), 6, 9, 2)
    _png(os.path.join(d, "env.png"), 16, 8, 3)
    mats = [
        {"name": "white", "brdf": "diffuse", "diffuse": [0.7, 0.7, 0.7]},
        {"name": "tex", "brdf": "diffuse", "diffuse-texture": "tex.png",
         "bump-map": "bump.png"},
        {"name": "mirror", "brdf": "mirror", "color": [0.9, 0.8, 0.7]},
        {"name": "clear", "brdf": "transparent"},
        {"name": "glass", "brdf": "dielectric", "ior": 1.5,
         "color": [0.9, 1.0, 0.9]},
        {"name": "rough_b", "brdf": "ltc_beckmann", "roughness": 0.3,
         "color": [0.8, 0.6, 0.4]},
        {"name": "rough_g", "brdf": "ltc_ggx", "exponent": 50,
         "specular": [0.5, 0.5, 0.6]},
        {"name": "plastic_b", "brdf": "ltc_beckmann_diffuse",
         "roughness": 0.5, "color": [0.3, 0.3, 0.3],
         "diffuse": [0.2, 0.4, 0.6]},
        {"name": "plastic_g", "brdf": "ltc_ggx_diffuse", "roughness": 0.2,
         "color": [0.4, 0.4, 0.4], "diffuse-texture": "tex.png",
         "no-russian": True},
        {"name": "mixed", "brdf": "mix", "material1": "white",
         "material2": "mirror", "amount": 0.3},
        {"name": "glow", "brdf": "diffuse", "diffuse": [0, 0, 0],
         "emission": [6, 5, 4]},
        {"name": "pane", "brdf": "diffuse", "diffuse": [0.2, 0.8, 0.2]},
    ]
    scene = [{"primitive": "plane", "axis": "Y", "scale": [4, 1, 4],
              "material": "tex", "texture-scale": [2, 2, 1]}]
    for i, m in enumerate(["mirror", "clear", "glass", "rough_b", "rough_g",
                           "plastic_b", "plastic_g", "mixed"]):
        x = -2.1 + 0.6 * i
        scene.append({"primitive": "cube", "scale": [0.4, 0.5, 0.4],
                      "rotate": [0, 20 * i, 0], "translate": [x, 0.25, -0.5],
                      "material": m})
    scene += [
        {"primitive": "plane", "axis": "Y", "scale": [0.6, 1, 0.6],
         "rotate": [0, 0, 180], "translate": [0, 2.5, 0], "material": "glow"},
        {"primitive": "plane", "axis": "Z", "scale": [1.0, 1.0, 1],
         "translate": [0.5, 0.6, 0.8], "material": "pane"},
    ]
    return {
        "output-file": "zoo.exr", "output-width": res, "output-height": res,
        "multisample": ms, "recursion-max": 4, "russian": 0.6,
        "clamp": 50.0, "rounds": 1, "thinglass": ["pane"],
        "camera": {"position": [0.3, 1.4, 3.5], "lookat": [0, 0.4, 0],
                   "fov": 50, "lens-size": 0.05, "focus-plane": 3.0},
        "materials": mats, "scene": scene,
        "lights": [{"position": [1, 2, 1], "intensity": 3.0, "size": 0.2},
                   {"position": [-1, 2.2, 0.5], "intensity": 1.5,
                    "color": [1.0, 0.8, 0.6]}],
        "sky": {"envmap": "env.png", "intensity": 1.5, "rotate": 30},
    }


def jax_build(path):
    """-> (numpy SceneArrays tree, jax SceneArrays, SceneMeta, Config)."""
    import jax

    from rgk_tpu.scene import config as jconfig

    cfg = jconfig.load_config(path)
    arrays, meta, _ = jconfig.build_scene(cfg)
    return jax.tree_util.tree_map(np.asarray, arrays), arrays, meta, cfg


def port_build(path, device="cpu"):
    """-> (SceneArrays, SceneMeta, Config) of the port."""
    cfg = tconfig.load_config(path)
    arrays, meta, _ = tconfig.build_scene(cfg, device)
    return arrays, meta, cfg


# The far scenes of the binned front end (ROADMAP.md section 3, fault 1).
FAR_SPHERES = {
    # center, radius, camera distance, seed
    "far": ((300.0, -200.0, 500.0), 1.0, 200.0, 12),
    "tiny": ((0.0, 0.0, 0.0), 0.05, 150.0, 13),
}
# Where the binned and K2 ids differ, the two hits' t agree within this
# rtol (two triangles that share the edge the ray passes), and each id's
# row, taken in float64, puts the hit within T_RTOL of its route's t.
SAME_POINT_RTOL = 1e-5
T_RTOL = 3e-4
MAX_DIFFER = 1e-3   # share of the rays whose ids may differ


def far_sphere_tree(dev, scene, n_rays=1 << 16):
    """A closed sphere of ~16,000 small triangles (`FAR_SPHERES[scene]`)
    as a cluster tree, and rays aimed from far away at points near
    triangle edges and corners: many hits lie within rounding of an
    edge shared by two triangles.  -> (ClusterArrays, tri_pack [M, 13],
    [ro, rd, t_min, t_max, exclude])."""
    center, radius, cam_dist, seed = FAR_SPHERES[scene]
    verts, _, faces = tool("make_bigscene").make_sphere(16_400, *center,
                                                        radius)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    pack = np.zeros((faces.shape[0], 13), np.float32)
    pack[:, :12] = build_tri_pack(verts, faces)
    cl = tclusters.build_clusters(verts, faces, pack, device=dev)
    rng = np.random.default_rng(seed)
    corners = verts[faces[rng.integers(0, faces.shape[0], n_rays)]]
    target = (corners * rng.dirichlet([0.3] * 3, n_rays)[:, :, None]).sum(1)
    away = rng.normal(size=(n_rays, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    ro = (np.asarray(center) + cam_dist * away).astype(np.float32)
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return cl, torch.from_numpy(pack).to(dev), [
        torch.from_numpy(x).to(dev) for x in (
            ro, rd, np.zeros(n_rays, np.float32),
            np.full(n_rays, 1e4, np.float32), np.full(n_rays, -1, np.int32))]


def row_t64(pack, ro, rd, tri):
    """t of each ray against its triangle's Badouel row, in float64."""
    w = pack[tri.long()].double().cpu()
    o, d = ro.double().cpu(), rd.double().cpu()
    return -((w[:, 0:3] * o).sum(1) + w[:, 3]) / (w[:, 0:3] * d).sum(1)


def assert_binned_contract(pack, rays, binned, k2, never_later=True):
    """The binned front end against K2's on one query (closest hit):
    ids differ on at most MAX_DIFFER of the rays; where they differ, both
    hit, at the same point (t within SAME_POINT_RTOL of each other), both
    t lie within T_RTOL of the exhaustive oracle's closest t (flat_plain
    over the whole tri_pack), and each id's row in float64 puts the hit
    within T_RTOL of its route's t.  With `never_later`, the binned hit
    is never later in (t, id) than K2's (so on the plain route; on the
    card, where both kernels contract multiply-adds to FMA, either may be
    the later one).  -> (rays that differ, rays where the binned hit is
    the earlier one, rays where it is the later one)."""
    (bt, bid), (kt, kid) = binned[:2], k2[:2]
    differ = torch.nonzero(bid != kid).flatten()
    n = int(differ.numel())
    assert n <= MAX_DIFFER * bid.numel(), f"ids differ on {n} rays"
    earlier = (bt < kt) | ((bt == kt) & (bid < kid))
    later = (bt > kt) | ((bt == kt) & (bid > kid))
    if n:
        ro, rd = rays[0][differ], rays[1][differ]
        b_t, k_t = bt[differ].double(), kt[differ].double()
        assert bool((bid[differ] >= 0).all() and (kid[differ] >= 0).all())
        assert bool(((b_t - k_t).abs() <= SAME_POINT_RTOL * k_t.abs()).all())
        oracle = fi.flat_plain(pack, ro.contiguous(), rd.contiguous(),
                               *(x[differ].contiguous() for x in rays[2:]))
        o_t = oracle[0].double()
        assert bool((oracle[1] >= 0).all())
        for t in (b_t, k_t):
            assert bool(((t - o_t).abs() <= T_RTOL * o_t.abs()).all())
        for t, tri in ((b_t, bid[differ]), (k_t, kid[differ])):
            t64 = row_t64(pack, ro, rd, tri)
            assert bool(((t64 - t.cpu()).abs() <= T_RTOL * t64.abs()).all())
    if never_later:
        assert int(later.sum()) == 0, f"binned later on {int(later.sum())}"
    return n, int(earlier.sum()), int(later.sum())


# The BxDF kernel's lanes: every material type (scene/arrays.py BSDF_*),
# mixes (one of them over a mix, which the one-level mix evaluates as
# zero), roughness 0 and 1, ior 1 and the edges of the delta lobes.
BXDF_TYPES = tuple(range(9))


def bxdf_lanes(n, seed, types=BXDF_TYPES):
    """-> (pack [NM, 20], mat_id int32 [n], vi [n, 3], vr [n, 3], u2
    [n, 2]), float32 on the CPU, each lane's material drawn from those of
    `types`.  vr is the mirror of vi on a sixth of the lanes, the
    refraction of the lane's dielectric (ior as the plain eval reads it)
    on a sixth, 1e-4 / 1e-3 either side of those tolerances on a twelfth
    each; vi grazes (z 0, +-1e-7, +-1e-4) on a twelfth; u2 holds 0 and
    1 - 1e-7 on some lanes."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(8):
        for k in range(4):
            row = np.zeros(20, np.float32)
            row[3:6] = rng.uniform(0.0, 0.9, 3)
            row[6:9] = rng.uniform(0.0, 0.9, 3)
            row[9] = (0.0, 1.0, 0.05, rng.uniform(0.01, 0.9))[k]
            row[10] = (1.0, 1.5, 2.4, rng.uniform(1.1, 1.9))[k]
            row[11] = rng.uniform()
            row[12] = t
            row[15:18] = -1.0
            rows.append(row)
    n_leaf = len(rows)
    for k in range(7):
        row = np.zeros(20, np.float32)
        row[3:12] = rng.uniform(0.0, 0.9, 9)
        row[11] = (0.0, 1.0, 0.5, rng.uniform(), rng.uniform(),
                   rng.uniform(), 0.3)[k]
        row[12] = 8
        row[13:15] = rng.integers(0, n_leaf, 2)
        if k == 6:
            row[13] = n_leaf  # a mix over a mix
        row[15:18] = -1.0
        rows.append(row)
    pack = np.stack(rows)
    ok = np.flatnonzero(np.isin(pack[:, 12].astype(int), types))
    mat_id = rng.choice(ok, n).astype(np.int32)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    vi = unit(rng.normal(size=(n, 3)))
    vr = unit(rng.normal(size=(n, 3)))
    part = rng.integers(0, 12, n)
    mirror = vi * np.array([-1.0, -1.0, 1.0])
    vr = np.where((part < 2)[:, None], mirror, vr)
    # The refraction of the lane's own ior, as the plain eval builds it.
    ior = pack[mat_id, 10].astype(np.float64)
    viz = vi[:, 2]
    eta = np.where(viz < 0.0, ior, 1.0 / ior)
    e2 = np.where(viz < 0.0, 1.0 / eta, eta)
    st2 = e2 * e2 * (1.0 - viz * viz)
    ct = np.sqrt(np.clip(1.0 - st2, 1e-12, None)) * (st2 <= 1.0)
    refr = np.stack([-vi[:, 0] * eta, -vi[:, 1] * eta,
                     np.where(viz > 0.0, -ct, ct)], -1)
    vr = np.where(((part >= 2) & (part < 4))[:, None], refr, vr)
    # Either side of the mirror (1e-4) and refraction (1e-3) tolerances:
    # 1 - cos(angle) = tol (1 -+ 5%).
    side = np.where(rng.uniform(size=n) < 0.5, 0.95, 1.05)
    for lo, base, tol in ((4, mirror, 1e-4), (5, unit(refr + 1e-12), 1e-3)):
        perp = unit(np.cross(base, rng.normal(size=(n, 3))))
        ang = np.arccos(1.0 - tol * side)[:, None]
        edge = base * np.cos(ang) + perp * np.sin(ang)
        vr = np.where((part == lo)[:, None], edge, vr)
    graze = np.array([0.0, 1e-7, -1e-7, 1e-4, -1e-4])[rng.integers(0, 5, n)]
    flat = unit(vi[:, :2]) * np.sqrt(1.0 - graze * graze)[:, None]
    vi = np.where((part == 6)[:, None],
                  np.concatenate([flat, graze[:, None]], -1), vi)
    u2 = rng.uniform(size=(n, 2))
    u2[part == 7, 0] = 0.0
    u2[part == 8, 0] = 1.0 - 1e-7
    u2[part == 9, 1] = 0.0

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))

    return (f32(pack), torch.from_numpy(mat_id), f32(vi), f32(vr), f32(u2))
