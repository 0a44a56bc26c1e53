"""rgk_tpu_torch stands alone: it imports nothing of rgk_tpu (nor JAX),
renders with those imports refused, writes nothing into the reference's
tree, and its own copies of the reference's host modules (EXR, OBJ,
textures, config parsing and lint, the native SAH builder, the LTC
tables) give the reference's results bit for bit.

Tolerance: none; every comparison here is exact.
"""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch_port_scenes as scenes
from rgk_tpu.io import exr as jexr
from rgk_tpu.io import obj as jobj
from rgk_tpu.io import texture_io as jtex
from rgk_tpu.scene import builder as jbuilder
from rgk_tpu.scene import config as jconfig
from rgk_tpu.scene import json_utils as jjson
from rgk_tpu_torch.io import exr as texr
from rgk_tpu_torch.io import obj as tobj
from rgk_tpu_torch.io import texture_io as ttex
from rgk_tpu_torch.scene import builder as tbuilder
from rgk_tpu_torch.scene import config as tconfig
from rgk_tpu_torch.scene import json_utils as tjson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("rgk_tpu", "jax", "jaxlib")


def _port_sources():
    """Every .py of the port (its build output aside) and chip_smoke.py,
    relative to the repo."""
    found = []
    for dirpath, dirnames, files in os.walk(os.path.join(REPO,
                                                         "rgk_tpu_torch")):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("build", "__pycache__"))
        found += [os.path.join(dirpath, f) for f in sorted(files)
                  if f.endswith(".py")]
    return [os.path.relpath(p, REPO) for p in found] + ["chip_smoke.py"]


def _imported(path):
    """Absolute module names a source imports: import statements, and
    __import__ / importlib.import_module calls on a literal name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            yield node.args[0].value


@pytest.mark.parametrize("rel", _port_sources())
def test_source_imports_no_reference(rel):
    bad = sorted(n for n in _imported(os.path.join(REPO, rel))
                 if n.split(".")[0] in REFUSED)
    assert bad == [], f"{rel} imports {bad}"


# A process that refuses rgk_tpu, jax and jaxlib at import, imports every
# module of the port and renders a flat and a BVH scene (the latter under
# RGK_BINNED=all) on the CPU.
_REFUSING_RUN = """
import importlib, os, pkgutil, sys
REFUSED = {refused!r}
for name in [m for m in sys.modules if m.split(".")[0] in REFUSED]:
    del sys.modules[name]


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)
        return None


sys.meta_path.insert(0, Refuse())
import rgk_tpu_torch
assert os.path.dirname(rgk_tpu_torch.__path__[0]) == os.getcwd()
names = [m.name for m in pkgutil.walk_packages(rgk_tpu_torch.__path__,
                                               "rgk_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from rgk_tpu_torch.driver.cli import main
assert main([{flat!r}, "--cpu", "-q", "-D", {flat_out!r}]) == 0
os.environ["RGK_BINNED"] = "all"
assert main([{bvh!r}, "--cpu", "-q", "-D", {bvh_out!r}]) == 0
left = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(len(names), repr(left))
"""


def _tree_state(root):
    """{relative path: (size, mtime_ns)} of every file and directory
    under `root`."""
    state = {}
    for dirpath, dirnames, files in os.walk(root):
        for name in dirnames + files:
            p = os.path.join(dirpath, name)
            st = os.stat(p)
            state[os.path.relpath(p, root)] = (st.st_size, st.st_mtime_ns)
    return state


@pytest.fixture(scope="module")
def refusing_render(tmp_path_factory):
    """Runs _REFUSING_RUN in a copy of the port and the reference (so no
    other test's process writes into the copied reference meanwhile).
    The copy holds no built library, as a checkout would not.  -> (the
    process, the reference's tree before, after, the copy, tmp)."""
    tmp = tmp_path_factory.mktemp("standalone")
    copy = tmp / "repo"
    skip = shutil.ignore_patterns("__pycache__", "build", "*.so")
    for pkg in ("rgk_tpu_torch", "rgk_tpu"):
        shutil.copytree(os.path.join(REPO, pkg), copy / pkg, ignore=skip)
    flat = scenes.write_config(tmp, scenes.box_config(res=8, ms=1),
                               "box.json")
    cfg = scenes.add_sphere(tmp, scenes.box_config(res=4, ms=1),
                            n_tris=5000)
    bvh = scenes.write_config(tmp, cfg, "box_bvh.json")
    code = _REFUSING_RUN.format(refused=REFUSED, flat=flat,
                                flat_out=str(tmp / "flat"), bvh=bvh,
                                bvh_out=str(tmp / "bvh"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    before = _tree_state(copy / "rgk_tpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(copy),
                          env=env, capture_output=True, text=True,
                          timeout=240)
    return proc, before, _tree_state(copy / "rgk_tpu"), copy, tmp


def test_port_renders_with_the_reference_refused(refusing_render):
    """Every module of the port imports, and both scenes render, while
    rgk_tpu, jax and jaxlib cannot be imported."""
    proc, _, _, copy, tmp = refusing_render
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules, left = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n_modules) >= 40 and left == "[]"
    assert os.path.exists(tmp / "flat" / "bdpt_box.exr")
    assert os.path.exists(tmp / "bvh" / "bdpt_box.exr")
    # The 5026-triangle scene took the port's native builders, built into
    # the port's own build directory.
    built = sorted(os.listdir(copy / "rgk_tpu_torch" / "build"))
    assert [n.split("_")[0] for n in built if n.endswith(".so")] == [
        "libbvh", "libobj"], built


def test_port_render_writes_nothing_into_the_reference(refusing_render):
    _, before, after, _, _ = refusing_render
    assert after == before
    assert not [p for p in after if p.endswith(".so")]


# ---- the port's copies against the reference's modules ----------------


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("pixel_type,compression", [
    ("float", "zip"), ("half", "zip"), ("float", "none")])
def test_exr_matches_reference(tmp_path, writer, pixel_type, compression):
    """An EXR written by one package reads back bit-equal through the
    other, and both write the same bytes."""
    rng = np.random.default_rng(11)
    img = (rng.random((19, 23, 3)) * 4.0).astype(np.float32)
    img[0, 0] = [0.0, np.float32(6.1e-5), 65504.0]
    w, r = (texr, jexr) if writer == "port" else (jexr, texr)
    path = str(tmp_path / "a.exr")
    w.write_exr(path, img, pixel_type=pixel_type, compression=compression)
    other = str(tmp_path / "b.exr")
    r.write_exr(other, img, pixel_type=pixel_type, compression=compression)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    got, want = r.read_exr(path), w.read_exr(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("use_native", [False, True])
def test_obj_matches_reference(tmp_path, smooth, use_native):
    """load_obj of a make_sphere OBJ (v//vn) and of one with texture
    coordinates (v/vt/vn) equals the reference's, array for array."""
    big = scenes.tool("make_bigscene")
    v, n, f = big.make_sphere(800, 0.0, 0.9, 0.6, 0.6)
    big._write_obj(str(tmp_path / "sphere.obj"), v, n, f)
    gv, gn, gf, guv = big.make_ground(12)
    big._write_obj(str(tmp_path / "ground.obj"), gv, gn, gf, uvs=guv)
    for name in ("sphere.obj", "ground.obj"):
        path = str(tmp_path / name)
        got, got_mtl = tobj.load_obj(path, smooth, use_native)
        want, want_mtl = jobj.load_obj(path, smooth, use_native)
        assert got_mtl == want_mtl == {}
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert sorted(vars(a)) == sorted(vars(b))
            for key, x in vars(a).items():
                y = getattr(b, key)
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
                else:
                    assert x == y, key


@pytest.mark.parametrize("kind", ["exr", "png"])
def test_texture_matches_reference(tmp_path, kind):
    """load_texture of the colonnade's stone texture, as the EXR the
    smoke writes and as a PNG, equals the reference's."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    img = smoke.stone_texture(64)
    path = str(tmp_path / f"stone.{kind}")
    if kind == "exr":
        texr.write_exr(path, img)
    else:
        jtex.write_png(path, img)
    got, want = ttex.load_texture(path), jtex.load_texture(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


_LENIENT = """// a comment
{"a": [1, 2, 3,], /* another */ "b": {"c": 007.50, "d": "x // y",},
 "e": -0003,}"""


def _config_case(tmp_path, case):
    cfg = scenes.box_config(res=4, ms=1)
    if case == "typo":
        cfg["multisampel"] = 3
        cfg["materials"][0]["difuse"] = [1, 0, 0]
        cfg["camera"]["fvo"] = 40
    elif case == "no_camera":
        del cfg["camera"]
    elif case == "unknown_brdf":
        cfg["materials"][0]["brdf"] = "velvet"
    elif case == "bad_thinglass":
        cfg["thinglass"] = "pane"
    elif case == "missing_name":
        del cfg["materials"][1]["name"]
    elif case == "bad_output_scale":
        cfg["output-scale"] = "big"
    path = str(tmp_path / "scene.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _lint(config_mod, builder_mod, path):
    """-> ("ok", unused keys) or ("error", the ConfigError's message)."""
    try:
        cfg = config_mod.Config(path)
        cfg.install(builder_mod.SceneBuilder())
        cfg.get_camera()
        return "ok", cfg.root.find_unused()
    except (jjson.ConfigError, tjson.ConfigError) as e:
        return "error", (type(e).__module__.split(".")[0], str(e))


@pytest.mark.parametrize("case", ["lenient", "typo", "no_camera",
                                  "unknown_brdf", "bad_thinglass",
                                  "missing_name", "bad_output_scale"])
def test_config_parsing_matches_reference(tmp_path, case):
    """loads_tolerant, the unused-key lint and the ConfigError messages
    equal the reference's; the port raises its own ConfigError."""
    if case == "lenient":
        assert tjson.loads_tolerant(_LENIENT) == jjson.loads_tolerant(
            _LENIENT)
        assert tjson.loads_tolerant(_LENIENT)["b"]["c"] == 7.5
        return
    path = _config_case(tmp_path, case)
    got = _lint(tconfig, tbuilder, path)
    want = _lint(jconfig, jbuilder, path)
    if case == "typo":
        assert got == want and got[0] == "ok"
        assert "multisampel" in got[1], got
    else:
        assert got[0] == want[0] == "error"
        assert got[1] == ("rgk_tpu_torch", want[1][1])


def test_native_sah_matches_reference():
    """The port's native SAH builder gives the reference's arrays bit for
    bit on a 5,000-triangle sphere."""
    from rgk_tpu.native import bvh_native as jnative
    from rgk_tpu_torch.native import bvh_native as tnative
    from rgk_tpu_torch.scene.bvh import prim_bounds

    assert tnative._load() is not None, "the port's native builder failed"
    if jnative._load() is None:
        pytest.skip("the reference's native builder does not build here")
    big = scenes.tool("make_bigscene")
    v, _, f = big.make_sphere(5000, 0.0, 0.9, 0.6, 0.6)
    bounds = prim_bounds(np.asarray(v, np.float32), np.asarray(f))
    got = tnative.build_binned_sah(*bounds, 4)
    want = jnative.build_binned_sah(*bounds, 4)
    assert len(got[0]) > 1000
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_ltc_tables_match_reference():
    from rgk_tpu.ops.ltc import _load_tables_np
    from rgk_tpu_torch.ops.ltc import load_tables_np

    with open(os.path.join(REPO, "rgk_tpu", "data", "ltc_tables.npz"),
              "rb") as f, open(os.path.join(
                  REPO, "rgk_tpu_torch", "data", "ltc_tables.npz"),
                  "rb") as g:
        assert f.read() == g.read()
    got, want = load_tables_np(), _load_tables_np()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
