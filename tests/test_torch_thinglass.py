"""Port parity for thin glass: the glass subset of the committed scene,
the ordered hit lists, the tint filter and the `tint-thinglass` renders
of rgk_tpu_torch against rgk_tpu on the CPU.

Tolerances: `glass_pack` / `glass_ids` bit for bit; hit lists with ids
exact and t within rtol 1e-6 (the same float32 sweep, summed by another
library); the filter within rtol 1e-6; per-lane radiance rtol 1e-4 /
atol 1e-5 on >= 99% of lanes, rays within 0.5% (as
tests/test_torch_slice.py); the render checks of tests/test_thinglass.py
with its own bounds.

The reference tints the sky escape through glass in its queued NEE
tracer only, not in the per-sample path or the queued BDPT tracer, and
never tints a BDPT connection; `test_tint_reaches_what_the_reference_tints`
pins each case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.integrator import path as jpath
from rgk_tpu.ops import thinglass as jtg
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.ops import thinglass as tg


def _cfg(thinglass, tint=False):
    """tests/test_thinglass.py's scene: a floor, a pane above it between
    the camera and the floor and between the light and the floor."""
    cfg = {
        "output-file": "t.exr", "output-width": 8, "output-height": 8,
        "multisample": 8, "recursion-max": 1, "russian": -1.0,
        "camera": {"position": [0, 2, 0.001], "lookat": [0, 0, 0],
                   "fov": 40},
        "thinglass": thinglass,
        "materials": [
            {"name": "floor", "brdf": "diffuse", "diffuse": [0.5, 0.5, 0.5]},
            {"name": "pane_glass", "brdf": "diffuse",
             "diffuse": [0.1, 0.1, 0.1]},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [5, 1, 5],
             "material": "floor"},
            {"primitive": "plane", "axis": "Y", "translate": [0, 1, 0],
             "scale": [5, 1, 5], "material": "pane_glass"},
        ],
        "lights": [{"position": [0, 3, 0], "color": [1, 1, 1],
                    "intensity": 2.0}],
    }
    if tint:
        cfg["tint-thinglass"] = True
    return cfg


def _stacked(tmp_path):
    """Three stacked panes at y = 1, 1.5 and 2."""
    cfg = _cfg(["glass"])
    for y in (1.5, 2):
        cfg["scene"].append({"primitive": "plane", "axis": "Y",
                             "translate": [0, y, 0], "scale": [5, 1, 5],
                             "material": "pane_glass"})
    return scenes.write_config(tmp_path, cfg, "panes.json")


def _render(tmp_path, cfg, name):
    path = scenes.write_config(tmp_path, cfg, name)
    arrays, meta, c = scenes.port_build(path)
    rad, counts, _ = tpath.render_image_round(arrays, meta, c.settings,
                                              c.get_camera(), 0)
    return (rad / counts[..., None]).numpy()


@pytest.mark.parametrize("which", ["flat", "bvh"])
def test_glass_arrays_match_reference(tmp_path, which):
    """glass_pack / glass_ids bit for bit: the box with a glass pane
    (and a 5000-triangle sphere, a BVH scene, whose ids still index the
    committed tri_pack), and a scene without glass (one never-hit row)."""
    cfg = scenes.box_config()
    cfg["materials"].append({"name": "pane_glass", "brdf": "diffuse",
                             "diffuse": [0.2, 0.8, 0.2]})
    cfg["scene"].append({"primitive": "plane", "axis": "Z",
                         "scale": [0.5, 1, 0.5], "translate": [0, 1, 1],
                         "material": "pane_glass"})
    cfg["thinglass"] = ["glass"]
    if which == "bvh":
        cfg = scenes.add_sphere(tmp_path, cfg, n_tris=5000)
    plain = scenes.box_config()
    for name, c, n_glass in (("glass.json", cfg, 2), ("plain.json", plain,
                                                      0)):
        path = scenes.write_config(tmp_path, c, name)
        tree, _, jmeta, _ = scenes.jax_build(path)
        arrays, meta, _ = scenes.port_build(path)
        assert meta.has_bvh == jmeta.has_bvh == (which == "bvh"
                                                 and n_glass > 0)
        assert meta.has_thinglass == (n_glass > 0)
        for f in ("glass_pack", "glass_ids"):
            ref = torch.from_numpy(np.array(getattr(tree, f)))
            scenes.assert_same(getattr(arrays, f), ref, f)
        ids = arrays.glass_ids
        if n_glass:
            assert ids.shape == (n_glass,)
            assert bool((arrays.tri_pack[ids.long(), 12] == 1.0).all())
            assert torch.equal(arrays.glass_pack,
                               arrays.tri_pack[ids.long(), :12])
        else:
            assert ids.tolist() == [-1]


def test_collect_and_apply_match_reference(tmp_path):
    """Random rays through three stacked panes: the ordered lists equal
    the reference's (ids exact, t rtol 1e-6), with [R] and scalar
    bounds; the filter passes through without tint and tints each
    entering crossing once with it, as the reference's does."""
    path = _stacked(tmp_path)
    _, jarrays, _, _ = scenes.jax_build(path)
    arrays, meta, _ = scenes.port_build(path)
    assert meta.has_thinglass and arrays.glass_ids.shape == (6,)
    rng = np.random.default_rng(11)
    n = 4096
    ro = np.column_stack([rng.uniform(-3, 3, n), rng.uniform(-0.5, 3, n),
                          rng.uniform(-3, 3, n)]).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[: n // 2, 1] = np.abs(rd[: n // 2, 1]) * 4.0  # mostly upward
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = rng.uniform(0.5, 4.0, n).astype(np.float32)
    for bounds in ((0.0, 100.0), (0.05, t_max)):
        jt, jtri = jtg.collect_thinglass(
            jarrays, jnp.asarray(ro), jnp.asarray(rd),
            *(jnp.asarray(b) if isinstance(b, np.ndarray) else b
              for b in bounds))
        tt, ttri = tg.collect_thinglass(
            arrays, torch.from_numpy(ro), torch.from_numpy(rd),
            *(torch.from_numpy(b) if isinstance(b, np.ndarray) else b
              for b in bounds))
        np.testing.assert_array_equal(ttri.numpy(), np.asarray(jtri))
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
        listed = (ttri >= 0).sum(dim=1)
        assert int((listed == 3).sum()) > 50 and int((listed == 0).sum()) > 50
        rad = rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
        for tint in (False, True):
            out = tg.apply_thinglass(arrays, torch.from_numpy(rad), tt, ttri,
                                     torch.from_numpy(rd), tint=tint)
            ref = jtg.apply_thinglass(jarrays, jnp.asarray(rad), jt, jtri,
                                      jnp.asarray(rd), tint=tint)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       rtol=1e-6)
            if not tint:
                np.testing.assert_array_equal(out.numpy(), rad)


def test_thinglass_passthrough(tmp_path):
    """tests/test_thinglass.py:53 on the port: with the pane as thin
    glass the lit floor shows through it; without, the dark pane."""
    blocked = _render(tmp_path, _cfg([]), "blocked.json")
    passed = _render(tmp_path, _cfg(["glass"]), "passed.json")
    expected_floor = 2.0 * (0.5 / np.pi) / 9.0
    c_passed, c_blocked = passed[4, 4].mean(), blocked[4, 4].mean()
    assert abs(c_passed - expected_floor) / expected_floor < 0.1
    assert c_blocked < c_passed * 0.8


def test_thinglass_meta_flag(tmp_path):
    """tests/test_thinglass.py:66 on the port."""
    path = scenes.write_config(tmp_path, _cfg(["glass"]), "m.json")
    arrays, meta, _ = scenes.port_build(path)
    assert meta.has_thinglass
    assert arrays.tri_pack.shape[1] == 13
    assert float(arrays.tri_pack[:, 12].sum()) == 2.0


def test_thinglass_hit_list_collection(tmp_path):
    """tests/test_thinglass.py:77 on the port: a vertical ray crosses all
    three panes in ascending t, a horizontal one none; the filter passes
    through, or tints once per distinct entering crossing."""
    arrays, meta, _ = scenes.port_build(_stacked(tmp_path))
    assert meta.has_thinglass and int(arrays.glass_ids.shape[0]) == 6
    ro = torch.tensor([[0.3, 0.2, 0.3], [0.3, 0.5, 0.3]])
    rd = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    ts, tris = tg.collect_thinglass(arrays, ro, rd, 0.0, 100.0)
    assert bool((tris[0, :3] >= 0).all()) and int(tris[0, 3]) == -1
    np.testing.assert_allclose(ts[0, :3].numpy(), [0.8, 1.3, 1.8],
                               atol=1e-5)
    assert bool((ts[0, 1:3] > ts[0, :2]).all())
    assert bool((tris[1] == -1).all())
    rad = torch.ones((2, 3))
    assert torch.equal(tg.apply_thinglass(arrays, rad, ts, tris, rd), rad)
    out = tg.apply_thinglass(arrays, rad, ts, tris, rd, tint=True)
    n = arrays.tri_normal[int(tris[0, 0])]
    entering = float(torch.dot(n, rd[0])) >= 0
    np.testing.assert_allclose(out[0].numpy(), 0.1 ** 3 if entering else 1.0,
                               rtol=1e-5)
    assert torch.equal(out[1], rad[1])


def test_thinglass_tint_render(tmp_path):
    """tests/test_thinglass.py:128 on the port: the tint darkens the
    light that crosses the pane (by its diffuse 0.1 when the crossing
    enters it), and the render without it passes through."""
    passed = _render(tmp_path, _cfg(["glass"]), "tint_off.json")
    tinted = _render(tmp_path, _cfg(["glass"], tint=True), "tint_on.json")
    c_pass, c_tint = passed[4, 4].mean(), tinted[4, 4].mean()
    assert c_tint <= c_pass + 1e-6
    assert c_tint == pytest.approx(c_pass * 0.1, rel=0.05) or \
        c_tint == pytest.approx(c_pass, rel=1e-3)


def _sky_scene(tmp_path, reverse, tint=True, res=12):
    """A floor lit by a point light through a pane, and sky seen through
    a tilted pane: every tracer's shadow segments and the queued NEE
    tracer's sky escapes cross glass."""
    cfg = _cfg(["glass"], tint=tint)
    cfg.update({"output-width": res, "output-height": res, "multisample": 4,
                "recursion-max": 3, "reverse": reverse,
                "sky": {"color": [0.4, 0.6, 1.0], "intensity": 1.0},
                "camera": {"position": [0, 1.5, 4.0], "lookat": [0, 0.7, 0],
                           "fov": 60}})
    cfg["materials"].append({"name": "sky_glass", "brdf": "diffuse",
                             "diffuse": [0.3, 0.5, 0.9]})
    cfg["scene"].append({"primitive": "plane", "axis": "Z",
                         "scale": [1.5, 1, 0.6], "rotate": [20, 0, 0],
                         "translate": [0, 1.6, 2.0], "material": "sky_glass"})
    cfg["scene"][0]["scale"] = [3, 1, 3]
    # Turned over, so that a shadow segment enters the pane (its normal
    # faces the light) and is tinted.
    cfg["scene"][1]["rotate"] = [0, 0, 180]
    return scenes.write_config(tmp_path, cfg,
                               f"sky_r{reverse}_{int(tint)}.json")


@pytest.mark.parametrize("reverse", [0, 2])
def test_tinted_queued_trace_matches_reference(tmp_path, reverse):
    """The queued NEE and BDPT tracers with tint-thinglass on, per lane
    against the reference's (16 lanes of 12x12 pixels, 4 spp, depth 3)."""
    path = _sky_scene(tmp_path, reverse)
    _, jarrays, jmeta, jcfg = scenes.jax_build(path)
    tarrays, tmeta, tcfg = scenes.port_build(path)
    assert tmeta.has_thinglass and tcfg.settings.tint_thinglass
    pix = np.arange(12 * 12)
    px, py = (pix % 12).astype(np.int32), (pix // 12).astype(np.int32)
    jargs = (jarrays, jmeta, jcfg.settings, jcfg.get_camera(),
             jnp.asarray(px), jnp.asarray(py), 0, 4, 42)
    targs = (tarrays, tmeta, tcfg.settings, tcfg.get_camera(),
             torch.from_numpy(px), torch.from_numpy(py), 0, 4, 42)
    if reverse:
        jrad, _, jrays = jpath.trace_wavefront_queued_bdpt(*jargs)
        trad, _, trays = tpath.trace_wavefront_queued_bdpt(*targs)
    else:
        jrad, jrays = jpath.trace_wavefront_queued(*jargs)
        trad, trays = tpath.trace_wavefront_queued(*targs)
    close = np.isclose(trad.numpy(), np.asarray(jrad), rtol=1e-4,
                       atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert np.asarray(jrad).mean() > 0.0


def test_tint_reaches_what_the_reference_tints(tmp_path, monkeypatch):
    """Which segments cross-check the glass: every NEE shadow segment;
    the sky escape only in the queued NEE tracer (not in the per-sample
    path nor in the queued BDPT tracer); no BDPT connection.  Counted
    through the one helper every tint goes through, against the eye
    path's extension steps; with the tint off, no segment is checked."""
    calls = []
    orig = tpath._tinted

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    iters = []
    orig_extend = tpath._extend_path

    def count_extend(*a, **kw):
        iters.append(a[-1])
        return orig_extend(*a, **kw)

    monkeypatch.setattr(tpath, "_tinted", spy)
    monkeypatch.setattr(tpath, "_extend_path", count_extend)
    pix = np.arange(12 * 12)
    px = torch.from_numpy((pix % 12).astype(np.int32))
    py = torch.from_numpy((pix // 12).astype(np.int32))
    got = {}
    for reverse in (0, 2):
        for tint in (True, False):
            arrays, meta, cfg = scenes.port_build(
                _sky_scene(tmp_path, reverse, tint))
            args = (arrays, meta, cfg.settings, cfg.get_camera(), px, py)
            for tracer in ("queued", "per_sample"):
                calls.clear()
                iters.clear()
                if tracer == "per_sample":
                    out = tpath.render_lanes(*args, torch.zeros_like(px.long()),
                                             42).radiance
                elif reverse:
                    out = tpath.trace_wavefront_queued_bdpt(*args, 0, 4, 42)[0]
                else:
                    out = tpath.trace_wavefront_queued(*args, 0, 4, 42)[0]
                eye = sum(1 for tag in iters if tag == tpath.TAG_EYE)
                got[reverse, tint, tracer] = (len(calls), eye, out)
    for (reverse, tint, tracer), (n_calls, eye, _) in got.items():
        if not tint:
            assert n_calls == 0
        elif tracer == "queued" and reverse == 0:
            assert n_calls == 2 * eye  # shadow segment and sky escape
        else:
            assert n_calls == eye      # the shadow segment only
    for key in got:  # the tint darkens every tracer's image
        if key[1]:
            on, off = got[key][2], got[key[0], False, key[2]][2]
            assert float(on.sum()) < float(off.sum())



def test_collect_ties_take_the_first_row(tmp_path):
    """Two coincident panes (the same plane, another material's id
    order): each crossing lists the first glass row at that t, as the
    reference's argmin does, and the coincident second row never."""
    cfg = _cfg(["glass"])
    cfg["scene"].append({"primitive": "plane", "axis": "Y",
                         "translate": [0, 1, 0], "scale": [5, 1, 5],
                         "material": "pane_glass"})
    path = scenes.write_config(tmp_path, cfg, "twin.json")
    _, jarrays, _, _ = scenes.jax_build(path)
    arrays, _, _ = scenes.port_build(path)
    assert arrays.glass_ids.shape == (4,)
    rng = np.random.default_rng(4)
    n = 512
    ro = np.column_stack([rng.uniform(-3, 3, n), np.full(n, 0.2),
                          rng.uniform(-3, 3, n)]).astype(np.float32)
    rd = np.tile(np.float32([0.0, 1.0, 0.0]), (n, 1))
    jt, jtri = jtg.collect_thinglass(jarrays, jnp.asarray(ro),
                                     jnp.asarray(rd), 0.0, 100.0)
    tt, ttri = tg.collect_thinglass(arrays, torch.from_numpy(ro),
                                    torch.from_numpy(rd), 0.0, 100.0)
    np.testing.assert_array_equal(ttri.numpy(), np.asarray(jtri))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    first = ttri[:, 0]
    assert bool((first >= 0).all()) and bool((ttri[:, 1] == -1).all())
    assert set(first.tolist()) <= set(arrays.glass_ids[:2].tolist())
