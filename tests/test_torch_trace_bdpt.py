"""The queued runner's BDPT phase stamps and counters on the CPU
(`integrator/graph.py` `_Probe`), and an NEE block's counters held to
what they were before the BDPT slots came.

Contracts:
* a traced BDPT block's `light_vertices`, `splats` and `connect_rays`
  equal counts taken independently, from the light subpaths of
  `path._trace_light_subpaths` and the lanes that
  `path._connect_to_light_vertex` is called with; its light phase's live
  rays are the light extension rays plus the splat query's, one closest
  query a light vertex and one splat query a block; K1's swept rays are
  the step's live rays, connections included;
* `step_ns` equals the sum of the step's four time slots, and the light
  phase's time is in none of them;
* a BDPT block's radiance, splat image and rays equal the unstamped
  eager route's bit for bit;
* an NEE block's counts equal the parent tree's, case for case (the
  numbers below were read from it on the same block and seed), and the
  BDPT counters stay 0;
* the benchmark's `bdpt.*` readers compute their value from a traced
  record's window counters and give None without them.
"""

import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch.integrator import graph
from rgk_tpu_torch.integrator import path
from rgkbench import harness

RES = 16
SEED = 1234567


@pytest.fixture
def traced():
    graph.reset_stats()


def _scene(tmp_path, bvh=False, **overrides):
    cfg = scenes.box_config(res=RES, **overrides)
    if bvh:
        cfg = scenes.add_sphere(tmp_path, cfg, n_tris=5000)
    arrays, meta, c = scenes.port_build(
        scenes.write_config(tmp_path, cfg, "box.json"))
    assert meta.has_bvh == bvh
    return arrays, meta, c.settings, c.get_camera()


def _block():
    pix = torch.arange(RES * RES)
    return (pix % RES).to(torch.int32), (pix // RES).to(torch.int32)


def _counting(monkeypatch):
    """Wraps the light subpaths and the connections to count what they
    were given: valid light vertices, splats in view, connection lanes
    with a valid light vertex and an active eye vertex."""
    got = {"light_vertices": 0, "splats": 0, "connect_rays": 0,
           "light_rays": 0}
    light, connect = path._trace_light_subpaths, path._connect_to_light_vertex

    def counted_light(*args, **kw):
        lrec, pix, val, rays = light(*args, **kw)
        got["light_vertices"] += int(lrec["valid"].sum())
        got["splats"] += int((pix >= 0).sum())
        got["light_rays"] += int(rays)
        return lrec, pix, val, rays

    def counted_connect(scene, meta, su, lv, sp, p0, act):
        got["connect_rays"] += int((lv["valid"] & act).sum())
        return connect(scene, meta, su, lv, sp, p0, act)

    monkeypatch.setattr(path, "_trace_light_subpaths", counted_light)
    monkeypatch.setattr(path, "_connect_to_light_vertex", counted_connect)
    return got


@pytest.mark.timeout(600)
@pytest.mark.parametrize("ms", [1, 2])
def test_bdpt_counters_match_the_light_phase_and_lanes(tmp_path, traced,
                                                       monkeypatch, ms):
    arrays, meta, s, cam = _scene(tmp_path, ms=ms, reverse=4)
    px, py = _block()
    runner = graph.QueuedGraph(arrays, meta, s, cam, px.shape[0], ms)
    assert runner.bdpt
    graph.reset_stats()
    got = _counting(monkeypatch)
    _, splat, rays = runner.trace(px, py, 2 * ms, SEED, cam)
    st = graph.read_stats()
    assert st["light_vertices"] == got["light_vertices"] > 0
    assert st["splats"] == got["splats"] > 0
    assert st["connect_rays"] == got["connect_rays"] > 0
    assert float(splat.sum()) > 0
    # The light phase: `reverse` closest queries over the light
    # extension rays, then the splat query over the valid vertices.
    assert st["light_closest_queries"] == 4
    assert st["light_any_queries"] == 1
    assert st["light_any_rays"] == got["light_vertices"]
    assert st["light_live_rays"] == got["light_rays"] + got["light_vertices"]
    assert int(rays) == st["live_lanes"] + got["light_rays"]
    # The step: one closest and one NEE shadow query, `reverse`
    # connections.
    assert st["closest_queries"] == st["iterations"] > 0
    assert st["any_queries"] == st["iterations"]
    assert st["connect_queries"] == 4 * st["iterations"]
    assert st["swept_rays"] == (st["live_lanes"] + st["any_live_rays"]
                                + st["connect_rays"])
    for key in ("light_ns", "light_intersect_ns", "connect_ns",
                "connect_intersect_ns", "intersect_ns", "other_ns"):
        assert st[key] > 0, key
    assert st["step_ns"] == (st["intersect_ns"] + st["other_ns"]
                             + st["connect_ns"] + st["connect_intersect_ns"])


@pytest.mark.timeout(600)
def test_bdpt_block_is_the_untraced_block(tmp_path, traced):
    """The probe changes no value: radiance, splat image and rays of a
    runner's BDPT block equal the eager route's, which carries no
    stamps, bit for bit."""
    arrays, meta, s, cam = _scene(tmp_path, ms=2, reverse=4)
    px, py = _block()
    runner = graph.QueuedGraph(arrays, meta, s, cam, px.shape[0], 2)
    got = runner.trace(px, py, 0, SEED, cam)
    want = path.trace_wavefront_queued_bdpt_eager(arrays, meta, s, cam, px,
                                                  py, 0, 2, SEED)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# An NEE block of 16 x 16 pixels, 4 samples from sample 8, seed 1234567,
# read on the parent tree: the counts, the rays and the radiance's sum.
_PARENT = {
    "flat": {"iterations": 16, "lane_steps": 4096, "live_lanes": 2124,
             "closest_queries": 16, "any_queries": 16, "any_live_rays": 1918,
             "swept_rays": 4042, "steps": 16, "blocks": 1, "flag_reads": 17,
             "rays": 2124, "rad_sum": 2212.9097366183996},
    "bvh": {"iterations": 16, "lane_steps": 4096, "live_lanes": 2165,
            "closest_queries": 16, "any_queries": 16, "any_live_rays": 1919,
            "swept_rays": 0, "steps": 16, "blocks": 1, "flag_reads": 17,
            "rays": 2165, "rad_sum": 1531.1090674214065}}
_BDPT_KEYS = ("light_ns", "light_intersect_ns", "light_live_rays",
              "light_any_rays", "light_vertices", "splats",
              "light_closest_queries", "light_any_queries", "connect_ns",
              "connect_intersect_ns", "connect_rays", "connect_queries",
              "light_replays")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("case", ["flat", "bvh"])
def test_nee_block_counts_are_the_parents(tmp_path, traced, case):
    arrays, meta, s, cam = _scene(tmp_path, bvh=case == "bvh", ms=4)
    px, py = _block()
    runner = graph.QueuedGraph(arrays, meta, s, cam, px.shape[0], 4)
    assert not runner.bdpt
    graph.reset_stats()
    rad, rays = runner.trace(px, py, 8, SEED, cam)
    st = graph.read_stats()
    want = dict(_PARENT[case])
    got = {k: st[k] for k in want if k in st}
    got.update(rays=int(rays))
    # The radiance's sum within float32 rounding of another CPU's kernels.
    assert float(rad.double().sum()) == pytest.approx(want.pop("rad_sum"),
                                                      rel=1e-6)
    assert got == want
    assert all(st[k] == 0 for k in _BDPT_KEYS)
    assert st["step_ns"] == st["intersect_ns"] + st["other_ns"] > 0


_WINDOW = {"light_ns": 40_000_000, "light_intersect_ns": 10_000_000,
           "light_replays": 2, "light_live_rays": 1000,
           "light_any_rays": 300, "light_closest_queries": 8,
           "light_any_queries": 2, "connect_ns": 30_000_000,
           "connect_intersect_ns": 10_000_000, "iterations": 20,
           "step_ns": 200_000_000}
_LIGHT_BYTES = 700 * (32 + 16) + 300 * (32 + 4) + 10 * 100 * 36


@pytest.mark.parametrize("name,want,needs", [
    ("bdpt.light_ms_per_block", 25.0, "light_replays"),
    ("bdpt.light_roofline", 100 * _LIGHT_BYTES / 3.35e12 / 0.01,
     "light_intersect_ns"),
    ("bdpt.connect_ms_per_step", 2.0, "connect_ns"),
    ("bdpt.eye_ms_per_step", 10.0, "step_ns"),
])
def test_bdpt_window_readers(name, want, needs):
    """Each `bdpt.*` reader on a traced record's window counters
    (`rgkbench/drivers/bdpt.py` `graph_window`), and None without them:
    an untraced record, or a program without the counter."""
    read = harness.load_module("metrics", name).read
    rec = {"busy_s": 1.0, "triangles": 100, "graph_window": dict(_WINDOW)}
    assert read(rec) == pytest.approx(want, rel=1e-12)
    assert read({}) is None
    assert read({"graph_window": dict(_WINDOW)}) is None
    rec["graph_window"].pop(needs)
    assert read(rec) is None
