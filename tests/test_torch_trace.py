"""The port's tracing on the CPU: the queued runner's and the gradient
step's phase stamps and counters (`integrator/graph.py`,
`diff/graph.py`, `ops/graph_while.stamp`), the span recorder
(`utils/trace.py`) and the benchmark's readers of both
(`rgkbench/metrics/`).

Contracts:
* a queued block's `live_lanes` equals its ray counter exactly and
  `lane_steps` equals lanes x iterations, on a flat and a BVH scene; its
  query counts and any-hit live rays equal what
  `rgkbench.profiling.count_queries` counts on the same block; its
  `swept_rays` (K1's) equals `live_lanes` + `any_live_rays` on the flat
  scene and is 0 on the BVH scene;
* a runner's block (its probe stamping and counting) has the radiance
  and rays of the unstamped eager route bit for bit, and the eager route
  counts nothing;
* a counter added at one call site reaches `read_stats()` under its
  name, a name never counted reads 0, and a probe that runs out of
  slots raises;
* the gradient step counts its calls and stamps a forward and a
  backward time, the backward's nested phases added back into
  `grad_bwd_ns`; the scene build's `timings` are its phase spans;
* spans nest by parent id, the ring keeps the last `RING`, and
  `write_chrome` writes JSON in the Chrome trace format, with the
  counters of `read_stats()`;
* each reader of these counters and spans returns its value from a
  synthetic record and None when its keys are absent.
"""

import json
import time

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch.diff.graph import make_value_and_grad
from rgk_tpu_torch.diff.params import extract_params
from rgk_tpu_torch.integrator import graph
from rgk_tpu_torch.integrator import path
from rgk_tpu_torch.scene import config as tconfig
from rgk_tpu_torch.utils import trace
from rgkbench import harness, profiling

RES, MS = 16, 4


@pytest.fixture
def traced():
    """The statistics zeroed."""
    graph.reset_stats()


def _box(tmp_path, bvh):
    cfg = scenes.box_config(res=RES, ms=MS)
    if bvh:
        cfg = scenes.add_sphere(tmp_path, cfg, n_tris=5000)
    arrays, meta, c = scenes.port_build(
        scenes.write_config(tmp_path, cfg, "box.json"))
    assert meta.has_bvh == bvh
    return arrays, meta, c.settings, c.get_camera()


def _block(n=RES * RES):
    pix = torch.arange(n)
    return (pix % RES).to(torch.int32), (pix // RES).to(torch.int32)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("bvh", [False, True], ids=["flat", "bvh"])
def test_queued_counters_match_the_block(tmp_path, traced, bvh):
    arrays, meta, s, cam = _box(tmp_path, bvh)
    px, py = _block()

    def run():
        runner = graph.QueuedGraph(arrays, meta, s, cam, px.shape[0], MS)
        graph.reset_stats()
        return runner.trace(px, py, 0, 42, cam)

    counted, (_, rays) = profiling.count_queries(run)
    st = graph.read_stats()
    assert st["live_lanes"] == int(rays) > 0
    assert st["lane_steps"] == px.shape[0] * st["iterations"] > 0
    assert st["closest_queries"] == counted["closest"] == st["iterations"]
    assert st["any_queries"] == counted["any"] > 0
    assert st["any_live_rays"] == counted["any_rays"] > 0
    # K1 sweeps the live rays and no others; a BVH scene's K2 counts none.
    assert st["swept_rays"] == (0 if bvh else st["live_lanes"]
                                + st["any_live_rays"])
    assert st["intersect_ns"] > 0 and st["other_ns"] > 0
    assert st["step_ns"] == st["intersect_ns"] + st["other_ns"]


@pytest.mark.timeout(300)
def test_untraced_runner_is_bit_equal(tmp_path, traced):
    """The probe changes no value: a runner's block equals the eager
    route's, which carries no stamps, on the same pixels and seed."""
    arrays, meta, s, cam = _box(tmp_path, False)
    px, py = _block()
    runner = graph.QueuedGraph(arrays, meta, s, cam, px.shape[0], MS)
    got = runner.trace(px, py, 0, 7, cam)
    st = graph.read_stats()
    assert st["live_lanes"] == int(got[1]) > 0 and st["intersect_ns"] > 0
    assert st["lane_steps"] == px.shape[0] * st["iterations"] > 0
    graph.reset_stats()
    want = path.trace_wavefront_queued_eager(arrays, meta, s, cam, px, py,
                                             0, MS, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    st = graph.read_stats()
    assert st["live_lanes"] == st["intersect_ns"] == st["steps"] == 0


@pytest.mark.timeout(300)
def test_counter_named_at_its_call_site(tmp_path, traced, monkeypatch):
    """A counter that one call site in the step adds reaches
    `read_stats()` under its name, with no table edited; names never
    counted read 0; a probe whose slots are all named raises on one
    more."""
    arrays, meta, s, cam = _box(tmp_path, False)
    px, py = _block()
    step = path._queued_step

    def counted(scene, meta, settings, su, cam, inp, q, sampler_mode):
        su.probe.add("lanes_stepped", torch.ones_like(inp.px).sum())
        return step(scene, meta, settings, su, cam, inp, q, sampler_mode)

    monkeypatch.setattr(path, "_queued_step", counted)
    runner = graph.QueuedGraph(arrays, meta, s, cam, px.shape[0], MS)
    runner.trace(px, py, 0, 7, cam)
    st = graph.read_stats()
    assert "lanes_stepped" in runner.probe.slots
    assert st["lanes_stepped"] == st["lane_steps"] == (
        px.shape[0] * st["iterations"]) > 0
    assert st["never_counted"] == st["light_ns"] == st["grad_fwd_ns"] == 0
    probe = graph._Probe("cpu")
    for i in range(probe.SLOTS - 2):
        probe.add(f"c{i}", torch.tensor(1))
    assert probe.acc[2:].tolist() == [1] * (probe.SLOTS - 2)
    with pytest.raises(RuntimeError, match="no slot left"):
        probe.add("one_more", torch.tensor(1))


@pytest.mark.timeout(300)
def test_gradient_step_stamps(tmp_path, traced):
    path = scenes.write_config(tmp_path, scenes.GRAD_SCENE)
    cfg = tconfig.load_config(path)
    arrays, meta, builder = tconfig.build_scene(cfg, "cpu", build_bvh=False)
    assert list(builder.timings) == ["load", "upload"]
    assert builder.timings["load"] == trace.spans("scene.load")[-1].seconds
    i = np.arange(64)
    px, py = (torch.from_numpy((i % 8).astype(np.int32)),
              torch.from_numpy((i // 8).astype(np.int32)))
    fn = make_value_and_grad(arrays, meta, cfg.settings, cfg.get_camera(),
                             px, py, torch.zeros(64, dtype=torch.int64), 3,
                             torch.zeros(64, 3))
    graph.reset_stats()
    params = extract_params(arrays)
    for _ in range(2):
        fn(params)
    st = graph.read_stats()
    assert st["grad_steps"] == 2
    assert st["grad_fwd_ns"] > 0 and st["grad_bwd_ns"] > 0
    assert len(trace.spans("grad.step")) >= 2


def test_nested_backward_phases_are_parts_of_grad_bwd_ns():
    """`_Probe.nested` stamps the backward before it into `grad_bwd_ns`
    and its own time into its name; `read_stats` reports `grad_bwd_ns`
    as the sum of the parts."""
    probe = graph._Probe("cpu")
    probe.stamp()
    time.sleep(0.002)
    with probe.nested("tex_bwd_ns"):
        time.sleep(0.002)
    probe.stamp("grad_bwd_ns")
    got = {k: int(probe.acc[at]) for k, at in probe.slots.items()}
    assert got["grad_bwd_ns"] >= 2_000_000 and got["tex_bwd_ns"] >= 2_000_000
    graph.reset_stats()
    graph._bump(grad_bwd_ns=5, tex_bwd_ns=2, bxdf_bwd_ns=3)
    st = graph.read_stats()
    assert (st["grad_bwd_ns"], st["tex_bwd_ns"], st["bxdf_bwd_ns"]) == (
        10, 2, 3)
    graph.reset_stats()


def test_spans_nest_and_the_ring_is_bounded(monkeypatch):
    with trace.span("outer", k=1) as outer:
        with trace.span("inner") as inner:
            pass
        with trace.span("inner") as second:
            pass
    assert inner.parent == second.parent == outer.id > 0
    assert outer.parent == 0 or outer.parent < outer.id
    assert inner.attrs == {} and outer.attrs == {"k": 1}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    names = [s.name for s in trace.spans()[-3:]]
    assert names == ["inner", "inner", "outer"]
    trace.clear()
    for i in range(trace.RING + 10):
        with trace.span("many", i=i):
            pass
    got = trace.spans("many")
    assert len(got) == trace.RING and got[0].attrs["i"] == 10
    trace.clear()


def test_write_chrome_gives_a_chrome_trace(tmp_path):
    trace.clear()
    with trace.span("outer"):
        with trace.span("inner", built=True, nvcc_s=1.5):
            pass
    path = tmp_path / "trace.json"
    trace.write_chrome(str(path))
    got = json.loads(path.read_text())
    events = {e["name"]: e for e in got["traceEvents"]}
    assert events["inner"]["ph"] == "X" and events["inner"]["dur"] >= 0
    assert events["inner"]["args"]["parent"] == events["outer"]["args"]["id"]
    assert events["inner"]["args"]["nvcc_s"] == 1.5
    assert events["graph.read_stats"]["ph"] == "C"
    counters = json.loads(json.dumps(graph.read_stats(), default=str))
    assert "sampler_launches" in counters and "step_ns" in counters
    assert got["otherData"]["read_stats"] == counters
    assert events["graph.read_stats"]["args"] == counters
    trace.clear()


_STATS = {"iterations": 10, "intersect_ns": 20_000_000,
          "step_ns": 50_000_000, "live_lanes": 300, "lane_steps": 1000,
          "closest_queries": 10, "any_queries": 20, "any_live_rays": 400,
          "grad_steps": 4, "grad_fwd_ns": 360_000_000,
          "grad_bwd_ns": 80_000_000, "tex_bwd_ns": 8_000_000,
          "bxdf_bwd_ns": 12_000_000, "tex_fetches": 1_000_000}
_TRIANGLES = 1000
_TEXELS = 2000
_BYTES = (300 * (32 + 16) + 400 * (32 + 4) + 30 * _TRIANGLES * 36)
# The texel backward's least bytes over the 4 steps: each textured
# lookup's colour gradient and uv read, the texel table written a step.
_TEX_BYTES = 1_000_000 * (12 + 8) + 4 * _TEXELS * 12


@pytest.mark.parametrize("name,want,needs", [
    ("intersect.graph_ms_per_step", 2.0, "intersect_ns"),
    ("shade.graph_ms_per_step", 3.0, "step_ns"),
    ("intersect.graph_roofline", 100 * _BYTES / 3.35e12 / 0.02,
     "live_lanes"),
    ("loop.live_lane_share", 0.3, "lane_steps"),
    ("grad.graph_fwd_ms", 90.0, "grad_fwd_ns"),
    ("grad.graph_bwd_ms", 20.0, "grad_steps"),
    ("grad.tex_bwd_ms", 2.0, "tex_bwd_ns"),
    ("grad.bxdf_bwd_ms", 3.0, "bxdf_bwd_ns"),
    ("grad.tex_bwd_roofline", 100 * _TEX_BYTES / 3.35e12 / 0.008,
     "tex_fetches"),
])
def test_counter_readers(monkeypatch, name, want, needs):
    read = harness.load_module("metrics", name).read
    rec = {"busy_s": 1.0, "triangles": _TRIANGLES, "texels": _TEXELS}
    monkeypatch.setattr(graph, "read_stats", lambda: dict(_STATS))
    assert read(rec) == pytest.approx(want, rel=1e-12)
    assert read({}) is None
    missing = {k: v for k, v in _STATS.items() if k != needs}
    monkeypatch.setattr(graph, "read_stats", lambda: missing)
    assert read(rec) is None


@pytest.mark.parametrize("name,span", [("kernels.load_s", "kernels.load"),
                                       ("graph.warm_s", "graph.warm")])
def test_span_readers(monkeypatch, name, span):
    read = harness.load_module("metrics", name).read
    rec = {"busy_s": 1.0}
    made = []
    for ns in (1_500_000_000, 250_000_000):
        sp = trace.Span(span, {})
        sp.start_ns, sp.end_ns = 10, 10 + ns
        made.append(sp)
    monkeypatch.setattr(trace, "spans", lambda n=None: [
        s for s in made if n in (None, s.name)])
    assert read(rec) == pytest.approx(1.75)
    assert read({}) is None
    made.clear()
    assert read(rec) is None


def test_warm_reader_leaves_out_a_nested_load(monkeypatch):
    """`graph.warm_s` takes out a `kernels.load` span nested (through
    another span) in a `graph.warm` span, and leaves one outside alone."""
    read = harness.load_module("metrics", "graph.warm_s").read

    def made(name, sid, parent, ns):
        sp = trace.Span(name, {})
        sp.id, sp.parent, sp.start_ns, sp.end_ns = sid, parent, 0, ns
        return sp

    ring = [made("kernels.load", 1, 0, 100_000_000),
            made("kernels.load", 4, 3, 400_000_000),
            made("inner", 3, 2, 450_000_000),
            made("graph.warm", 2, 0, 1_000_000_000),
            made("graph.warm", 5, 0, 500_000_000)]
    monkeypatch.setattr(trace, "spans", lambda n=None: [
        s for s in ring if n in (None, s.name)])
    assert read({"busy_s": 1.0}) == pytest.approx(1.1)
