"""The port's device loops as CUDA graphs: a block of the queued
tracers, the per-sample path and (`diff/graph.py`) the gradient step
(the reference runs each as one jitted device program: a block's queued
eye walk is a `jax.lax.while_loop`, `rgk_tpu/driver/render.py`
`_round_block`; the per-sample path a `lax.scan` or `while_loop`,
`rgk_tpu/integrator/path.py` `trace_wavefront`).

`_Runner` holds what the three share: a side stream and a graph pool
per runner, warm-up on the side stream, captures timed and measured,
replays that add each capture's launch counts, and the WHILE graph
(`ops/graph_while.py`, `csrc/graph_while.cu`) that runs a loop's
captured pieces as one launch: prologue, then the body while a device
flag holds, then epilogue, the flag set on the device by a one-thread
condition setter after the prologue and after every body.

`QueuedGraph` owns static buffers for a block's inputs
(`path._QueuedInputs`), the loop's carry (`path._QueuedState`) and, for
BDPT, the packed light vertices and the splat image.  On a card it
captures, when it is built:
* the light phase (BDPT): `path._light_phase` into the lpack and splat
  buffers and the ray counter: the WHILE graph's prologue;
* one step: `path._queued_step`, its results copied back into the state
  buffers and the end test `path._queued_live` into the device flag:
  the WHILE graph's body;
and at the first `accumulate` the tail: the block's radiance added into
the caller's accumulator (`index_add_`), the splat image and the ray
count (a graph replayed as such, captured again if the accumulator
moves).  A block loads its inputs with `copy_`/`fill_` (no sync),
resets the state and the flag, and launches the WHILE graph once: no
read of the end test on the host, no step past the end.

`LaneGraph` owns static lane buffers (pixels, sample indices, the seed
as a device scalar) and a copy of the camera and the `TraceResult`
buffers, and captures `trace_wavefront`'s pieces over them:
`path._lane_init` and the first end test as the prologue, one
`path._lane_bounce` and `path._lane_live` as the body, `path._lane_finish`
as the epilogue: the reference's `while_loop` (`differentiable=False`),
which stops at the first bounce where no lane is alive.

Counters and phase stamps: every runner owns one `_Probe`, whose
device accumulator its WHILE graph's setter counts into and whose named
slots the captured bodies stamp and add into; `read_stats` reads them
all (one read each, a sync) and reports them by name.  `_Probe` lists
what is counted.

Where capture goes wrong, and what is done about it:
* Python numbers are baked into a capture.  The sample range and the
  seed are device tensors (`_QueuedInputs`; `LaneGraph`'s seed, which
  `SampleCtx` takes as a tensor), filled per block or call, and so is
  the per-sample path's bounce index (`_LaneState.bounce`); the
  camera's tensors are copied into the runner's own each time (its
  resolution and lens, Python values, are fixed per runner and
  checked); the samples a lane (`n_samples`) fix the lpack's shape.
* Tensor addresses are baked into a capture.  The graphs read only the
  runner's buffers, the scene and the runner's own setup (material
  pack), all held by the runner: lpack is a runner buffer, not a new
  allocation each block, the per-sample path's carry is the tensors its
  captured prologue made (held by the runner, written in place by the
  body), and the pixel shards and camera that a mesh makes anew on
  every call are copied in.
* The intersection route (`ops/intersect.binned_mode`) is read when a
  runner's intersector is made, so a runner keeps the route it was
  built under.  The binned route has static shapes ([R*K] sorted pairs)
  and captures like the others.
* Hidden syncs.  The warm-up and the captures run under
  `torch.cuda.set_sync_debug_mode("error")`, and a capture refuses a
  sync in any case; the plain versions of the kernels (loops over
  `nonzero`) run only on the CPU.  Build runners from one thread: the
  debug mode is process-wide.
* A WHILE graph's launch does not advance PyTorch's generators as
  `CUDAGraph.replay` does; a runner that builds one raises if its
  warm-up moved the CUDA generator's state (the port's sampler is a
  counter-based hash and draws nothing from it).
* A conditional body holds kernel, memset, memcpy (device memory),
  empty and child graph nodes only; building the WHILE graph lists the
  captures' nodes and refuses any other type by name.
* One-time setup (`kernels.load()`, K2's `launch_setup`, the autograd
  engine's streams) runs in the eager warm-up steps on a side stream,
  outside the capture.
* K2 resets its per-device work counter with a memset before each
  launch; in a graph the memset and the kernel are ordered on one
  stream.  Two graphs of one card must not run at once: a runner
  launches on its device's current stream, and a mesh lists a card
  once.
* The launch counters of the kernel wrappers are Python and do not run
  on replay: each capture's delta is recorded and added at every replay
  (and, for a WHILE body, at `read_stats`, times its runs).
A failed capture, build or launch raises; there is no eager fallback
on the card, and no environment variable picks a route.  On the CPU the
same buffers are stepped eagerly (`graph_while.run_plain`, the end test
read before every step): the buffer discipline without graphs.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import NamedTuple

import torch

from ..ops import binned_intersect as bi
from ..ops import bxdf as bx
from ..ops import cluster_intersect as ci
from ..ops import flat_intersect as fi
from ..ops import graph_while as gw
from ..ops import sampler as smp
from ..ops import vecmath as vm
from ..scene.camera import TENSOR_FIELDS
from ..utils import log as out
from ..utils import trace
from . import path as tpath

WARMUP_STEPS = 2  # eager runs of a captured body, on a side stream
_COUNTERS = (fi.launches, ci.launches, bi.launches, vm.launches,
             gw.launches, smp.launches, bx.launches)

# The counters of every runner of the process by name (`_Probe` lists
# them); `reset_stats` zeroes them.
stats = collections.Counter()


class _Phase(NamedTuple):
    """Where a queued runner's phase (`_Probe`) puts its stamps and
    counts."""
    outside: str          # the slot of the time outside the intersector
    inside: str           # the slot of the time inside it
    closest_rays: tuple   # the slots a closest query's live rays go to
    any_rays: tuple       # the slots an any-hit query's live rays go to
    swept: bool           # K1's swept rays counted into `swept_rays`
    closest: str          # the stats key of the closest queries' count
    any: str              # the stats key of the any-hit queries' count


# A step's closest rays are its ray counter, `live_lanes`, added apart.
_PHASES = {
    "eye": _Phase("other_ns", "intersect_ns", (), ("any_live_rays",), True,
                  "closest_queries", "any_queries"),
    "connect": _Phase("connect_ns", "connect_intersect_ns", (),
                      ("connect_rays",), True, "closest_queries",
                      "connect_queries"),
    "light": _Phase("light_ns", "light_intersect_ns", ("light_live_rays",),
                    ("light_live_rays", "light_any_rays"), False,
                    "light_closest_queries", "light_any_queries")}
# The gradient step's backward phases stamped apart from `grad_bwd_ns`.
_GRAD_BWD = ("tex_bwd_ns", "bxdf_bwd_ns")
# Every runner's probe, read by `settle`.
_probes = []
_lock = threading.Lock()


class _Probe:
    """A runner's device counters, and the one account of what
    `read_stats` reports.

    `acc` int64 [SLOTS] on the runner's device: slot 0 counts the WHILE
    setter's runs (the bodies, plus 1 a launch), slot `gw.LAST` holds the
    latest stamp, and a counter's name takes the next slot the first
    time it is stamped or added (`slot`): in the warm-up on a card, so
    the index is a Python number baked into the capture.  A body stamps
    (`gw.stamp`, a one-thread node: the time since the last stamp into a
    slot) and adds device counts (small reductions).  `settle` adds each
    named slot into `stats` under its name, and `per_body` (counts a
    WHILE body, the captured body's query counts among them) times the
    bodies run.  The runner zeroes the accumulator once its bodies are
    captured, so the warm-up is not counted; on the CPU the slots are
    kept with the host's clock.  The eager route (`path.*_eager`,
    `make_loss_fn` called directly) has no probe.

    A queued step (`QueuedGraph`) marks at its start (`start("eye")`); its
    queries (`counted`) stamp the time before them into `other_ns` and
    their own into `intersect_ns`; it adds its extension rays into
    `live_lanes`, the any-hit queries' live rays (t_max > t_min) into
    `any_live_rays` and the rays that K1's front end lists for its
    sweep, closest and any-hit, into `swept_rays`
    (`flat_intersect.count_swept`; none on a BVH scene), and stamps
    `other_ns` at its end.  A BDPT step's connections (`path._queued_step`
    marks them through `_Setup.probe`) stamp into `connect_ns` and
    `connect_intersect_ns` instead and add their live shadow rays into
    `connect_rays`.  These four time slots partition the step, and
    `read_stats` adds `step_ns`, their sum.  The BDPT light phase, the
    WHILE graph's prologue, stamps `light_ns` and `light_intersect_ns`
    likewise and adds the live rays of all its queries into
    `light_live_rays` (the splat query's also into `light_any_rays`), its
    valid light vertices into `light_vertices` and the splats that land
    in view into `splats`.  `_PHASES` says where each phase's stamps and
    live rays go.  The gradient step (`diff/graph.py`) marks at its
    start and stamps `grad_fwd_ns` after the loss and `grad_bwd_ns`
    after `torch.autograd.grad`.  Inside the backward, phases of their
    own (`nested`, through `gw.grad_phase`) first stamp what ran of the
    backward before them into `grad_bwd_ns`: `tex_bwd_ns`, the texel
    gathers' backward (`ops/textures.py`, the accumulate into the texel
    gradient table), and `bxdf_bwd_ns`, the BxDF kernel's backward
    launches (`ops/bxdf.py`); `read_stats` reports `grad_bwd_ns` as the
    sum of the backward's parts (`_GRAD_BWD`), the whole backward.  The
    step's forward adds its textured lookups (the lanes of each colour
    lookup with a texture, `textures.resolve_color`) into
    `tex_fetches`.

    Counted on the host, once per captured body as the launches are:
    `closest_queries`, `any_queries` and `connect_queries` a step,
    `light_closest_queries` and `light_any_queries` a light phase.  And
    by the runners: `runners`, `captures`, `capture_ms`, `pool_bytes`,
    `peak_before` / `peak_after` (max memory allocated around the latest
    build's captures), `warmup_steps` (eager runs of a body before its
    capture), `blocks`, `steps` (queued steps run: WHILE bodies, CPU
    steps), `replays` (step graphs run), `iterations` (steps that found
    the loop live), `lane_steps` (lanes x iterations), `flag_reads` (host
    reads of an end test, one sync each), `while_launches`,
    `light_replays`, `setter_runs`, `lane_bounces` (per-sample bounces
    run) and `grad_steps`."""

    SLOTS = 32

    def __init__(self, device):
        self.acc = torch.zeros(self.SLOTS, dtype=torch.int64, device=device)
        self.slots = {}    # counter name -> slot
        # Phase ("eye", "light") -> its latest run's query counts by name.
        self.queries = {}
        self._p, self._q = _PHASES["eye"], collections.Counter()
        # For `settle`, set by the runner: its weak reference, its WHILE
        # body's launch-counter delta and counts, its WHILE launches;
        # and what `settle` has taken.
        self.owner = self.delta = None
        self.per_body = {}
        self.launches = self.seen_launches = 0
        self.seen = [0] * self.SLOTS

    def slot(self, name: str) -> int:
        """The slot of counter `name`: the next free one at its first
        use."""
        at = self.slots.get(name)
        if at is None:
            at = gw.LAST + 1 + len(self.slots)
            if at >= self.SLOTS:
                raise RuntimeError(f"no slot left for counter {name!r}: a "
                                   f"probe holds {self.SLOTS}")
            self.slots[name] = at
        return at

    def stamp(self, name: str = None) -> None:
        """The time since the last stamp into slot `name`; a mark
        without one."""
        gw.stamp(self.acc, -1 if name is None else self.slot(name))

    def add(self, name: str, value) -> None:
        """`value`, an int64 [] on the device, into slot `name`."""
        self.acc[self.slot(name)].add_(value)

    @contextlib.contextmanager
    def nested(self, name: str):
        """Phase `name` inside the gradient step's backward: the time
        before it into `grad_bwd_ns`, its own into `name`."""
        self.stamp("grad_bwd_ns")
        yield
        self.stamp(name)

    def start(self, name: str) -> None:
        """A step's ("eye") or the light phase's ("light") start: a mark,
        and its query counts begun anew."""
        self.stamp()
        self._p = _PHASES[name]
        self._q = self.queries[name] = collections.Counter()

    def phase(self, name: str) -> None:
        """The time since the last stamp into the current phase's outside
        slot, then phase `name`."""
        self.end()
        self._p = _PHASES[name]

    def end(self) -> None:
        """A step's or the light phase's end."""
        self.stamp(self._p.outside)

    def counted(self, intersect):
        """`intersect` (`path._Setup.intersect`), stamped and counted."""
        def query(scene, ro, rd, t_min, t_max, exclude=None, any_hit=False):
            p = self._p
            self.stamp(p.outside)
            swept = contextlib.nullcontext()
            if p.swept:
                at = self.slot("swept_rays")
                swept = fi.count_swept(self.acc[at:at + 1])
            with swept:
                hit = intersect(scene, ro, rd, t_min, t_max, exclude=exclude,
                                any_hit=any_hit)
            self.stamp(p.inside)
            self._q[p.any if any_hit else p.closest] += 1
            into = p.any_rays if any_hit else p.closest_rays
            if into:
                # Lanes whose interval is not empty: t_max is a tensor in
                # every query of the tracers (`_extend_path`,
                # `ops/intersect.visibility`).
                live = (t_max > t_min).expand(ro.shape[0]).sum()
                for name in into:
                    self.add(name, live)
            return hit

        return query


def _bump(**deltas):
    with _lock:
        for key, v in deltas.items():
            stats[key] += v


def reset_stats() -> None:
    with _lock:
        for key in stats:
            stats[key] = type(stats[key])()
        _probes[:] = [p for p in _probes if p.owner() is not None]
        for p in _probes:
            p.acc.zero_()
            p.seen = [0] * p.SLOTS
            p.launches = p.seen_launches = 0


def settle() -> None:
    """Reads every runner's probe (one read each, a sync on the card) and
    adds what ran since the last read into `stats`: the setter's runs,
    the named slots, and the bodies' counts and kernel launches times the
    bodies run."""
    with _lock:
        probes = list(_probes)
    for p in probes:
        vals = p.acc.tolist()
        with _lock:
            new = [v - s for v, s in zip(vals, p.seen)]
            p.seen = vals
            bodies = new[0] - (p.launches - p.seen_launches)
            p.seen_launches = p.launches
            for name, at in list(p.slots.items()):
                stats[name] += new[at]
            for name, v in p.per_body.items():
                stats[name] += v * bodies
            stats["setter_runs"] += new[0]
            gw.launches["setter"] += new[0]
        if p.delta is not None:
            _add_launches(p.delta, bodies)
    with _lock:
        _probes[:] = [p for p in _probes if p.owner() is not None]


def read_stats() -> dict:
    """`stats` after `settle` (`_Probe` lists them; a name never counted
    reads 0), `overshoot`, the steps run past the end, `step_ns`, the
    queued steps' device time (the "eye" and "connect" phases' slots),
    `grad_bwd_ns` with the backward's nested phases added (`_GRAD_BWD`),
    and the sampler and BxDF kernels' launches since the process started
    (`ops/sampler.py` and `ops/bxdf.py` `launches`, replays and WHILE
    bodies included): `sampler_<entry>` and `bxdf_<entry>` by entry,
    `sampler_launches` and `bxdf_launches` in all."""
    settle()
    with _lock:
        got = collections.Counter(stats)
        counted = {"sampler": dict(smp.launches), "bxdf": dict(bx.launches)}
    for name, launched in counted.items():
        for key, v in launched.items():
            got[f"{name}_{key}"] = v
        got[f"{name}_launches"] = sum(launched.values())
    got["overshoot"] = got["steps"] - got["iterations"]
    got["step_ns"] = sum(got[_PHASES[p].outside] + got[_PHASES[p].inside]
                         for p in ("eye", "connect"))
    got["grad_bwd_ns"] += sum(got[name] for name in _GRAD_BWD)
    return got


@contextlib.contextmanager
def _no_sync():
    """Inside, an operation that makes the host wait for the card
    raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _snapshot():
    return [dict(c) for c in _COUNTERS]


def _add_launches(delta, times: int = 1):
    with _lock:
        for counter, d in zip(_COUNTERS, delta):
            for key, v in d.items():
                counter[key] += v * times


class _Runner:
    """Graphs of one device: a side stream and a graph pool of their own
    (module doc).  `_build` warms a body up and captures; `_replay`
    replays a capture and adds its launches; `_while_graph` builds the
    WHILE graph of captures kept for it, `_launch` launches it;
    `_register` hands the runner's `probe` to `settle`.  On the CPU none
    runs: the subclasses call their bodies eagerly."""

    def __init__(self, device, what: str):
        self.device = device
        self.what = what           # for the log
        self._graphs = {}          # name -> (CUDAGraph, launch-counter delta)
        self._exec = None
        self.probe = _Probe(device)
        _bump(runners=1)
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()

    def _device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _build(self, warm, captures, keep: bool = False) -> None:
        """`warm()` on the side stream (no sync allowed; its
        `WARMUP_STEPS` eager runs count as launched), then each
        (name, body) of `captures` captured, timed and measured; with
        `keep` the captures are kept for a WHILE graph, and the warm-up
        must leave the CUDA generator alone (module doc)."""
        dev = self.device
        rng = torch.cuda.get_rng_state(dev)
        with trace.span("graph.warm", runner=self.what):
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream), _no_sync():
                warm()
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            torch.cuda.synchronize(dev)
        if keep and not torch.equal(rng, torch.cuda.get_rng_state(dev)):
            raise RuntimeError(
                f"{self.what}: the body draws from PyTorch's CUDA "
                f"generator, which a WHILE graph's launch does not advance")
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        with trace.span("graph.capture", runner=self.what) as sp:
            for name, body in captures:
                self._capture(name, body, keep)
        ms = sp.seconds * 1e3
        pool = torch.cuda.memory_reserved(dev) - reserved
        peak_after = torch.cuda.max_memory_allocated(dev)
        _bump(capture_ms=ms, pool_bytes=pool, warmup_steps=WARMUP_STEPS)
        with _lock:
            stats["peak_before"], stats["peak_after"] = peak, peak_after
        out.log(3, f"{self.what} on {dev}: captured {len(self._graphs)} "
                   f"graphs in {ms:.1f} ms; graph pool {pool} bytes; max "
                   f"memory allocated {peak} -> {peak_after} bytes")

    def _capture(self, name, body, keep: bool = False) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=keep)
        before = _snapshot()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"), _no_sync():
            body()
        # The wrappers counted launches that the capture only recorded:
        # take them back, and add them at every replay instead.
        delta = [{key: c[key] - b[key] for key in c}
                 for c, b in zip(_COUNTERS, before)]
        _add_launches(delta, -1)
        self._graphs[name] = (graph, delta)
        _bump(captures=1)

    def _replay(self, name, times: int = 1) -> None:
        graph, delta = self._graphs[name]
        for _ in range(times):
            graph.replay()
        _add_launches(delta, times)

    def _register(self) -> None:
        """The probe zeroed (the warm-up is not counted) and handed to
        `settle`."""
        self.probe.acc.zero_()
        self.probe.owner = weakref.ref(self)
        with _lock:
            _probes.append(self.probe)

    def _while_graph(self, body, prologue=None, epilogue=None, *,
                     per_body):
        """The kept captures `prologue`, `body` and `epilogue` (names) as
        one WHILE graph on `self.live`, its setter counting into slot 0
        of the probe, which takes the body's launches and `per_body`
        counts."""
        def graph(name):
            return None if name is None else self._graphs[name][0]

        self.probe.delta = self._graphs[body][1]
        self.probe.per_body = per_body
        with trace.span("graph.instantiate", runner=self.what):
            self._exec = gw.WhileGraph(graph(body), self.live,
                                       self.probe.acc[0], graph(prologue),
                                       graph(epilogue))
        self._ends = [n for n in (prologue, epilogue) if n is not None]

    def _launch(self) -> None:
        """One launch of the WHILE graph: the prologue's and epilogue's
        launches are added now, the body's at `settle`."""
        self._exec.launch()
        with _lock:
            self.probe.launches += 1
        for name in self._ends:
            _add_launches(self._graphs[name][1])

    def _first_pixels(self):
        """(px, py) int32 [lanes] of the frame's first `lanes` pixels
        (wrapping), the warm-up's block."""
        xres, yres = self.cam.xres, self.cam.yres
        pix = torch.arange(self.lanes, device=self.device) % (xres * yres)
        return (pix % xres).to(torch.int32), (pix // xres).to(torch.int32)

    def _check_camera(self, cam) -> None:
        if (cam.xres, cam.yres, cam.lens_size) != (
                self.cam.xres, self.cam.yres, self.cam.lens_size):
            raise ValueError("the camera's resolution or lens differs from "
                             "the one the runner was built for")
        for f in TENSOR_FIELDS:
            getattr(self.cam, f).copy_(getattr(cam, f))


class QueuedGraph(_Runner):
    """A block of `lanes` pixels, `n_samples` samples each, of the queued
    NEE tracer (`settings.reverse` == 0) or BDPT tracer, on the scene's
    device (module doc).  Built once per (device, lanes, tracer); on a
    card the graphs are captured here, after warm-up steps on the
    frame's first `lanes` pixels, samples from 0, under `seed` (for a
    driver: its first block).  The step and the light phase run on `su`,
    whose queries and phases the probe stamps and counts."""

    def __init__(self, scene, meta, settings, cam, lanes: int,
                 n_samples: int, sampler_mode: int = 1, seed: int = 0):
        dev = scene.tri_pack.device
        super().__init__(dev, "queued loop")
        self.scene, self.meta, self.settings = scene, meta, settings
        self.lanes, self.n_samples = int(lanes), int(n_samples)
        self.sampler_mode = sampler_mode
        self.bdpt = int(settings.reverse) > 0
        su = tpath._setup(scene, meta, settings)
        self.su = su._replace(intersect=self.probe.counted(su.intersect),
                              probe=self.probe)
        self.cam = cam.to(dev, copy=True)
        px = torch.zeros(self.lanes, dtype=torch.int32, device=dev)
        lpack = None
        self.splat = None
        if self.bdpt:
            lpack = torch.zeros(
                (self.lanes, self.n_samples,
                 int(settings.reverse) * tpath._LV_ROW),
                dtype=torch.float32, device=dev)
            self.splat = torch.zeros((cam.xres * cam.yres + 1, 3),
                                     dtype=torch.float32, device=dev)
        self.inp = tpath._queued_inputs(px, torch.zeros_like(px), cam.xres, 0,
                                        self.n_samples, 0, lpack)
        self.state = tpath._queued_init(self.inp)
        self.live = torch.ones((), dtype=torch.bool, device=dev)
        self.pix_idx = torch.zeros(self.lanes, dtype=torch.int64, device=dev)
        self._tail_for = None  # the accumulator the tail graph adds into
        if dev.type == "cuda":
            with torch.no_grad(), torch.cuda.device(dev):
                self._graphs_for(seed)
        self._register()
        out.log(3, f"queued loop on {dev}: {self.lanes} lanes x "
                   f"{self.n_samples} samples, "
                   f"{'BDPT' if self.bdpt else 'NEE'}, binned route "
                   f"{su.binned}, " + ("one CUDA graph with a WHILE node"
                                       if dev.type == "cuda" else
                                       "eager steps"))

    def _graphs_for(self, seed: int) -> None:
        """Warm-up, the captures (the light phase, the step) and the
        WHILE graph around them."""
        self._build(lambda: self._warm(seed),
                    ([("light", self._light)] if self.bdpt else [])
                    + [("step", self._step)], keep=True)
        # The step was captured last: its queries are the body's.
        self._while_graph("step", "light" if self.bdpt else None,
                          per_body=dict(self.probe.queries["eye"], steps=1,
                                        replays=1, iterations=1,
                                        lane_steps=self.lanes))

    # ---- the bodies: run eagerly, or captured once

    def _load(self, px, py, sample0: int, seed: int, cam) -> None:
        """The block's inputs into the static buffers (`copy_`/`fill_`,
        no sync), the state reset and the end test set."""
        if px.shape[0] != self.lanes:
            raise ValueError(f"a block of {px.shape[0]} lanes for a runner "
                             f"of {self.lanes}")
        self._check_camera(cam)
        i = self.inp
        i.px.copy_(px)
        i.py.copy_(py)
        i.pixel_id.copy_(i.py.long() * self.cam.xres + i.px.long())
        i.sample0.fill_(int(sample0))
        i.s_end.fill_(int(sample0) + self.n_samples)
        i.seed.fill_(int(seed) & 0xFFFFFFFF)
        for buf, v in zip(self.state, tpath._queued_init(i)):
            buf.copy_(v)
        self.live.copy_(tpath._queued_live(self.state, i))

    def _light(self) -> None:
        self.probe.start("light")
        lpack, splat, rays = tpath._light_phase(
            self.scene, self.meta, self.settings, self.su, self.cam,
            self.inp, self.n_samples, self.sampler_mode)
        self.inp.lpack.copy_(lpack)
        self.splat.copy_(splat)
        self.state.rays.copy_(rays)
        self.probe.end()

    def _step(self) -> None:
        self.probe.start("eye")
        q = tpath._queued_step(self.scene, self.meta, self.settings,
                               self.su, self.cam, self.inp, self.state,
                               self.sampler_mode)
        self.probe.add("live_lanes", q.rays - self.state.rays)
        for buf, v in zip(self.state, q):
            buf.copy_(v)
        self.live.copy_(tpath._queued_live(self.state, self.inp))
        self.probe.end()

    def _tail(self, acc, rays_acc) -> None:
        acc.index_add_(0, self.pix_idx, self.state.radiance)
        if self.bdpt:
            acc += self.splat
        rays_acc += self.state.rays

    def _warm(self, seed: int) -> None:
        """The frame's first `lanes` pixels (class doc): the light phase
        and `WARMUP_STEPS` steps."""
        self._load(*self._first_pixels(), 0, seed, self.cam)
        if self.bdpt:
            self._light()
        for _ in range(WARMUP_STEPS):
            self._step()

    # ---- the block

    def block(self, px, py, sample0: int, seed: int, cam) -> None:
        """Trace the block of pixels (px, py) int32 [lanes], samples
        sample0 .. sample0 + n_samples - 1, into the state buffers."""
        with torch.no_grad(), self._device():
            self._load(px, py, sample0, seed, cam)
            if self.device.type != "cuda":
                n = gw.run_plain(self._step, self.live,
                                 prologue=self._light if self.bdpt else None)
                step = self.probe.queries.get("eye", {})
                _bump(blocks=1, steps=n, iterations=n, flag_reads=n + 1,
                      lane_steps=n * self.lanes,
                      **{key: v * n for key, v in step.items()})
            else:
                self._launch()
                _bump(blocks=1, while_launches=1,
                      light_replays=int(self.bdpt))
            if self.bdpt:
                _bump(**self.probe.queries["light"])

    def trace(self, px, py, sample0: int, seed: int, cam):
        """`block`, then the outputs of `path.trace_wavefront_queued`
        (NEE: radiance, rays) or `trace_wavefront_queued_bdpt` (BDPT:
        radiance, splat image, rays).  They are the runner's buffers,
        valid until its next block."""
        self.block(px, py, sample0, seed, cam)
        if self.bdpt:
            return self.state.radiance, self.splat, self.state.rays
        return self.state.radiance, self.state.rays

    def accumulate(self, acc, rays_acc, pix_idx) -> None:
        """The last block into the accumulator `acc` f32 [H*W+1, 3]
        (radiance at rows `pix_idx` int64 [lanes], plus the splat image)
        and the ray counter `rays_acc` int64 [].  On a card a captured
        tail, captured again when the accumulator moves."""
        with torch.no_grad(), self._device():
            self.pix_idx.copy_(pix_idx)
            if self.device.type != "cuda":
                self._tail(acc, rays_acc)
                return
            key = (acc.data_ptr(), tuple(acc.shape), rays_acc.data_ptr())
            if self._tail_for is None or self._tail_for[0] != key:
                self._capture("tail", lambda: self._tail(acc, rays_acc))
                self._tail_for = (key, acc, rays_acc)
            self._replay("tail")


class LaneGraph(_Runner):
    """The per-sample path (`path.trace_wavefront`, the reference's
    `while_loop`) over `lanes` lanes of (pixel, sample) on the scene's
    device (module doc): on a card one launch of a CUDA graph whose
    WHILE node runs one captured bounce while `path._lane_live` holds,
    so a call makes no sync and runs no bounce past the last live lane.
    Built once per (device, lanes); on a card captured here after warm-up runs on the frame's first `lanes` pixels, sample
    0, under `seed`.  On the CPU `trace` runs the same pieces eagerly,
    reading the end test before every bounce.  Its values are
    `render_lanes`'s bit for bit."""

    def __init__(self, scene, meta, settings, cam, lanes: int,
                 sampler_mode: int = 1, seed: int = 0):
        dev = scene.tri_pack.device
        super().__init__(dev, "per-sample path")
        self.scene, self.meta, self.settings = scene, meta, settings
        self.lanes, self.sampler_mode = int(lanes), sampler_mode
        self.su = tpath._setup(scene, meta, settings)
        self.cam = cam.to(dev, copy=True)
        r, k = self.lanes, max(0, int(settings.reverse))
        self.px = torch.zeros(r, dtype=torch.int32, device=dev)
        self.py = torch.zeros_like(self.px)
        self.sample = torch.zeros(r, dtype=torch.int64, device=dev)
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.live = torch.ones((), dtype=torch.bool, device=dev)
        self.fixed = self.state = None  # the prologue's, for the body
        self.out = tpath.TraceResult(
            radiance=torch.zeros((r, 3), dtype=torch.float32, device=dev),
            rays=torch.zeros((), dtype=torch.int64, device=dev),
            splat_pix=torch.full((r, k), -1, dtype=torch.int32, device=dev),
            splat_val=torch.zeros((r, k, 3), dtype=torch.float32,
                                  device=dev))
        if dev.type == "cuda":
            with torch.no_grad(), torch.cuda.device(dev):
                self._build(lambda: self._warm(seed),
                            [("init", self._init), ("bounce", self._bounce),
                             ("finish", self._finish)], keep=True)
                self._while_graph("bounce", "init", "finish",
                                  per_body={"lane_bounces": 1})
        self._register()
        out.log(3, f"per-sample path on {dev}: {r} lanes, depth "
                   f"{self.su.depth}, reverse {k}, binned route "
                   f"{self.su.binned}, "
                   + ("one CUDA graph with a WHILE node"
                      if dev.type == "cuda" else "eager"))

    def _load(self, px, py, sample_idx, seed: int, cam) -> None:
        if px.shape[0] != self.lanes:
            raise ValueError(f"{px.shape[0]} lanes for a runner of "
                             f"{self.lanes}")
        self._check_camera(cam)
        self.px.copy_(px)
        self.py.copy_(py)
        self.sample.copy_(sample_idx)
        self.seed.fill_(int(seed) & 0xFFFFFFFF)

    def _init(self) -> None:
        ctx = smp.SampleCtx(
            seed=self.seed,
            pixel=self.py.long() * self.cam.xres + self.px.long(),
            sample=self.sample, mode=self.sampler_mode,
            n_set=self.su.n_set)
        self.fixed, state = tpath._lane_init(
            self.scene, self.meta, self.settings, self.su, self.cam, ctx,
            self.px, self.py)
        # The body writes the carry in place, so each field gets memory
        # of its own (a pinhole camera's ray origins view its origin).
        self.state = tpath._LaneState(
            *(t if t._base is None else t.clone() for t in state))
        self.live.copy_(tpath._lane_live(self.su, self.state))

    def _bounce(self) -> None:
        q = tpath._lane_bounce(self.scene, self.meta, self.settings,
                               self.su, self.fixed, self.state,
                               self.state.bounce)
        for buf, v in zip(self.state, q):
            buf.copy_(v)
        self.live.copy_(tpath._lane_live(self.su, self.state))

    def _finish(self) -> None:
        got = tpath._lane_finish(self.su, self.fixed, self.state)
        for buf, v in zip(self.out, got):
            buf.copy_(v)

    def _warm(self, seed: int) -> None:
        """Prologue, one bounce and epilogue, `WARMUP_STEPS` times, with
        no read of the end test."""
        self._load(*self._first_pixels(), torch.zeros_like(self.sample),
                   seed, self.cam)
        for _ in range(WARMUP_STEPS):
            self._init()
            self._bounce()
            self._finish()

    def trace(self, px, py, sample_idx, seed: int, cam) -> tpath.TraceResult:
        """`render_lanes(scene, meta, settings, cam, px, py, sample_idx,
        seed, sampler_mode)`: px, py int32 [lanes], sample_idx int
        [lanes].  The result is the runner's buffers, valid until its
        next call."""
        with torch.no_grad(), self._device():
            self._load(px, py, sample_idx, seed, cam)
            if self.device.type == "cuda":
                self._launch()
            else:
                n = gw.run_plain(self._bounce, self.live,
                                 prologue=self._init, epilogue=self._finish)
                _bump(lane_bounces=n)
        return self.out
