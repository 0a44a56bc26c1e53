"""Lanes sharded over several devices of one process (port of
rgk_tpu/parallel/mesh.py).

A `MeshContext` holds a list of torch devices, by default every visible
CUDA device.  The scene is copied to each (`shard_scene`); a block's
lanes are split into `n` equal contiguous shards, each traced on its own
device by its own host thread (on the CPU the loops read their end
test on the host, so one thread would run the devices one after
another).
The queued tracers run each shard through its own
`integrator.graph.QueuedGraph`, kept per shard, the per-sample path
through a `LaneGraph`, kept per (shard, lanes), each built on the
calling thread before the shard threads start (a build sets the
process-wide sync debug mode); on a card each shard's graphs run on
its own device.
Only one card exists where the port was measured, so the path with
n > 1 cards is unrun.
Radiance comes back to the first device in shard order, ray counts add
up, and BDPT splat images add in shard order: the reference's `psum`.

Every per-(pixel, sample) value is a pure function of (seed, pixel,
sample), so a sharded render integrates the same samples as one device;
only batch sizes change.  A list may name the CPU more than once (N
shards on the CPU), but a card only once: shards on one card would share
its stream and gain nothing, and K2 takes its work from one counter per
card that each launch resets, so two launches in flight there at once
would corrupt each other.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..integrator.graph import LaneGraph, QueuedGraph
from ..integrator.path import TraceResult


def scene_to(tree, device):
    """A committed scene (nested NamedTuples of tensors) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(scene_to(v, device) for v in tree))
    return tree


class MeshContext:
    """A 1-D list of devices and factories of sharded tracers."""

    def __init__(self, n_devices: int = 0, devices=None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is visible; pass the "
                                   "devices (for example N x 'cpu')")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if n_devices and n_devices > 0:
            devices = devices[:n_devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        cards = [d.index if d.index is not None
                 else torch.cuda.current_device()
                 for d in devices if d.type == "cuda"]
        if len(set(cards)) != len(cards):
            raise ValueError(f"a mesh lists a card more than once: {devices}")
        self.devices = devices
        self.n = len(devices)

    def shard_scene(self, scene):
        """The scene copied to each device once: a list in device
        order (one copy per distinct device)."""
        copies = {}
        return [copies.setdefault(d, scene_to(scene, d))
                for d in self.devices]

    def _run(self, fn, *lane_args):
        """fn(i, device, *shard i of each lane tensor) for every shard,
        one host thread per shard; -> the results in shard order."""
        for a in lane_args:
            if a.shape[0] % self.n:
                raise ValueError(f"{a.shape[0]} lanes do not split into "
                                 f"{self.n} equal shards")
        shards = [a.chunk(self.n) for a in lane_args]

        def one(i):
            dev = self.devices[i]
            ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                return fn(i, dev, *(s[i].to(dev) for s in shards))

        if self.n == 1:
            return [one(0)]
        with ThreadPoolExecutor(max_workers=self.n) as pool:
            return list(pool.map(one, range(self.n)))

    def _first(self, xs):
        return [x.to(self.devices[0]) for x in xs]

    def _queued_runners(self, meta, settings, sampler_mode):
        """fn(scenes, cam, px, py, sample0, seed) -> each shard's outputs
        of `QueuedGraph.trace`, in shard order."""
        ms = max(1, int(settings.multisample))
        runners = []  # by shard

        def run(scenes, cam, px, py, sample0, seed):
            if not runners:
                runners.extend(
                    QueuedGraph(scenes[i], meta, settings, cam.to(dev),
                                px.shape[0] // self.n, ms, sampler_mode,
                                seed=seed)
                    for i, dev in enumerate(self.devices))

            def shard(i, dev, spx, spy):
                return runners[i].trace(spx, spy, sample0, seed, cam.to(dev))

            return self._run(shard, px, py)

        return run

    def make_queued_fn(self, meta, settings, sampler_mode: int = 1):
        """Sharded `trace_wavefront_queued`: fn(scenes, cam, px, py,
        sample0, seed) -> (radiance [R,3], rays int64 []) on the first
        device; `scenes` from `shard_scene`."""
        shards = self._queued_runners(meta, settings, sampler_mode)

        def run(scenes, cam, px, py, sample0, seed):
            out = shards(scenes, cam, px, py, sample0, seed)
            rad = torch.cat(self._first(o[0] for o in out))
            return rad, sum(self._first(o[1] for o in out))

        return run

    def make_queued_bdpt_fn(self, meta, settings, sampler_mode: int = 1):
        """Sharded `trace_wavefront_queued_bdpt`: fn(...) as
        `make_queued_fn`'s -> (radiance, splat image [H*W+1, 3] summed
        in shard order, rays), on the first device."""
        shards = self._queued_runners(meta, settings, sampler_mode)

        def run(scenes, cam, px, py, sample0, seed):
            out = shards(scenes, cam, px, py, sample0, seed)
            rad = torch.cat(self._first(o[0] for o in out))
            return (rad, sum(self._first(o[1] for o in out)),
                    sum(self._first(o[2] for o in out)))

        return run

    def make_render_fn(self, meta, settings, sampler_mode: int = 1):
        """Sharded `render_lanes`: fn(scenes, cam, px, py, sample_idx,
        seed) -> a TraceResult on the first device.  Lane counts must
        divide into the mesh size.  Each shard runs through its own
        `integrator.graph.LaneGraph`, kept per (shard, shard lanes) and
        built on the calling thread (as `_queued_runners` builds
        theirs): on a card one launch of a graph with a WHILE node, no
        sync."""
        runners = {}

        def run(scenes, cam, px, py, sample_idx, seed):
            lanes = px.shape[0] // self.n
            for i, dev in enumerate(self.devices):
                if (i, lanes) not in runners:
                    runners[i, lanes] = LaneGraph(
                        scenes[i], meta, settings, cam.to(dev), lanes,
                        sampler_mode, seed=seed)

            def shard(i, dev, spx, spy, ssi):
                return runners[i, lanes].trace(spx, spy, ssi, seed,
                                               cam.to(dev))

            out = self._run(shard, px, py, sample_idx)
            # cat and sum copy out of the runners' buffers, which their
            # next call rewrites.
            return TraceResult(
                radiance=torch.cat(self._first(o.radiance for o in out)),
                rays=sum(self._first(o.rays for o in out)),
                splat_pix=torch.cat(self._first(o.splat_pix for o in out)),
                splat_val=torch.cat(self._first(o.splat_val for o in out)))

        return run
