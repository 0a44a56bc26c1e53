"""Progressive render driver: rounds / timed loop over pixel blocks
(port of rgk_tpu/driver/render.py).

Each round renders every pixel x multisample once.  The frame is cut
into pixel blocks: unidirectional renders (`reverse == 0`) trace blocks
of at most `chunk_lanes` pixels through the queued NEE tracer;
bidirectional ones blocks of `chunk_lanes // multisample` pixels through
the queued BDPT tracer, whose light-subpath phase runs on every
(pixel, sample) of the block at once.  The driver keeps one
`integrator.graph.QueuedGraph`, built at its first block: on a card a block
is one launch of a CUDA graph whose WHILE node runs the loop's step
while its end test holds (after the BDPT light phase), then the replay
of the accumulation, as the reference runs a block as one device
program; on the CPU the same runner steps eagerly.  Each block's per-pixel radiance
sums (and BDPT splat image) are added into an accumulator of [H*W+1, 3]
that stays on the scene's device (row H*W swallows the padding lanes
of the last block and the missed splats) and crosses to the host only
when the EXR is written.  The ray counter counts extension rays, the
light subpaths' included.  Seeds derive from (seed, round), so a
checkpoint of (sum, count, next round, seed) resumes with fresh sample
indices.

With a `parallel.mesh.MeshContext` each block's lanes are sharded over
its devices (blocks rounded up to a multiple of the mesh size).  Under
several processes (`parallel.multihost`) blocks are at most a
process's share of the pixels, each process renders a contiguous slice
of them, and `fetch_accumulation` is a collective that sums the
processes' accumulators and counters; process 0 alone writes the EXR
and the checkpoint, decides the timed stop and loads a checkpoint.

Spans (`utils/trace.py`): `render.round` around a round, in it
`render.block` (a block's launch) and `render.accumulate` per block;
`render.fetch`, `render.write_exr` and `render.checkpoint` in the frame
loop.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..integrator.graph import QueuedGraph
from ..io import AccumulationImage
from ..parallel import multihost
from ..utils import log as out
from ..utils import trace
from ..utils.format import LowPass, format_int_thousands, format_time
from .monitor import FrameMonitor


@dataclass
class RenderStats:
    rounds: int = 0
    rays: int = 0
    lanes: int = 0
    seconds: float = 0.0

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0


class RenderDriver:
    """Drives progressive rendering of one frame on the scene's device
    (or the devices of `mesh`)."""

    def __init__(self, settings, scene, meta, camera, seed: int = 42,
                 sampler_mode: int = 1, chunk_lanes: int = 1 << 20,
                 mesh=None):
        self.settings = settings
        self.meta = meta
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else scene.tri_pack.device)
        self.scene = mesh.shard_scene(scene) if mesh is not None else scene
        self.camera = camera.to(self.device)
        self.seed = seed
        self.sampler_mode = sampler_mode

        xres, yres = camera.xres, camera.yres
        hw = xres * yres
        self.acc = AccumulationImage(xres, yres)
        self.stats = RenderStats()
        # First round to render; load_checkpoint advances it.
        self.start_round = 0
        self.ms = max(1, int(settings.multisample))
        self.bdpt = int(settings.reverse) > 0
        self.n_procs = multihost.process_count()
        self.proc_id = multihost.process_index()
        block = int(chunk_lanes) // self.ms if self.bdpt else int(chunk_lanes)
        if self.n_procs > 1:
            # At most a process's share, so that every process gets work.
            block = min(block, -(-hw // self.n_procs))
        self.block = max(1, min(block, hw))
        if mesh is not None and self.block % mesh.n:
            self.block += mesh.n - self.block % mesh.n
        self.n_blocks = -(-hw // self.block)
        # This process's contiguous slice of blocks.
        self._blk_lo, self._blk_hi = multihost.host_lane_range(self.n_blocks)
        self.local_blocks = self._blk_hi - self._blk_lo

        # Pixel coordinates padded to whole blocks: padding lanes
        # re-render pixel 0 and scatter into the dummy row hw.
        pix = torch.arange(self._blk_lo * self.block,
                           self._blk_hi * self.block, dtype=torch.int64)
        real = pix < hw
        # Real lanes this process traces a round; fetch_accumulation
        # sums the processes' counts.
        self._local_lanes = int(real.sum()) * self.ms
        self._lanes_done = 0
        px = torch.where(real, pix % xres, 0).to(torch.int32)
        py = torch.where(real, pix // xres, 0).to(torch.int32)
        pix_idx = torch.where(real, pix, hw)
        dev = self.device
        self._px = [c.to(dev) for c in px.split(self.block)]
        self._py = [c.to(dev) for c in py.split(self.block)]
        self._pix_idx = [c.to(dev) for c in pix_idx.split(self.block)]
        self._acc_dev = torch.zeros((hw + 1, 3), dtype=torch.float32,
                                    device=dev)
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=dev)

        self._runner = None  # the block runner, built at the first block
        if mesh is not None:
            self._sharded = (mesh.make_queued_bdpt_fn if self.bdpt
                             else mesh.make_queued_fn)(meta, settings,
                                                       sampler_mode)

    def render_round(self, round_idx: int, monitor=None) -> None:
        """Render this process's blocks, every pixel x multisample once;
        accumulate on the device."""
        with trace.span("render.round", round=round_idx):
            self._render_blocks(round_idx * self.ms, monitor)
        self._lanes_done += self._local_lanes
        self.stats.lanes = self._lanes_done
        self.stats.rounds += 1

    def _render_blocks(self, sample0: int, monitor) -> None:
        if self.mesh is None and self._runner is None:
            self._runner = QueuedGraph(
                self.scene, self.meta, self.settings, self.camera,
                self.block, self.ms, self.sampler_mode, seed=self.seed)
        runner = self._runner
        for px, py, pix_idx in zip(self._px, self._py, self._pix_idx):
            if runner is not None:
                with trace.span("render.block"):
                    runner.block(px, py, sample0, self.seed, self.camera)
                with trace.span("render.accumulate"):
                    runner.accumulate(self._acc_dev, self._rays_dev, pix_idx)
            else:
                with trace.span("render.block"):
                    out = self._sharded(self.scene, self.camera, px, py,
                                        sample0, self.seed)
                with trace.span("render.accumulate"):
                    self._acc_dev.index_add_(0, pix_idx, out[0])
                    if self.bdpt:
                        self._acc_dev += out[1]
                    self._rays_dev += out[-1]
            if monitor is not None:
                monitor.add_blocks(1)

    def fetch_accumulation(self) -> None:
        """Copy the device accumulation into the host AccumulationImage
        (called before EXR writes and checkpoints).  Under several
        processes a collective: every process calls it for the same
        round, and the sum over their disjoint pixels is the frame."""
        with trace.span("render.fetch"):
            self._fetch()

    def _fetch(self) -> None:
        xres, yres = self.camera.xres, self.camera.yres
        acc = self._acc_dev[:-1]
        counters = torch.stack([
            self._rays_dev,
            torch.tensor(self._lanes_done, dtype=torch.int64,
                         device=self.device)])
        if self.n_procs > 1:
            acc = multihost.allreduce_image(acc)
            counters = multihost.allreduce_image(counters)
        acc_host = acc.cpu().numpy()
        self.acc.sum = acc_host.astype(np.float64).reshape(yres, xres, 3)
        self.acc.count = np.full((yres, xres),
                                 float(self.ms * self.stats.rounds))
        self.stats.rays, self.stats.lanes = (int(v) for v in counters.cpu())

    def render_frame(self, out_path: Optional[str] = None) -> RenderStats:
        """Run the rounds / timed loop, writing the EXR after each round."""
        s = self.settings
        est_rounds = 1 if s.timed else max(1, int(s.rounds) - self.start_round)
        with FrameMonitor(self.local_blocks * est_rounds,
                          enabled=(out.get_verbosity() >= 2
                                   and self.proc_id == 0)) as monitor:
            return self._render_frame_loop(out_path, s, monitor)

    def _render_frame_loop(self, out_path, s, monitor):
        t0 = time.time()
        eta = LowPass()
        round_idx = self.start_round
        while True:
            rt0 = time.time()
            self.render_round(round_idx, monitor=monitor)
            round_idx += 1
            rt = time.time() - rt0
            self.stats.seconds = time.time() - t0
            self.fetch_accumulation()  # a collective under processes
            if out_path and self.proc_id == 0:
                with trace.span("render.write_exr"):
                    self.acc.save(out_path, scale=s.output_scale)
                with trace.span("render.checkpoint"):
                    self.save_checkpoint(out_path + ".ckpt.npz", round_idx)
            monitor.set_rays(self.stats.rays)
            rays_s = self.stats.rays_per_sec
            if s.timed:
                total = s.render_minutes * 60.0
                left = total - self.stats.seconds
                monitor.total = max(
                    monitor.done,
                    int(round(self.local_blocks * round_idx
                              * total / max(self.stats.seconds, 1e-6))))
                out.log(2, f"Round {round_idx} in {rt:.1f}s | "
                           f"{format_int_thousands(int(rays_s))} rays/s | "
                           f"{format_time(max(0, left))} left")
                # Process 0's clock decides, so that every process
                # renders the same rounds (a disagreeing process would
                # wedge the next collective).
                stop = self.stats.seconds >= total
                if self.n_procs > 1:
                    stop = multihost.broadcast_scalar(float(stop)) > 0.5
                if stop:
                    break
            else:
                remaining = (s.rounds - round_idx) * eta.push(rt)
                out.log(2, f"Round {round_idx}/{s.rounds} in {rt:.1f}s | "
                           f"{format_int_thousands(int(rays_s))} rays/s | "
                           f"ETA {format_time(remaining)}")
                if round_idx >= s.rounds:
                    break
        self.stats.seconds = time.time() - t0
        self.fetch_accumulation()
        out.log(1, f"Total rays: {format_int_thousands(self.stats.rays)}; "
                   f"avg {format_int_thousands(int(self.stats.rays_per_sec))}"
                   f" rays/s")
        return self.stats

    # ---- checkpoint/resume: sum, count, next round, seed ----

    def save_checkpoint(self, path: str, next_round: int) -> None:
        np.savez_compressed(path, sum=self.acc.sum, count=self.acc.count,
                            next_round=next_round, seed=self.seed,
                            rays=self.stats.rays)

    def try_resume(self, path: str) -> int:
        """Load `path` if it exists.  Returns the next round index
        (0 = nothing to resume).  Under several processes, process 0
        alone looks for and loads the checkpoint and broadcasts the next
        round, so the processes agree on the rounds even without a
        shared file system."""
        if self.n_procs == 1:
            return self.load_checkpoint(path) if os.path.exists(path) else 0
        exists = self.proc_id == 0 and os.path.exists(path)
        if multihost.broadcast_scalar(float(exists)) < 0.5:
            return 0
        nr = self.load_checkpoint(path) if self.proc_id == 0 else 0
        nr = int(multihost.broadcast_scalar(float(nr)))
        if self.proc_id != 0:
            self.start_round = nr
            self.stats.rounds = nr
        # Every process keeps the checkpointed sums of its own pixels
        # (process 0 loaded them all, the others hold zeros), so each
        # pixel adds its rounds in the order of a one-process render.
        acc = multihost.allreduce_image(self._acc_dev)
        pix = torch.arange(acc.shape[0], device=acc.device)
        own = ((pix >= self._blk_lo * self.block)
               & (pix < min(self._blk_hi * self.block, acc.shape[0] - 1)))
        self._acc_dev = torch.where(own[:, None], acc, 0.0)
        return nr

    def load_checkpoint(self, path: str) -> int:
        """Restore the accumulation; returns the next round index."""
        with np.load(path) as d:
            if int(d["seed"]) != self.seed:
                raise ValueError("checkpoint seed mismatch")
            self.acc.sum = d["sum"]
            self.acc.count = d["count"]
            self.stats.rounds = int(round(float(d["count"].max()) / self.ms))
            self.stats.rays = int(d["rays"]) if "rays" in d else 0
            self.start_round = int(d["next_round"])
        xres, yres = self.camera.xres, self.camera.yres
        flat = np.zeros((xres * yres + 1, 3), np.float32)
        flat[:-1] = np.asarray(self.acc.sum, np.float32).reshape(-1, 3)
        self._acc_dev = torch.from_numpy(flat).to(self.device)
        self._rays_dev = torch.tensor(self.stats.rays, dtype=torch.int64,
                                      device=self.device)
        return self.start_round
