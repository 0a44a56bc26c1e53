"""Progressive render driver: rounds / timed loop over pixel blocks
(port of rgk_tpu/driver/render.py, single process, single device).

Each round renders every pixel x multisample once.  The frame is cut
into pixel blocks of at most `chunk_lanes` lanes; each block's
per-pixel radiance sums are added into an accumulator of [H*W+1, 3]
that stays on the scene's device (row H*W swallows the padding lanes
of the last block) and crosses to the host only when the EXR is
written.  Seeds derive from (seed, round), so a checkpoint of (sum,
count, next round, seed) resumes with fresh sample indices.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rgk_tpu.driver.monitor import FrameMonitor
from rgk_tpu.utils import log as out
from rgk_tpu.utils.format import LowPass, format_int_thousands, format_time

from ..integrator.path import check_supported, trace_wavefront_queued
from ..io import AccumulationImage


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
    """Drives progressive rendering of one frame on the scene's device."""

    def __init__(self, settings, scene, meta, camera, seed: int = 42,
                 sampler_mode: int = 1, chunk_lanes: int = 1 << 20):
        check_supported(settings, meta)
        self.settings = settings
        self.scene = scene
        self.meta = meta
        self.device = scene.tri_pack.device
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
        self.block = max(1, min(int(chunk_lanes), hw))
        self.n_blocks = -(-hw // self.block)
        self._lanes_per_round = hw * self.ms

        # Pixel coordinates padded to whole blocks: padding lanes
        # re-render pixel 0 and scatter into the dummy row hw.
        pix = torch.arange(self.n_blocks * self.block, dtype=torch.int64)
        real = pix < hw
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

    def render_round(self, round_idx: int, monitor=None) -> None:
        """Render every pixel x multisample once; accumulate on device."""
        for px, py, pix_idx in zip(self._px, self._py, self._pix_idx):
            rad, rays = trace_wavefront_queued(
                self.scene, self.meta, self.settings, self.camera, px, py,
                round_idx * self.ms, self.ms, self.seed,
                sampler_mode=self.sampler_mode)
            self._acc_dev.index_add_(0, pix_idx, rad)
            self._rays_dev += rays
            if monitor is not None:
                monitor.add_blocks(1)
        self.stats.lanes += self._lanes_per_round
        self.stats.rounds += 1

    def fetch_accumulation(self) -> None:
        """Copy the device accumulation into the host AccumulationImage
        (called before EXR writes and checkpoints)."""
        xres, yres = self.camera.xres, self.camera.yres
        acc_host = self._acc_dev[:-1].cpu().numpy()
        self.acc.sum = acc_host.astype(np.float64).reshape(yres, xres, 3)
        self.acc.count = np.full((yres, xres),
                                 float(self.ms * self.stats.rounds))
        self.stats.rays = int(self._rays_dev.item())

    def render_frame(self, out_path: Optional[str] = None) -> RenderStats:
        """Run the rounds / timed loop, writing the EXR after each round."""
        s = self.settings
        est_rounds = 1 if s.timed else max(1, int(s.rounds) - self.start_round)
        with FrameMonitor(self.n_blocks * est_rounds,
                          enabled=out.get_verbosity() >= 2) as monitor:
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
            self.fetch_accumulation()
            if out_path:
                self.acc.save(out_path, scale=s.output_scale)
                self.save_checkpoint(out_path + ".ckpt.npz", round_idx)
            monitor.set_rays(self.stats.rays)
            rays_s = self.stats.rays_per_sec
            if s.timed:
                total = s.render_minutes * 60.0
                left = total - self.stats.seconds
                monitor.total = max(
                    monitor.done,
                    int(round(self.n_blocks * round_idx
                              * total / max(self.stats.seconds, 1e-6))))
                out.log(2, f"Round {round_idx} in {rt:.1f}s | "
                           f"{format_int_thousands(int(rays_s))} rays/s | "
                           f"{format_time(max(0, left))} left")
                if self.stats.seconds >= total:
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
        (0 = nothing to resume)."""
        return self.load_checkpoint(path) if os.path.exists(path) else 0

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
