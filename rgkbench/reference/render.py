"""The plain reference's entry points: a scene loaded from its files, and
the sum over samples of a set of pixels.

Nothing here imports the renderer under test: the scene is read from
the same JSON, OBJ and EXR files by the reference's own copies of the
loaders, and every derived table (triangle coefficient rows, shading
rows, material pack, light tables, camera) is worked out again.
"""

from __future__ import annotations

import numpy as np
import torch

from .integrator import path
from .scene import config

LANES = 1 << 18  # lanes of one batch of the per-sample path


def load(scene_path: str, device):
    """-> (settings, scene arrays, meta, camera) of the scene at
    `scene_path` on `device`."""
    cfg = config.load_config(scene_path)
    scene, meta = config.build_scene(cfg, device)
    cam = cfg.get_camera()
    cfg.post_check()
    return cfg.settings, scene, meta, cam.to(device)


def pixel_sums(loaded, pixels, n_samples: int, seed: int,
               sampler_mode: int = 1, lanes: int = LANES):
    """The sum of samples 0 .. n_samples-1 of each pixel in `pixels`
    (flat indices y * xres + x).  -> (float64 [P, 3], extension rays
    traced, an int)."""
    settings, scene, meta, cam = loaded
    dev = scene.tri_pack.device
    pix = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=dev)
    n_pix = pix.shape[0]
    lane_pix = torch.arange(n_pix, device=dev).repeat_interleave(n_samples)
    lane_s = torch.arange(n_samples, device=dev).repeat(n_pix)
    sums = torch.zeros((n_pix, 3), dtype=torch.float64, device=dev)
    rays = 0
    with torch.no_grad():
        for s in range(0, lane_pix.shape[0], lanes):
            who = lane_pix[s:s + lanes]
            p = pix[who]
            px = (p % cam.xres).to(torch.int32)
            py = (p // cam.xres).to(torch.int32)
            out = path.render_lanes(scene, meta, settings, cam, px, py,
                                    lane_s[s:s + lanes], seed, sampler_mode)
            sums.index_add_(0, who, out.radiance.double())
            rays += int(out.rays)
    return sums.cpu().numpy(), rays
