"""Pinhole / thin-lens camera (port of rgk_tpu/scene/camera.py).

The view screen is a world-space rectangle at `focus_plane` distance,
anchored at its corner; image x runs left->right and image y
top->bottom, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops import vecmath as vm
from ..ops import warps


# The camera's tensor fields (the others are Python numbers).
TENSOR_FIELDS = ("origin", "viewscreen", "viewscreen_x", "viewscreen_y",
                 "cameraleft", "cameraup", "direction")


@dataclass(frozen=True)
class Camera:
    origin: torch.Tensor        # [3]
    viewscreen: torch.Tensor    # [3] corner of the view rectangle
    viewscreen_x: torch.Tensor  # [3] full-width edge vector (image +x)
    viewscreen_y: torch.Tensor  # [3] full-height edge vector (image +y)
    cameraleft: torch.Tensor    # [3] lens-plane basis
    cameraup: torch.Tensor      # [3] lens-plane basis
    direction: torch.Tensor     # [3] forward
    lens_size: float            # 0 => pinhole
    xres: int = 0
    yres: int = 0

    @property
    def is_simple(self) -> bool:
        return self.lens_size == 0.0

    def to(self, device, copy: bool = False) -> "Camera":
        return replace(self, **{f: getattr(self, f).to(device, copy=copy)
                                for f in TENSOR_FIELDS})


def make_camera(position, lookat, up, yview: float, xview: float,
                xres: int, yres: int, focus_plane: float = 1.0,
                lens_size: float = 0.0) -> Camera:
    """Build the camera basis in float64 on the host (camera.cpp:7-24);
    the tensors are float32 on the CPU (`Camera.to` moves them)."""
    position = np.asarray(position, np.float64)
    lookat = np.asarray(lookat, np.float64)
    up = np.asarray(up, np.float64)

    direction = lookat - position
    direction = direction / np.linalg.norm(direction)
    cameraleft = np.cross(up, direction)
    cameraleft /= np.linalg.norm(cameraleft)
    cameraup = np.cross(cameraleft, direction)
    cameraup /= np.linalg.norm(cameraup)

    viewscreen_x = -xview * cameraleft * focus_plane
    viewscreen_y = yview * cameraup * focus_plane
    viewscreen = (position + direction * focus_plane
                  - 0.5 * viewscreen_y - 0.5 * viewscreen_x)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return Camera(
        origin=t(position), viewscreen=t(viewscreen),
        viewscreen_x=t(viewscreen_x), viewscreen_y=t(viewscreen_y),
        cameraleft=t(cameraleft), cameraup=t(cameraup),
        direction=t(direction),
        lens_size=float(np.float32(lens_size)),
        xres=int(xres), yres=int(yres))


def pixel_rays(cam: Camera, px, py, jitter, lens_sample=None):
    """Primary rays for lanes of pixels.

    px, py: int [...]; jitter: f32 [..., 2] subpixel offset in [0,1)^2;
    lens_sample: optional f32 [..., 2] for the thin-lens model.
    Returns (origins [...,3], unit directions [...,3]).
    """
    fx = (px.to(torch.float32) + jitter[..., 0]) / cam.xres
    fy = (py.to(torch.float32) + jitter[..., 1]) / cam.yres
    p = (cam.viewscreen
         + fx[..., None] * cam.viewscreen_x
         + fy[..., None] * cam.viewscreen_y)
    if lens_sample is None:
        o = cam.origin.expand(p.shape)
    else:
        lens = warps.to_disc_uniform(lens_sample) * cam.lens_size
        o = (cam.origin
             + lens[..., 0:1] * cam.cameraleft
             + lens[..., 1:2] * cam.cameraup)
    return o, vm.normalize(p - o)
