"""Differentiable rendering: the trainable-parameter view of a scene
(port of rgk_tpu/diff/params.py).

The renderer (integrator/path.py) is a function of `SceneArrays`, so
autograd differentiates it through the shading ops.  This module names
the leaves that make up the parameter dict (material albedo, specular,
roughness and emission, texture texels, point-light color and
intensity, sky color and intensity) and keeps the derived light tables
consistent, so that emission gradients flow through both the
surface-emission term and the NEE areal-light radiance.

Hits are detached: the intersection routes return no gradient, and
sampling decisions (light pick, roulette, lobe choice) read detached
probabilities, so with a fixed seed and roulette off the loss is smooth
in the parameters and finite differences check it.  The power prefix
tables follow intensity and emission but are detached: changing them
alters the estimator's variance, not its expectation.

The dict's tensors are leaves with `requires_grad`, copies of the
committed scene's, so `torch.autograd.grad` and a `torch.optim`
optimizer work on them directly and never write into the scene.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

PARAM_KEYS = ("mat_diffuse", "mat_specular", "mat_emission",
              "mat_roughness", "texels", "light_color",
              "light_intensity", "sky_color", "sky_intensity")


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clone().requires_grad_(True)


def extract_params(scene) -> Dict[str, torch.Tensor]:
    """The trainable leaves of a committed scene, as fresh leaf tensors
    on the scene's device."""
    return {
        "mat_diffuse": _leaf(scene.materials.diffuse),
        "mat_specular": _leaf(scene.materials.specular),
        "mat_emission": _leaf(scene.materials.emission),
        "mat_roughness": _leaf(scene.materials.roughness),
        "texels": _leaf(scene.textures.texels),
        "light_color": _leaf(scene.lights.point_color),
        "light_intensity": _leaf(scene.lights.point_intensity),
        "sky_color": _leaf(scene.sky_color),
        "sky_intensity": _leaf(scene.sky_intensity),
    }


def params_from_numpy(d: Dict[str, np.ndarray], device
                      ) -> Dict[str, torch.Tensor]:
    """Parameters given as numpy arrays, by leaf, as fresh leaves on
    `device`."""
    return {k: torch.from_numpy(np.array(d[k], np.float32)).to(device)
            .requires_grad_(True) for k in PARAM_KEYS}


def apply_params(scene, params: Dict[str, torch.Tensor]):
    """A new `SceneArrays` with `params` substituted; `scene` is not
    written.

    Derived quantities are kept consistent:
    * the emission columns of the de-indexed areal-light rows
      (`LightTable.areal_rows[:, 12:15]`, what NEE and the BDPT light
      paths read) follow the owning material's emission, rebuilt out of
      place, so emission gradients reach direct lighting;
    * the light power prefix tables (point_cum, areal_cum, totals)
      follow intensity and emission but are detached (module doc)."""
    mats = scene.materials._replace(
        diffuse=params["mat_diffuse"],
        specular=params["mat_specular"],
        emission=params["mat_emission"],
        roughness=params["mat_roughness"],
    )
    textures = scene.textures._replace(texels=params["texels"])

    lights = scene.lights
    areal_mat = scene.tri_mat[lights.areal_tri.long()]
    areal_emission = params["mat_emission"][areal_mat.long()]
    areal_rows = torch.cat([lights.areal_rows[:, :12], areal_emission,
                            lights.areal_rows[:, 15:]], dim=1)

    point_power = params["light_intensity"] * (4.0 * math.pi)
    # Areal pick weight = area * sum(emission), areas from the rows'
    # vertices.
    va = lights.areal_rows[:, 0:3]
    vb = lights.areal_rows[:, 3:6]
    vc = lights.areal_rows[:, 6:9]
    areas = 0.5 * torch.linalg.vector_norm(
        torch.linalg.cross(va - vb, vc - vb), dim=-1)
    areal_power = areas * areal_emission.sum(dim=-1)
    lights = lights._replace(
        point_color=params["light_color"],
        point_intensity=params["light_intensity"],
        point_cum=torch.cumsum(point_power, 0).detach(),
        total_point_power=point_power.sum().detach(),
        areal_rows=areal_rows,
        areal_cum=torch.cumsum(areal_power, 0).detach(),
        total_areal_power=areal_power.sum().detach(),
    )
    return scene._replace(
        materials=mats,
        textures=textures,
        lights=lights,
        sky_color=params["sky_color"],
        sky_intensity=params["sky_intensity"],
    )


def make_loss_fn(scene, meta, settings, cam, px, py, sample_idx, seed,
                 target, sampler_mode: int = 1):
    """L2 image-matching loss as a function of the parameter dict.

    Returns loss_fn(params) -> scalar tensor; differentiate it with
    `torch.autograd.grad` or `.backward()`.  `target` is per-lane target
    radiance [R, 3]; the camera and the lane tensors are moved to the
    scene's device."""
    from ..integrator.path import render_lanes

    dev = scene.tri_pack.device
    cam = cam.to(dev)
    px, py, sample_idx, target = (x.to(dev) for x in (px, py, sample_idx,
                                                      target))

    def loss_fn(params):
        s = apply_params(scene, params)
        result = render_lanes(s, meta, settings, cam, px, py, sample_idx,
                              seed, sampler_mode, differentiable=True)
        diff = result.radiance - target
        return torch.mean(diff * diff)

    return loss_fn
