"""Assets of the `colonnade` configuration: `tools/make_bigscene`'s
atrium at the configuration's triangle budget (ground, twelve fluted
columns, three spheres, six emissive panels) and its stone texture as
EXR, as `chip_smoke.write_colonnade` writes them."""

from __future__ import annotations

import os

import numpy as np

from rgkbench import meshes
from rgkbench.reference.io.exr import write_exr


def write(cfg: dict, outdir: str) -> None:
    n_tris = int(cfg["budget"])
    gn = max(64, int(np.sqrt(0.30 * n_tris / 2 / 2.5)))
    gv, gnrm, gf, guv = meshes.make_ground(gn)
    per_col = int(0.55 * n_tris / 12)
    nh = max(8, int(np.sqrt(per_col / 2 / 2.6)))
    ntheta = max(12, per_col // (2 * max(nh - 1, 1)))
    columns = meshes._merge([meshes.make_column(ntheta, nh, x, -15.0 + 6.0 * i)
                             for i in range(6) for x in (-3.2, 3.2)])
    per_s = int(0.15 * n_tris / 3)
    spheres = meshes._merge([
        meshes.make_sphere(per_s, 0.0, 1.2, -9.0, 1.2),
        meshes.make_sphere(per_s, -1.5, 0.9, -1.0, 0.9),
        meshes.make_sphere(per_s, 1.6, 1.0, 7.0, 1.0),
    ])
    meshes._write_obj(os.path.join(outdir, "ground.obj"), gv, gnrm, gf,
                      uvs=guv)
    for name, (v, n, f) in (("columns.obj", columns),
                            ("spheres.obj", spheres),
                            ("panels.obj", meshes.make_panels())):
        meshes._write_obj(os.path.join(outdir, name), v, n, f)
    write_exr(os.path.join(outdir, "stone.exr"), meshes.stone_texture())
