"""Assets of the `box_sphere_bdpt` configuration: the sphere OBJ of
`box_sphere`, from the same generator and the same numbers."""

from __future__ import annotations

import os

from rgkbench import meshes


def write(cfg: dict, outdir: str) -> None:
    for name, m in cfg["meshes"].items():
        verts, nrms, faces = meshes.make_sphere(m["triangles"], *m["center"],
                                                m["radius"])
        meshes._write_obj(os.path.join(outdir, name), verts, nrms, faces)
