"""Assets of the `box_sphere` configuration: the sphere OBJ that
`chip_smoke.write_box` adds to `tools/bdpt_scene`'s box (3,840
triangles; 3,870 with the box's analytic walls)."""

from __future__ import annotations

import os

from rgkbench import meshes


def write(cfg: dict, outdir: str) -> None:
    for name, m in cfg["meshes"].items():
        verts, nrms, faces = meshes.make_sphere(m["triangles"], *m["center"],
                                                m["radius"])
        meshes._write_obj(os.path.join(outdir, name), verts, nrms, faces)
