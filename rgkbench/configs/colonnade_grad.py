"""Assets of the `colonnade_grad` configuration: the colonnade's, written
by the `colonnade` configuration's generator at the same budget, so the
meshes and the stone texture are byte-equal to that configuration's."""

from __future__ import annotations

from rgkbench.configs import colonnade


def write(cfg: dict, outdir: str) -> None:
    colonnade.write(cfg, outdir)
