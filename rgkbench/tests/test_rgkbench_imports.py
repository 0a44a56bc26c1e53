"""No module that a run or the reference imports has the top-level name
of JAX or of the JAX package, compared as whole names; the reference
imports nothing of the renderer under test."""

import os
import subprocess
import sys

from conftest import ROOT

RUN = r"""
import sys, torch
sys.path.insert(0, {root!r})
from rgkbench import harness
from conftest import small
out = harness.run_cell("box_sphere.nee", 5, 0.01, False,
                       torch.device("cpu"), wl=small("box_sphere.nee", 16, 16,
                                                     8), scenes={scenes!r})
assert out["correct"], out
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REF = r"""
import sys, torch
sys.path.insert(0, {root!r})
from rgkbench import harness
from rgkbench.reference import render
from rgkbench.drivers import grad
import conftest
wl = conftest.small("box_sphere.nee", 16, 16, 8)
path = harness.scene_file("box_sphere.nee", wl, {scenes!r})
render.pixel_sums(render.load(path, torch.device("cpu")), [3, 40], 2, 9)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.dirname(__file__),
               OMP_NUM_THREADS="2")
    got = subprocess.run(
        [sys.executable, "-c", code.format(root=ROOT,
                                           scenes=str(tmp_path))],
        capture_output=True, text=True, env=env, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return set(eval(got.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    names = _top_level(RUN, tmp_path)
    assert "rgk_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rgk_tpu"}


def test_the_reference_loads_no_renderer(tmp_path):
    names = _top_level(REF, tmp_path)
    assert not names & {"jax", "jaxlib", "flax", "rgk_tpu", "rgk_tpu_torch"}


def test_forbidden_names_are_whole_names():
    from rgkbench import harness

    sys.modules["rgk_tpu_torch_probe_only"] = sys
    try:
        assert "rgk_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["rgk_tpu_torch_probe_only"]
