"""The debug replay (`-d X Y`) of rgk_tpu_torch against rgk_tpu's
`trace_pixel_debug` on the CPU: the per-bounce records of one
(pixel, sample) lane and the lines printed.

Scenes: the box of tools/bdpt_scene.py at depth 6 (no roulette) and the
"zoo" of tests/torch_port_scenes.py (every BxDF, textures, a bump map,
an envmap sky, thin glass and a thin lens), both built in the repo.

Tolerances: int and bool fields equal; float fields within rtol 1e-4 /
atol 1e-5 (the port's flat sweep and the reference's matmul sweep sum
in another order); the same number of printed lines.
"""

import numpy as np
import pytest

import torch_port_scenes as scenes
from rgk_tpu_torch.driver import cli
from rgk_tpu_torch.integrator.debug import trace_pixel_debug

FLOATS = ("pos", "face_n", "light_n", "uv", "contribution_in",
          "contribution_out", "next_dir")
EXACT = ("bounce", "sky", "hit", "tri", "mat_id", "alive_after")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            tmp = tmp_path_factory.mktemp(name)
            cfg = (scenes.box_config(res=16, ms=4, **{"recursion-max": 6})
                   if name == "box" else scenes.zoo_config(tmp, res=16))
            path = scenes.write_config(tmp, cfg)
            _, jarrays, jmeta, jcfg = scenes.jax_build(path)
            tarrays, tmeta, tcfg = scenes.port_build(path)
            cache[name] = (path, (jarrays, jmeta, jcfg),
                           (tarrays, tmeta, tcfg))
        return cache[name]

    return get


def _replay(side, x, y, sample, seed, port):
    arrays, meta, cfg = side
    lines = []
    if port:
        fn = trace_pixel_debug
    else:
        from rgk_tpu.integrator.debug import trace_pixel_debug as fn
    recs = fn(arrays, meta, cfg.settings, cfg.get_camera(), x, y,
              sample=sample, seed=seed, printer=lines.append)
    return recs, lines


@pytest.mark.parametrize("name,x,y,sample,seed", [
    ("box", 8, 8, 0, 42),
    ("box", 3, 13, 1, 42),
    ("box", 12, 10, 2, 7),
    ("box", 8, 10, 0, 42),
    ("zoo", 8, 8, 0, 42),
    ("zoo", 12, 10, 2, 7),
    ("zoo", 3, 13, 1, 42),
])
def test_debug_replay_matches_reference(built, name, x, y, sample, seed):
    _, jside, tside = built(name)
    jrecs, jlines = _replay(jside, x, y, sample, seed, port=False)
    trecs, tlines = _replay(tside, x, y, sample, seed, port=True)
    assert jrecs and len(trecs) == len(jrecs)
    assert len(tlines) == len(jlines)
    assert "camera ray" in tlines[0]
    for j, t in zip(jrecs, trecs):
        assert set(j) == set(t)
        for k in EXACT:
            assert t[k] == j[k], (k, t[k], j[k])
        for k in FLOATS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert trecs[0]["contribution_in"] == [1.0, 1.0, 1.0]


def test_debug_replay_is_repeatable(built):
    _, _, tside = built("box")
    a, _ = _replay(tside, 8, 12, 0, 42, port=True)
    b, _ = _replay(tside, 8, 12, 0, 42, port=True)
    assert a == b and a[0]["hit"]


def test_cli_debug_pixel(built, tmp_path, capsys):
    """`-d X Y` prints the replay, then renders as usual."""
    path, _, _ = built("box")
    assert cli.main([path, "--cpu", "-q", "-D", str(tmp_path), "-d", "8",
                     "12"]) == 0
    printed = capsys.readouterr().out
    assert "[debug 8,12 s0] camera ray" in printed
    assert "  b0: " in printed
    assert (tmp_path / "bdpt_box.exr").exists()
