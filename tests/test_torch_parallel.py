"""Distribution in rgk_tpu_torch on the CPU: lanes sharded over a
`MeshContext` of CPU shards (parallel/mesh.py), and several processes
over `torch.distributed` with the gloo backend (parallel/multihost.py,
the driver's block partition and collectives, the CLI's flags).

Contracts, after tests/test_parallel.py and tests/test_multihost.py:
* a 2- or 4-shard mesh against one device: rtol 1e-4 / atol 1e-5 and
  equal ray counts (shards change batch sizes only).  On the CPU the
  port also holds bit for bit, and the tests assert that too;
* two processes against one, with the same block shapes
  (`--chunk-lanes 512`: a 48x48 frame in 5 blocks, split 3 / 2): the EXR
  and the checkpoint equal bit for bit, with 1 and with 2 shards a
  process, and after a resume under two processes.  BDPT's splat images
  add in another order across processes, so there the images agree
  within rtol 1e-5 (the reference's "1-ulp class") on the float sums.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch.driver.render import RenderDriver
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.io import read_exr
from rgk_tpu_torch.parallel import multihost
from rgk_tpu_torch.parallel.mesh import MeshContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_host_lane_range(monkeypatch, n):
    """The reference's split: contiguous, covering, no process more
    than one unit above another, the remainder on the first ones."""
    import jax

    from rgk_tpu.parallel import multihost as jmultihost

    for total in (0, 1, 4, 5, 7, 64, 1001):
        got = []
        for i in range(n):
            monkeypatch.setattr(multihost, "process_count", lambda: n)
            monkeypatch.setattr(multihost, "process_index", lambda i=i: i)
            monkeypatch.setattr(jax, "process_count", lambda: n)
            monkeypatch.setattr(jax, "process_index", lambda i=i: i)
            lo, hi = multihost.host_lane_range(total)
            assert (lo, hi) == jmultihost.host_lane_range(total)
            got.append((lo, hi))
        assert got[0][0] == 0 and got[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
        sizes = [hi - lo for lo, hi in got]
        assert max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)


def test_single_process_collectives_are_identities():
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    x = torch.arange(6, dtype=torch.float32)
    assert multihost.allreduce_image(x) is x
    assert multihost.broadcast_scalar(3.5) == 3.5
    multihost.initialize("", 1, 0)  # one process, no coordinator: no-op
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = scenes.box_config(res=16, ms=2, reverse=2)
    arrays, meta, c = scenes.port_build(scenes.write_config(tmp, cfg))
    return arrays, meta, c.settings, c.get_camera()


def _meshes():
    return [MeshContext(devices=["cpu"] * n) for n in (2, 4)]


@pytest.mark.parametrize("devices", [["cuda:0", "cuda:0"],
                                     ["cuda:1", "cpu", "cuda:1"]])
def test_mesh_refuses_a_card_twice(devices):
    """Shards on one card would share K2's per-card work counter."""
    with pytest.raises(ValueError, match="more than once"):
        MeshContext(devices=devices)


def _assert_same(a, b, rays_a, rays_b):
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(a, b)
    assert int(rays_a) == int(rays_b)


def test_mesh_render_lanes(box):
    """render_lanes (the per-sample path, BDPT with splats) sharded."""
    arrays, meta, s, cam = box
    n = 512
    i = torch.arange(n)
    px, py = (i % 16).to(torch.int32), ((i // 16) % 16).to(torch.int32)
    si = i // 256
    one = tpath.render_lanes(arrays, meta, s, cam, px, py, si, 42)
    for mesh in _meshes():
        fn = mesh.make_render_fn(meta, s)
        got = fn(mesh.shard_scene(arrays), cam, px, py, si, 42)
        _assert_same(got.radiance.numpy(), one.radiance.numpy(), got.rays,
                     one.rays)
        assert torch.equal(got.splat_pix, one.splat_pix)
        np.testing.assert_array_equal(got.splat_val.numpy(),
                                      one.splat_val.numpy())


def test_mesh_queued_round(box):
    """One driver round of the queued NEE tracer over the mesh."""
    arrays, meta, s, cam = box
    s = type(s)(**{**vars(s), "reverse": 0})
    d1 = RenderDriver(s, arrays, meta, cam, chunk_lanes=102)
    d1.render_round(0)
    d1.fetch_accumulation()
    for mesh in _meshes():
        dn = RenderDriver(s, arrays, meta, cam, chunk_lanes=102, mesh=mesh)
        assert dn.block % mesh.n == 0
        dn.render_round(0)
        dn.fetch_accumulation()
        if dn.block == d1.block:
            _assert_same(dn.acc.sum, d1.acc.sum, dn.stats.rays,
                         d1.stats.rays)
        else:
            # Blocks rounded up to the mesh size pad other lanes, whose
            # extra rays re-render pixel 0; the image is the same.
            np.testing.assert_array_equal(dn.acc.sum, d1.acc.sum)


def test_mesh_queued_bdpt_block(box):
    """One BDPT block through make_queued_bdpt_fn: radiance, the splat
    image summed over shards, and the ray count."""
    arrays, meta, s, cam = box
    i = torch.arange(64)
    px, py = (i % 16).to(torch.int32), (i // 16 + 5).to(torch.int32)
    rad, img, rays = tpath.trace_wavefront_queued_bdpt(
        arrays, meta, s, cam, px, py, 0, 2, 42)
    for mesh in _meshes():
        fn = mesh.make_queued_bdpt_fn(meta, s)
        r2, i2, n2 = fn(mesh.shard_scene(arrays), cam, px, py, 0, 42)
        _assert_same(r2.numpy(), rad.numpy(), n2, rays)
        np.testing.assert_allclose(i2.numpy(), img.numpy(), rtol=1e-5,
                                   atol=1e-7)


# ---- several processes (gloo) ---------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _scene(tmp_path, name, **overrides):
    cfg = scenes.box_config(res=48, ms=2, **{"recursion-max": 3,
                                             "rounds": 2, **overrides})
    cfg["output-file"] = name + ".exr"
    return scenes.write_config(tmp_path, cfg, name + ".json")


def _run_cli(scene, outdir, procs, extra=(), timeout=300):
    """The port's CLI on the CPU in `procs` processes (one needs no
    group), each with `extra` flags."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    base = [sys.executable, "-m", "rgk_tpu_torch.driver.cli", scene, "--cpu",
            "-D", str(outdir), "-q", "--chunk-lanes", "512", *extra]
    if procs == 1:
        argvs = [base]
    else:
        coord = f"localhost:{_free_port()}"
        argvs = [base + ["--coordinator", coord, "--num-processes",
                         str(procs), "--process-id", str(i)]
                 for i in range(procs)]
    ps = [subprocess.Popen(a, cwd=REPO, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT) for a in argvs]
    outs = [p.communicate(timeout=timeout)[0].decode() for p in ps]
    for p, o in zip(ps, outs):
        assert p.returncode == 0, f"CLI failed:\n{o[-3000:]}"


def _outputs(outdir, name):
    img = read_exr(os.path.join(str(outdir), name + ".exr"))
    with np.load(os.path.join(str(outdir), name + ".exr.ckpt.npz")) as d:
        return img, {k: d[k] for k in d.files}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("shards", [1, 2])
def test_two_processes_match_one(tmp_path, shards):
    scene = _scene(tmp_path, "mp")
    extra = ["--devices", str(shards)] if shards > 1 else []
    _run_cli(scene, tmp_path / "one", 1, extra)
    _run_cli(scene, tmp_path / "two", 2, extra)
    a, ca = _outputs(tmp_path / "one", "mp")
    b, cb = _outputs(tmp_path / "two", "mp")
    np.testing.assert_array_equal(a, b)
    assert set(ca) == set(cb)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    assert int(cb["next_round"]) == 2 and int(cb["rays"]) > 0


@pytest.mark.timeout(600)
def test_two_process_resume(tmp_path):
    """Two rounds under two processes, then a resume to four under two
    processes, equals four rounds in one process."""
    straight = _scene(tmp_path, "rs", rounds=4)
    first = _scene(tmp_path, "rs_first", rounds=2)
    _run_cli(straight, tmp_path / "one", 1)
    out = tmp_path / "two"
    _run_cli(first, out, 2)
    os.rename(out / "rs_first.exr.ckpt.npz", out / "rs.exr.ckpt.npz")
    _run_cli(straight, out, 2, ["--resume"])
    a, ca = _outputs(tmp_path / "one", "rs")
    b, cb = _outputs(out, "rs")
    np.testing.assert_array_equal(a, b)
    for k in ("sum", "count", "next_round", "seed", "rays"):
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    assert int(cb["next_round"]) == 4


@pytest.mark.timeout(600)
def test_two_process_bdpt(tmp_path):
    """A BDPT render (reverse 2) in two processes against one: splat
    images add in another order, so the sums agree within rtol 1e-5."""
    scene = _scene(tmp_path, "bd", reverse=2)
    _run_cli(scene, tmp_path / "one", 1)
    _run_cli(scene, tmp_path / "two", 2)
    _, ca = _outputs(tmp_path / "one", "bd")
    _, cb = _outputs(tmp_path / "two", "bd")
    np.testing.assert_allclose(cb["sum"], ca["sum"], rtol=1e-5, atol=1e-7)
    assert int(ca["rays"]) == int(cb["rays"]) > 0


def test_initialize_on_the_cpu_picks_gloo():
    """`device="cpu"` (the CLI's --cpu) joins a gloo group; the card is
    the default (tests/test_torch_cuda.py checks that it picks NCCL)."""
    multihost.initialize(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert multihost.process_count() == 1
    finally:
        torch.distributed.destroy_process_group()
