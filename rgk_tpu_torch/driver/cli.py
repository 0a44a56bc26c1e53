"""Command-line interface (port of rgk_tpu/driver/cli.py).

Renders on the CUDA device unless --cpu is given; without a CUDA
device and without --cpu it raises rather than falling back.

Distribution: `--devices N` shards each block's lanes over N local
devices (every visible card by default; with --cpu, N shards on the
CPU); `--coordinator HOST:PORT --num-processes P --process-id I` renders
with P processes, each a contiguous slice of the pixel blocks (NCCL on
the card, gloo with --cpu).  `-d X Y` prints a per-bounce trace of one
pixel before rendering.  `--trace-out FILE` writes the program's spans
and the graph runners' counters as a Chrome trace at exit
(`utils/trace.py`; a process other than 0 writes FILE with `.p<rank>`
before its extension).

Usage:
    python -m rgk_tpu_torch.driver.cli scene.json [options]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..integrator.debug import trace_pixel_debug
from ..ops.sampler import MODE_NAMES
from ..parallel import multihost
from ..parallel.mesh import MeshContext
from ..scene.config import build_scene, load_config
from ..utils import log as out
from ..utils import trace
from ..utils.format import format_time
from .render import RenderDriver

ANIMATION_FRAMES = 250  # the reference's orbit: 250 frames @ 50 fps


def insert_file_suffix(path: str, suffix: str) -> str:
    base, ext = os.path.splitext(path)
    return f"{base}.{suffix}{ext}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rgk_tpu_torch",
        description="Path tracer, PyTorch/CUDA port of rgk_tpu")
    p.add_argument("config", help="scene configuration (JSON or .rtc)")
    p.add_argument("-p", "--preview", action="store_true",
                   help="preview: resolution/4, multisample/2")
    p.add_argument("-t", "--timed", type=float, metavar="MINUTES",
                   help="override: render for this many minutes")
    p.add_argument("-D", "--output-dir", metavar="DIR",
                   help="override output directory")
    p.add_argument("-s", "--scale", type=float, metavar="S",
                   help="override output-scale (exposure)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="count", default=0)
    p.add_argument("-r", "--rotate", action="store_true",
                   help="render a 250-frame orbit animation")
    p.add_argument("-c", "--compare", action="store_true",
                   help="write output with a .cmp suffix for A/B")
    p.add_argument("--no-overwrite", action="store_true",
                   help="skip frames whose output file already exists")
    p.add_argument("--resume", action="store_true",
                   help="resume from <output>.ckpt.npz if present")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sampler",
                   choices=["halton", "independent", "stratified", "lhs",
                            "vdc"],
                   default="halton", help="sampler family")
    p.add_argument("--chunk-lanes", type=int, default=1 << 20,
                   help="max wavefront lanes per pixel block")
    p.add_argument("--devices", type=int, default=0,
                   help="shard lanes over N local devices (0 = every "
                        "visible card; with --cpu, N shards on the CPU)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (plain versions of the kernels)")
    p.add_argument("--coordinator", metavar="HOST:PORT", default="",
                   help="multi-process: address of process 0")
    p.add_argument("--num-processes", type=int, default=1,
                   help="multi-process: total participating processes")
    p.add_argument("--process-id", type=int, default=0,
                   help="multi-process: this process's rank")
    p.add_argument("-d", "--debug-pixel", nargs=2, type=int,
                   metavar=("X", "Y"),
                   help="print a per-bounce trace of one pixel before "
                        "rendering")
    p.add_argument("--trace-out", metavar="FILE",
                   help="write spans and graph counters as a Chrome trace "
                        "(JSON) at exit")
    return p


def select_device(cpu: bool) -> torch.device:
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to "
                           "render on the CPU")
    return torch.device("cuda")


def make_mesh(devices: int, device: torch.device):
    """The device mesh of `--devices`, or None for one device.  On the
    card: `devices` of the visible cards (every one for 0, clamped to
    the visible count); a mesh is built when more than one card is
    visible or `devices` is given.  On the CPU: `devices` shards."""
    if device.type == "cpu":
        return MeshContext(devices=[device] * devices) if devices > 1 \
            else None
    visible = torch.cuda.device_count()
    n = min(devices, visible) if devices > 0 else visible
    if n > 1 or devices > 0:
        return MeshContext(n)
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    finally:
        if args.trace_out:
            path = args.trace_out
            if multihost.process_index() != 0:
                path = insert_file_suffix(
                    path, f"p{multihost.process_index()}")
            trace.write_chrome(path)


def _run(args) -> int:
    out.set_verbosity(2 + args.verbose - args.quiet)
    device = select_device(args.cpu)
    if args.num_processes > 1 or args.coordinator:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, device)
        if multihost.process_index() != 0:
            out.set_verbosity(0)  # one progress stream: process 0's

    cfg = load_config(args.config)
    s = cfg.settings
    if args.preview:
        s.xres = max(1, s.xres // 4)
        s.yres = max(1, s.yres // 4)
        s.multisample = max(1, s.multisample // 2)
    if args.timed is not None:
        s.timed = True
        s.render_minutes = args.timed
    if args.scale is not None:
        s.output_scale = args.scale

    out_file = s.output_file
    if args.output_dir:
        out_file = os.path.join(args.output_dir, os.path.basename(out_file))
    if args.compare:
        out_file = insert_file_suffix(out_file, "cmp")

    out.log(2, f"Loading scene from {args.config} onto {device}")
    arrays, meta, _ = build_scene(cfg, device)
    sampler_mode = MODE_NAMES[args.sampler]
    mesh = make_mesh(args.devices, device)
    if mesh is not None:
        out.log(2, f"Sharding lanes over {mesh.n} devices")

    frames = ANIMATION_FRAMES if args.rotate else 1
    for frame in range(frames):
        rotation = frame / frames if args.rotate else 0.0
        frame_file = (insert_file_suffix(out_file, f"{frame:04d}")
                      if args.rotate else out_file)
        if args.no_overwrite and os.path.exists(frame_file):
            out.log(2, f"Skipping existing frame {frame_file}")
            continue
        cam = cfg.get_camera(rotation)
        cfg.post_check()
        if args.debug_pixel is not None and frame == 0:
            dx, dy = args.debug_pixel
            trace_pixel_debug(arrays, meta, s, cam, dx, dy, seed=args.seed,
                              sampler_mode=sampler_mode)
        driver = RenderDriver(s, arrays, meta, cam, seed=args.seed,
                              sampler_mode=sampler_mode,
                              chunk_lanes=args.chunk_lanes, mesh=mesh)
        if args.resume:
            nr = driver.try_resume(frame_file + ".ckpt.npz")
            if nr:
                out.log(2, f"Resuming from round {nr}")
        os.makedirs(os.path.dirname(os.path.abspath(frame_file)),
                    exist_ok=True)
        stats = driver.render_frame(frame_file)
        out.log(1, f"Wrote {frame_file} after {stats.rounds} rounds in "
                   f"{format_time(stats.seconds)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
