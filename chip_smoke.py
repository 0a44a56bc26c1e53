"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parent OLD/rgk_tpu_torch/csrc
    python3 chip_smoke.py --profile

Run from the root of a checkout.  With --parent (an earlier version's
kernel sources, unpacked for example by `git archive <commit>
rgk_tpu_torch/csrc`), phases 3-5 and 7 also time that version's K1 and
K2, phases 9 and 10 its K3 and K4, and phase 22 its K5, in turns with
this tree's (earlier, new, new, earlier), and holds this tree's K1, K3
and K4 bit-equal to that version's on the same inputs.  Its K1 is
called with the entry's arguments before the live-ray list (no scratch,
no swept counter).  With --profile, phases 5, 7 and 14 render their
scene once more under torch.profiler, and phase 10 the
colonnade once more with RGK_BINNED=all, and print the round's device
time per
kernel (K3, K4 and pass 2's K2 in the binned round) and the device's
busy share.  It drives
rgk_tpu_torch, never JAX, through twenty-four phases and exits non-zero at
the first that fails:

1. device: the card's name and power limit (nvidia-smi), torch/CUDA;
2. build: compiles the port's CUDA kernels from `rgk_tpu_torch/csrc`,
   one nvcc per source, all started together;
3. the flat-sweep kernel (K1) against its plain PyTorch version on a
   random soup of 4000 triangles and 2^20 rays, closest hit (with a t
   window and an exclude pass) and any hit, with median times;
4. the cluster kernel (K2) against its plain version `cluster_plain` on
   a random soup of 200,000 triangles and 2^20 rays, on both leaf
   layouts (64-triangle halves, and 8-half chunks of 4 tiles through
   CHUNK_CAP = 512): closest hit in a t window, an exclude pass, any
   hit, a third of the lanes with an empty interval; per-ray counters;
   median times (plain over fewer runs);
5. the flat render: the bdpt_scene box plus a sphere, 3870 triangles,
   at 512x512, 16 spp, one round, through the port's CLI on the card;
   every K1 launch of that run is counted (no K2 launch; K5's forward
   fetches the material rows, its backward never runs), and the first
   closest-hit and any-hit queries are replayed through kernel and plain
   version at the render's shapes, as they are (the closest one fully
   live) and with all but 27% and 2% of their live rays' windows
   emptied, scattered (K1 sweeps only the rays with a window);
6. the flat card image against the port's CPU image (64x64, 4 spp,
   depth 3) under the image parity bounds (rgk_tpu_torch/parity.py);
7. the colonnade render: tools/make_bigscene's scene at 995,628
   triangles, 960x540, depth 2, one round, through the CLI on the card,
   multisample cut from the config's 40 to 8 for the time limit; every
   K2 launch is counted (no K1 launch), the host build seconds are
   reported, and the first closest-hit and any-hit queries are
   replayed, with counters;
8. the colonnade card image against the port's CPU image (33,960
   triangles, 64x36, 4 spp, depth 2), the card images through the
   eager queued loop (`EagerDriver`, whose instruments see every ray
   query; the CLI's CUDA-graph image must equal it bit for bit), and a
   third image rendered on the
   card with K2 replaced by its plain version `cluster_plain`, which
   tells the card's kernel from the card's shading arithmetic where the
   card and CPU images part, and the two renders' ray queries compared
   one by one (the first query whose rays differ; lanes with the same
   rays and another id);
9. the binned kernels, walk-emit (K3) and chunk sweep (K4), against
   their plain versions on phase 4's soup and layouts, with K = 8 and
   K = 2 (which overflows and runs pass 2): closest hit in the window,
   an exclude pass, any hit, the empty lanes.  The plain versions run
   on every 4th sorted ray (2^18) for the time limit; the whole binned
   front end is held to K2's on all 2^20 rays;
10. the colonnade of phase 7 rendered again through the CLI with
   RGK_BINNED=any and then all (the environment restored after each):
   K3/K4 launches counted against the queued loop's steps (K1 none, K2
   as the mode implies, K5's forward and no backward), round wall time,
   rays/s, the
   first binned query replayed against the plain versions and against
   K2, with K3's node SIMD efficiency and the same-chunk runs of K4's
   sorted pairs (phase 9 prints both too), and each image against phase
   7's K2 image;
11. the small colonnade of phase 8 rendered on the card with
   RGK_BINNED=all, against phase 8's CPU image;
12. the probes P1 (shared memory per block, the u16 unpack, the cp.async
   row copy) and P2 (block votes, sweeps, tile fetches) through their
   tools' functions, against their plain versions, with the card's
   numbers;
13. thin glass with the tint-thinglass extension: the bdpt_scene box at
   512x512, 16 spp, reverse 0, with a tinted pane between the emitter
   and the floor, through the CLI on the card, once flat (K1 launches
   only) and once with a 5,000-triangle sphere OBJ, a BVH scene (K2
   only); each against the port's CPU image at 64x64, 4 spp, depth 3;
14. BDPT at full width through K1: bench.py's BDPT regime (the box,
   512x512, 16 spp, reverse 4, depth 4, no roulette, one round) through
   the CLI: K1 launches, round wall time, rays/s (light plus eye
   extensions), loop iterations (with --profile also one more round
   under torch.profiler: launches per iteration, device ms, K1 ms and
   busy share; phase 20 profiles a BDPT block on both routes); the
   block's first splat visibility query (65,536 pixels x 16
   samples x 4 light vertices = 4,194,304 rays) replayed through K1 and
   flat_plain, with K1's bound; the block's splats
   scattered twice on the card (the scatter contract: rtol 1e-5); the
   card image against the CPU image at 64x64, 4 spp, depth 3, reverse 2;
15. BDPT through K2: the box plus the 5,000-triangle sphere at 256x256,
   4 spp, reverse 4: K2 launches, the first splat visibility query
   (1,048,576 rays) replayed through K2 and cluster_plain, and the card
   image against the CPU image at 64x64, 4 spp, depth 3;
16. gradients through K1 at full width: phase 5's scene plus a point
   light, 512x512, 4 spp (1,048,576 lanes), depth 4, no roulette, the L2
   loss of `diff.params.make_loss_fn` against a target rendered with the
   diffuse albedo scaled by 0.8: forward and backward ms (medians of 3),
   peak memory, K1 launches; one eager step under torch.profiler (the
   forward's and the backward's kernels, device ms and busy share over
   the unprofiled medians, the backward's 10 autograd nodes and 5
   kernels with the most device time, and its gather nodes (K5's and
   any plain indexing's) by the forward line that made them); K1 and K5
   launches (forward and backward); the step as one CUDA graph
   (`diff.graph.make_value_and_grad`) against the eager step, timed in
   turns (graph, eager, eager, graph) after one dropped step each, its
   build (warm-up and capture) apart, graph pool and peak memory, its
   loss and every leaf's gradient equal to the eager step's bit for bit
   (K5's backward sums in a fixed order); central differences on the card for
   `mat_diffuse`, `mat_emission` and `light_intensity` (eps 1e-3, rtol
   0.03, as tests/test_grad.py) of the loss with the light-pick tables
   held at the base parameters (the gradient detaches them; with the
   tables free, a change of intensity or emission moves some of the 1M
   lanes between the point and the areal light, a jump the central
   difference of the full loss also reports, printed beside it), one
   `torch.optim.SGD` step that must lower the loss (the central
   differences hold the eager and the graph gradients), and the first
   closest-hit query replayed through K1 and flat_plain; then
   tests/test_grad.py's scene (8x8, 4 spp, a glossy cube): the gradient
   of `mat_roughness`, which moves the glossy bounce's rays, against
   central differences (eps 2e-4, rtol 0.08, as tests/test_grad.py) and
   against the CPU's gradient (rtol 5e-3);
17. gradients through K2: the box plus the 5,000-triangle sphere (its
   own material), 256x256, 4 spp: the eager step under torch.profiler
   and the graph step against the eager step as in phase 16, the
   sphere's albedo by central difference (eager and graph gradients), K2
   and K5 launches, no K1 launch;
18. the debug replay and `.rtc`: the CLI with `-d 256 256` on the flat
   scene (bounce 0's triangle and material as the CPU replay's, its
   position within rtol 1e-4), and a line-based `.rtc` scene (a floor
   quad and a 600-triangle ball in one OBJ) rendered through the CLI on
   the card (K1) against its CPU image under the parity bounds;
19. distribution on one card: the 64x64 box through the CLI plain, with
   `--devices 1` and with `--coordinator localhost:<port>
   --num-processes 1 --process-id 0` (NCCL, world size 1): EXRs and
   checkpoints equal bit for bit; a mesh that lists the card twice is
   refused;
20. the queued loop as one CUDA graph with a conditional WHILE node
   (`csrc/graph_while.cu`, the CUDA driver's version printed) against
   the eager loop (`EagerDriver`) and against the host route (the step
   replayed k times between host reads of the end test) on phase 5's
   flat scene, phase 7's colonnade with RGK_BINNED off and all, and
   phase 14's BDPT box: block 0 bit-equal to the eager loop's and to
   the host route's at k = 4 (BDPT: eye radiance and rays; splats within
   rtol 1e-5), the same iterations, no end-test read and no step past
   the end; a round's image equal to the eager loop's (BDPT within rtol
   1e-5); syncs a block under set_sync_debug_mode("warn") (none on the
   WHILE graph); WHILE launches, iterations and condition-setter runs,
   capture ms, graph pool bytes and peak memory across the capture,
   round wall time and rays/s in paired turns (graph, eager, eager,
   graph; each driver's first round dropped), the busy share of one
   block each under torch.profiler, and block 0 timed through the WHILE
   graph and the host route at k = 1, 4, 8 in turns; then the condition
   setter alone: a WHILE graph around a 3-kernel body counting to 1000
   against the same body replayed with a host read after each; then the
   phase stamp alone: 1000 captured stamps back to back, and 8 device
   sleeps (~100 ms in all) each closed by a stamp, the stamped time
   against CUDA events around the replay less those around a lone
   mark's (rtol 1e-3);
21. the per-sample path as one CUDA graph with a WHILE node:
   `render_image_round` through a `LaneGraph` against
   `render_image_round_eager` (the host bounce loop) on phase 5's flat
   scene at 512x512, 4 spp (1,048,576 lanes, K1), on phase 7's colonnade
   (960x540, 8 spp, 4,147,200 lanes, K2) and on the flat scene at the
   JSON defaults (recursion-max 40, russian 0.74; 1,048,576 lanes): the
   build apart, the prologue's, one-bounce body's and epilogue's nodes
   against the capture of every bounce, the route before the WHILE
   node (capture ms, graph pool, nodes), round 1 with the syncs of
   each route counted (the graph's must be 0), the bounces the WHILE
   graph ran (the device counter) equal to the host loop's, and the
   images equal (bit for bit), and
   equal to an eager round 1 with plain indexing in place of
   `take_rows` (the route before K5), rounds 2-3 in turns (graph,
   eager, eager, graph), one round of each under torch.profiler, graph
   pool and peak memory; then the default-depth scene's queued round at
   16 spp as phase 20 runs its scenes, and its card image against the
   port's CPU image at 64x64, 4 spp;
22. K5 (`ops/vecmath.take_rows`, `csrc/take_rows.cu`) at phase 16's
   gathers: its material pack [NM, 20], point pack [1, 8] and areal rows
   [NA, 15] with the ids of phase 16's first step (1,048,576 lanes): the
   rows against take_rows_plain bit for bit, the backward run twice bit
   for bit and within 1e-5 x max of a float64 sum; kernel (and, with
   --parent, the earlier K5 in turns), plain and library ms (forward:
   index_select; backward: index_add_, index_put_(accumulate=True) and
   the one-hot matmul with TF32 off, K5 no slower than the slower
   deterministic one) beside the bound; the same checks and turns on
   [8, 20] and [9, 20] tables, either side of the small-table route's
   bound; how many forward kernels each of 10 profiler windows of three
   forward calls records: bare, after a warm-up step of the profiler's
   schedule (as the kernel lines open theirs), and after a warm-up step
   right after a timing; then phase 16's eager step through K5 and with
   plain indexing in turns (plain, K5, K5, plain), each one's peak
   memory: the loss bit-equal, the gradients within 1e-3 x the leaf's
   largest (the plain route's backward adds each row's lanes serially
   in float32);
23. BDPT gradients through K1 at full width: bench.py's BDPT box
   (tools/bdpt_scene, 512x512, 4 spp = 1,048,576 lanes, reverse 4, depth
   4), the L2 loss of `make_loss_fn` against a target rendered with the
   diffuse albedo scaled by 0.8: one eager step (every leaf's gradient
   finite), the step as one CUDA graph against the eager step in turns
   as in phase 16 (bit for bit), `mat_diffuse` of the white walls by
   central difference (eager and graph gradients, eps 1e-3, rtol 0.03),
   forward and backward ms, peak memory, K1 and K5 launches;
24. the sampler kernel (`ops/sampler.py`, `csrc/sampler.cu`) at the box
   cell's step (262,144 lanes, Halton, a 0-d device seed): each sampler
   call of a queued NEE step (pixel jitter, areal and light-choice
   samples, the per-bounce seed, the BxDF and roulette samples) against
   the plain version on the card bit for bit, kernel and plain ms
   beside the bound by bytes, the plain version's ATen ops a call, and
   the kernel's launches by entry over phases 1-23; then the BxDF kernel
   (`ops/bxdf.py`, `csrc/bxdf.cu`) at the same lanes with the box's
   lobes and with the colonnade's (LTC-GGX): eval and sample bit for bit
   against the plain version on the card, each entry's kernel and plain
   ms (the backward entries as autograd of a saved forward) beside the
   bound by bytes, and its launches by entry over phases 1-23 (phase 20
   prints each queued body's nodes beside the same body captured with
   the plain BxDF, and checks that the kernel's is smaller).

Every CLI render on the card runs the queued loop as one CUDA graph
with a WHILE node a block (`rgk_tpu_torch/integrator/graph.py`): the
render phases print the runners' counters (captures, pool, WHILE
launches, iterations, condition-setter runs, end-test reads), and a
kernel's launch count includes its launches in graph replays and WHILE
bodies (each capture's launches times its runs, read from the card's
counters before the count is read).

The colonnade is composed from tools/make_bigscene's functions with its
budget split; its stone texture is written as the linear EXR that the
texture loader makes of the generator's PNG, so no PIL is needed.

Kernel tolerances: triangle ids equal on >= 99.99% of rays (K1 rounds
each operation as its plain version does and agrees on every ray; in
K2-K4 nvcc contracts multiply-adds to FMA, the plain versions do not,
which can flip a hit exactly on an edge); t within rtol 3e-4 / atol 1e-6 where
closest-hit ids agree; any-hit validity equal on >= 99.99% of rays;
lanes with an empty interval never hit; K4's any-hit t within rtol on
>= 99.99% of the hits whose plane distance is well conditioned
(`well_conditioned`: shadow rays start on a surface, where it cancels).
K3's lists, counts and skipmin equal the plain walk's on >= 99.99% of
lanes; the binned front end's ids equal K2's on >= 99.999% of rays (they
share the slab and row tests).

Every kernel time is printed beside its bound: the larger of its FP32
operations at the card's peak and its bytes at the memory rate, counted
from the timed query's own inputs (K2 from its per-ray counters, K4
from its listed pairs), and the share bound / time; K1 and K2 times
also beside the card's SM clock, power and temperature.  Phase 7 prints
the SAH builder that ran (and fails on the numpy fallback) and the SIMD
efficiency of K2's replayed queries: per 32 consecutive sorted rays,
the mean over the maximum of the nodes and of the chunks they visit,
averaged over warps.

Prints one line per phase with its wall seconds, then a JSON line of
the kernels (launch counts from the renders, each render's counts set
to 0 just before it and read just after: K1 the sum of phases 5, 13,
14, 16-19, 21 and 23, K2 of phases 7, 13, 15, 17 and 21, K3/K4 of the
two binned renders, the BDPT splat-query rows those of phases 14 and
15, the probes their tool runs, K5 of phases 5, 7, 10, 13-19, 21 and
23, phase 22's comparisons left out, the condition setter its runs in
phases 20 and 21's WHILE-graph rounds, the phase stamp its launches in
the graph rounds of phases 20 and 21 and the graph steps of phases 16,
17 and 23, each held to the stamps a step makes; ms, plain_ms,
bound_ms, bound_by, share, library_ms null but for K5's rows, parent_ms
for K1-K5 with --parent; the sampler's rows their entry's launches over
phases 1-23 and `plain_ops`), and last
`{"ok": true, "device": {...}}`.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import io
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import make_bigscene as mb  # noqa: E402
from bdpt_scene import scene_dict  # noqa: E402
from torch_port_scenes import GRAD_SCENE, write_rtc_scene  # noqa: E402

from rgk_tpu_torch import kernels  # noqa: E402
from rgk_tpu_torch.diff import graph as dgraph  # noqa: E402
from rgk_tpu_torch.diff import params as dparams  # noqa: E402
from rgk_tpu_torch.driver import cli  # noqa: E402
from rgk_tpu_torch.driver.render import RenderDriver  # noqa: E402
from rgk_tpu_torch.integrator import graph as tgraph  # noqa: E402
from rgk_tpu_torch.integrator.debug import trace_pixel_debug  # noqa: E402
from rgk_tpu_torch.integrator import path as tpath  # noqa: E402
from rgk_tpu_torch.io import gamma_decode, read_exr, write_exr  # noqa: E402
from rgk_tpu_torch.ops import binned_intersect as bi  # noqa: E402
from rgk_tpu_torch.ops import cluster_intersect as ci  # noqa: E402
from rgk_tpu_torch.ops import flat_intersect as fi  # noqa: E402
from rgk_tpu_torch.ops import graph_while as gw  # noqa: E402
from rgk_tpu_torch.ops import intersect as isect  # noqa: E402
from rgk_tpu_torch.ops import sampler as smp  # noqa: E402
from rgk_tpu_torch.ops import bxdf as bx  # noqa: E402
from rgk_tpu_torch.ops import vecmath as vm  # noqa: E402
from rgk_tpu_torch.parallel.mesh import MeshContext  # noqa: E402
from rgk_tpu_torch.parity import image_parity  # noqa: E402
from rgk_tpu_torch.scene import config as tconfig  # noqa: E402
from rgk_tpu_torch.scene import clusters as tclusters  # noqa: E402
from rgk_tpu_torch.scene.builder import build_tri_pack  # noqa: E402
from rgk_tpu_torch.tools import prof_smem_probe as p1  # noqa: E402
from rgk_tpu_torch.tools import prof_sync as p2  # noqa: E402

K1_SOURCE = "rgk_tpu_torch/csrc/flat_intersect.cu"
K1_REPLACES = "rgk_tpu/ops/pallas_intersect.py:122"
K2_SOURCE = "rgk_tpu_torch/csrc/cluster_intersect.cu"
K2_REPLACES = "rgk_tpu/ops/pallas_cluster.py:127"
K3_SOURCE = "rgk_tpu_torch/csrc/binned_walk.cu"
K3_REPLACES = "rgk_tpu/ops/pallas_binned.py:80"
K4_SOURCE = "rgk_tpu_torch/csrc/binned_sweep.cu"
K4_REPLACES = "rgk_tpu/ops/pallas_binned.py:323"
K5_SOURCE = "rgk_tpu_torch/csrc/take_rows.cu"
K5_REPLACES = "rgk_tpu/ops/vecmath.py:39"
SETTER_SOURCE = "rgk_tpu_torch/csrc/graph_while.cu"
SETTER_REPLACES = "rgk_tpu/integrator/path.py:344"  # the queued loop's cond
SETTER_RUNS = []  # the setter's runs in phases 20 and 21, counted from 0
STAMP_RUNS = []   # the phase stamp's launches in phases 16, 17, 20, 21, 23
SAMPLER_SOURCE = "rgk_tpu_torch/csrc/sampler.cu"
SAMPLER_REPLACES = "none: rgk_tpu/ops/sampler.py, jnp that XLA fuses"
SAMPLER_LANES = 262_144  # the box cell's block: 512 x 512 pixels
BXDF_SOURCE = "rgk_tpu_torch/csrc/bxdf.cu"
BXDF_REPLACES = "none: rgk_tpu/ops/bxdf.py, every lobe in jnp that XLA fuses"
BXDF_RUNS = []  # the BxDF kernel's launches by entry, read with K5's
SAMPLER_RUNS = []  # the sampler's launches by entry, read with K5's
PROBE_SOURCE = "rgk_tpu_torch/csrc/probes.cu"
P1_REPLACES = "tools/prof_smem_probe.py:23"
P2_REPLACES = "tools/prof_sync.py:24"
MIN_AGREE = 0.9999
BINNED_AGREE = 0.99999
BINNED_KS = (8, 2)     # the default cap, and one that overflows
PLAIN_STRIDE = 4       # the plain K3/K4 run on every 4th sorted ray
T_RTOL, T_ATOL = 3e-4, 1e-6
WARP = 32
# Bounds: the larger of the operations at the card's FP32 peak and the
# bytes (each input read once, each output written once) at its memory
# rate (H100 SXM, NVIDIA's data sheet).
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
ROW_FLOPS = 31       # rd.n 5, ro.n + d 6, t 1, hit point 6, beta 6, gamma 6,
#                      sum 1: the least work that decides a row (the
#                      hit-point test of K1's prefilter, K2 and K4)
SLAB_FLOPS = 22      # 6 subtractions, 6 multiplies, 10 min/max
RAY_BYTES = 36       # ro, rd, t_min, t_max, exclude
PARENT = None        # --parent: the earlier kernels' library, timed in turns
LIVE_SHARES = (0.27, 0.02)  # phase 5: K1 with the other rays' windows empty
PROFILE = False      # --profile: one more round of phases 5 and 7, profiled
TIMED_RUNS = 20
SLEEP_CYCLES = 100_000_000  # ~50 ms at 1.98 GHz: queued_ms's cover
PLAIN_RUNS = 3
K1_SOUP = (4000, 1 << 20)            # triangles, rays
K2_SOUP = (200_000, 1 << 20)
# (name, CHUNK_CAP or None, the chunk_halves it gives on K2_SOUP)
K2_LAYOUTS = (("halves", None, 1), ("tiles", 512, 8))
FLAT_RES, FLAT_MS = 512, 16
# make_bigscene's triangle budget, the triangles it gives, the config's
# own resolution, and its multisample of 40 cut for the time limit.
COLONNADE_BUDGET, COLONNADE_TRIS = 1_000_000, 995_628
COLONNADE_RES, COLONNADE_MS = (960, 540), 8
# bench.py's BDPT regime: tools/bdpt_scene at 512x512, 16 spp, reverse 4
# (depth 4, no roulette); the CLI's blocks of 2^20 // 16 pixels.
BDPT_RES, BDPT_MS, BDPT_REVERSE = 512, 16, 4
BVH_SPHERE = 5000     # triangles of the sphere that makes a BVH scene
K2_BDPT_RES, K2_BDPT_MS = 256, 4
# Gradients (phases 16, 17): the flat smoke scene plus a point light at
# 512x512, 4 spp (1,048,576 lanes), and the box plus the sphere at
# 256x256, 4 spp; forward and backward timed over GRAD_RUNS runs.
GRAD_RES, GRAD_MS, GRAD_RUNS = 512, 4, 3
GRAD_LIGHT = {"position": [0.8, 2.2, 1.0], "color": [1.0, 0.95, 0.9],
              "intensity": 3.0}
# (leaf, material whose red channel is checked, or None for index 0)
GRAD_K1_CHECKS = (("mat_diffuse", "white"), ("mat_emission", "glow"),
                  ("light_intensity", None))
GRAD_PEAK_LIMIT = 60e9  # bytes; above it the lanes would go in blocks
# (leaf, flat index, eps, rtol) of tests/test_grad.py's roughness check,
# and how far the card's gradient may lie from the CPU's: dropping the
# hit point's term along the ray moves this one by 2.5% on the CPU.
GRAD_ROUGHNESS = ("mat_roughness", 2, 2e-4, 0.08)
GRAD_CARD_CPU_RTOL = 5e-3
K2_GRAD_RES, K2_GRAD_MS = 256, 4
DEBUG_PIXEL = (256, 256)
RTC_RES = (96, 72)
DIST_RES = 64
HOST_KS = (1, 4, 8)  # the host route's end-test read intervals, phase 20
HOST_K = 4           # the host route block 0 is held bit-equal to
ROUTE_CYCLES = 2     # turns of (device, k ascending, k descending, device)
SETTER_ITERS = 1000  # iterations of the condition setter's own loop
SETTER_BYTES = 17    # a run reads the flag (1) and the counter (8), writes 8
STAMP_ITERS = 1000   # stamps back to back in the stamp's own captured body
STAMP_SLEEPS = 8     # sleeps of SLEEP_CYCLES // 4, each closed by a stamp
STAMP_BYTES = 32     # a stamp reads acc[last] and acc[slot], writes both
STAMP_RTOL = 1e-3    # the stamped sleeps against CUDA events around them
LANE_MS = 4  # phase 21's flat scene: 512x512 x 4 spp = 1,048,576 lanes
# The config's defaults (scene/config.py), which phase 21's scene keeps.
DEFAULT_DEPTH, DEFAULT_RUSSIAN = 40, 0.74
K5_SMALL_ROWS = 8       # csrc/take_rows.cu kSmallRows: the small-table route
K5_BOUNDARY = (8, 9)    # phase 22's tables on either side of it
WINDOW_TRIES = 10       # profiler windows: phase 22's of each kind, and
#                         the most device_kernels opens for one line
BDPT_GRAD_MS = 4        # phase 23: 512x512 x 4 spp = 1,048,576 lanes
CUDA = torch.device("cuda", 0)  # the card of phases 16-19


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, runs=TIMED_RUNS, warmup=True):
    """Median ms of `fn` over `runs`, from CUDA events around each call
    (stream time: idle gaps between its launches count)."""
    if warmup:
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reset_launches():
    vm.launches.update(forward=0, backward=0)
    fi.launches.update(closest=0, any=0)
    ci.launches.update(closest=0, any=0)
    bi.launches.update(walk=0, sweep=0)
    p1.launches.update(smem=0, unpack=0, row_copy=0)
    p2.launches.update(sync=0, fetch=0)
    gw.launches.update(setter=0, stamp=0)
    smp.launches.update(hash_u32=0, sample_1d=0, sample_2d=0)
    bx.launches.update(eval=0, sample=0, eval_bwd=0, sample_bwd=0)
    tgraph.reset_stats()


def launched(module):
    """A copy of `module.launches` after `tgraph.settle()` has added the
    launches of the WHILE graphs' bodies (read from the devices)."""
    tgraph.settle()
    return dict(module.launches)


def render_k5():
    """K5's launches since the last reset_launches(), read just after a
    render.  The sampler and BxDF kernels' launches of the same run go
    to SAMPLER_RUNS and BXDF_RUNS, so phase 24 counts the renders'
    launches alone."""
    SAMPLER_RUNS.append(launched(smp))
    BXDF_RUNS.append(launched(bx))
    return launched(vm)


def check_k5_render(k5, what):
    """A render's row fetches go through K5's forward; nothing in a
    render runs its backward."""
    check(k5["forward"] > 0 and k5["backward"] == 0,
          f"{what}'s row fetches did not go through K5 alone: {k5}")


def add_counts(*counts):
    """The sum of launch-count dicts with the same keys."""
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def compare(args, any_hit):
    """K1 against its plain version on the same inputs.  Returns (kernel
    outputs, share of rays whose id/validity agree, max abs error of t
    and barycentrics where closest-hit ids agree)."""
    k = fi.intersect_flat(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    p = fi.flat_plain(*args, any_hit=any_hit)
    same = k[1] == p[1]
    agree = same.double().mean().item()
    check(agree >= MIN_AGREE, f"{'any' if any_hit else 'closest'}-hit ids "
          f"agree on {agree:.6f} of rays, below {MIN_AGREE}")
    if any_hit:
        return k, agree, 0.0 if bool(same.all()) else 1.0
    both = same & (p[1] >= 0)
    kt, pt = k[0][both], p[0][both]
    bad = (kt - pt).abs() > T_ATOL + T_RTOL * pt.abs()
    check(not bool(bad.any()), f"closest-hit t outside rtol {T_RTOL} on "
          f"{int(bad.sum())} rays: kernel {kt[bad][:4].tolist()} plain "
          f"{pt[bad][:4].tolist()}")
    err = max(float((a[both] - b[both]).abs().max()) if bool(both.any())
              else 0.0 for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])))
    return k, agree, err


def compare_k2(args, any_hit, tri_pack):
    """K2 (`traverse` on the card) against `cluster_plain` on the same
    sorted inputs (cl, ro, rd, t_min, t_max, exclude).  The kernel's t
    only selects the winner; the front end reports t and barycentrics
    recomputed from the winner's tri_pack row (`hit_record`), which is
    held to rtol where ids agree.  The kernel's own t may differ from the
    plain version's beyond rtol on grazing hits (FMA against separate
    roundings when rd.n cancels), and must agree on >= MIN_AGREE of the
    rays that hit.  Returns (kernel outputs with counters, a dict of
    agreement and counter statistics, max abs error of the reported t
    and barycentrics where closest-hit ids agree)."""
    mode = "any" if any_hit else "closest"
    k = ci.traverse(*args, any_hit=any_hit, stats=True)
    torch.cuda.synchronize()
    p = ci.cluster_plain(*args, any_hit=any_hit, stats=True)
    ro, rd, t_min, t_max = args[1:5]
    empty = ~(t_max > t_min)
    check(not bool((k[1][empty] >= 0).any()),
          f"K2 {mode}: a lane with an empty interval hit")
    valid_k, valid_p = k[1] >= 0, p[1] >= 0
    same = (valid_k == valid_p) if any_hit else (k[1] == p[1])
    agree = same.double().mean().item()
    check(agree >= MIN_AGREE, f"K2 {mode}-hit ids agree on {agree:.6f} of "
          f"rays, below {MIN_AGREE}")
    nodes, leaves = k[2].double(), k[3].double()
    stats = {"agree": agree, "hit_rate": valid_k.double().mean().item(),
             "nodes_mean": nodes.mean().item(),
             "nodes_max": int(nodes.max()),
             "leaves_mean": leaves.mean().item(),
             "leaves_max": int(leaves.max()),
             "counters_equal": ((k[2] == p[2]) & (k[3] == p[3]))
             .double().mean().item(), "raw_t_agree": 1.0,
             "raw_t_err": 0.0}
    if any_hit:
        return k, stats, 0.0 if bool(same.all()) else 1.0
    both = same & valid_p
    if bool(both.any()):
        kt, pt = k[0][both], p[0][both]
        raw_ok = (kt - pt).abs() <= T_ATOL + T_RTOL * pt.abs()
        stats["raw_t_agree"] = raw_ok.double().mean().item()
        stats["raw_t_err"] = float((kt - pt).abs().max())
        check(stats["raw_t_agree"] >= MIN_AGREE, f"K2 in-kernel t within "
              f"rtol {T_RTOL} on {stats['raw_t_agree']:.6f} of the hits")
    rk = ci.hit_record(tri_pack, ro, rd, k[0], k[1])
    rp = ci.hit_record(tri_pack, ro, rd, p[0], p[1])
    kt, pt = rk[0][both], rp[0][both]
    bad = (kt - pt).abs() > T_ATOL + T_RTOL * pt.abs()
    check(not bool(bad.any()), f"K2 reported closest-hit t outside rtol "
          f"{T_RTOL} on {int(bad.sum())} rays")
    err = max(float((rk[i][both] - rp[i][both]).abs().max())
              if bool(both.any()) else 0.0 for i in (0, 2, 3))
    return k, stats, err


def simd_efficiency(counts, warp=WARP):
    """Per-ray work counts in sorted order -> the mean over warps (each
    `warp` consecutive rays, the last one ragged, warps with no work
    left out) of mean / max: the share of a warp's lane-steps that do
    work when every lane runs as long as its warp's longest."""
    c = counts.double()
    pad = (-c.numel()) % warp
    lanes = torch.cat([torch.ones_like(c), c.new_zeros(pad)]).view(-1, warp)
    c = torch.cat([c, c.new_zeros(pad)]).view(-1, warp)
    top = c.amax(dim=1)
    busy = top > 0
    if not bool(busy.any()):
        return 1.0
    mean = c.sum(dim=1) / lanes.sum(dim=1)
    return (mean[busy] / top[busy]).mean().item()


def pair_runs(cid, warp=WARP):
    """Sorted pair keys -> the same-chunk runs K4 sweeps: listed pairs,
    distinct chunks, pairs per chunk (median, p90, max), and the share of
    groups of `warp` consecutive listed pairs (the last one ragged) that
    span more than one chunk."""
    listed = cid[cid != bi.SENT]
    n = listed.numel()
    if n == 0:
        return {"pairs": 0, "chunks": 0, "median": 0.0, "p90": 0.0,
                "max": 0, "mixed_warps": 0.0}
    _, counts = torch.unique_consecutive(listed, return_counts=True)
    c = counts.double()
    q = torch.quantile(c, torch.tensor([0.5, 0.9], dtype=c.dtype,
                                       device=c.device)).tolist()
    last = torch.clamp(torch.arange(warp - 1, n + warp - 1, warp,
                                    device=cid.device), max=n - 1)
    mixed = (listed[last] != listed[::warp]).double().mean().item()
    return {"pairs": n, "chunks": int(counts.numel()), "median": q[0],
            "p90": q[1], "max": int(counts.max()), "mixed_warps": mixed}


def fmt_runs(st):
    return (f"{st['pairs']} listed pairs in {st['chunks']} chunks, pairs "
            f"per chunk median {st['median']:.1f} p90 {st['p90']:.1f} max "
            f"{st['max']}, {WARP}-pair groups spanning more than one chunk "
            f"{st['mixed_warps']:.4f}")


def bound(flops, nbytes):
    """-> (bound ms, "operations" or "bytes"): the least time the card
    could take for `flops` FP32 operations moving `nbytes`."""
    f, b = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (f, "operations") if f >= b else (b, "bytes")


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


@contextlib.contextmanager
def library(lib):
    """The wrappers launch `lib`'s kernels inside the block."""
    saved = kernels.load
    kernels.load = lambda: lib
    try:
        yield
    finally:
        kernels.load = saved


def queued_ms(fn, runs=TIMED_RUNS):
    """Mean ms of `fn` over `runs` calls launched back to back behind a
    sleeping kernel, so that the host's launch work hides under it and
    the CUDA events measure the card's time for the calls (for kernels of
    ~0.1 ms, which `median_ms` would time with the host's work); a call
    that syncs ends the cover and then counts its host time too."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def profiled_kernels(prof):
    """The kernels that a torch.profiler window recorded on the card
    (copies, memsets and the schedule's step annotations left out)."""
    return kernel_events(prof.events())


def kernel_events(events):
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset", "ProfilerStep"))]


def kernels_by_name(events):
    """-> {kernel name: (launches recorded, device ms in all)} of the
    events of a torch.profiler window."""
    got = {}
    for e in kernel_events(events):
        n, ms = got.get(e.name, (0, 0.0))
        got[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return got


def profile_window(fn, runs=3, warmup_step=True):
    """The events of one torch.profiler window over `runs` calls of `fn`.
    With `warmup_step` the profiler's schedule traces the same calls once
    first and drops them (schedule(wait=0, warmup=1, active=1)), so that
    the recorded window opens with the card's activity tracing running:
    a bare window can miss its first kernel."""
    from torch.profiler import ProfilerActivity, profile, schedule

    windows = []
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if warmup_step:
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: windows.append(
                         list(p.events()))) as prof:
            for _ in range(2):
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
                prof.step()
    else:
        with profile(activities=acts) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        windows.append(list(prof.events()))
    return windows[-1] if windows else []


def device_kernels(fn, runs=3):
    """`runs` calls of `fn` in a `profile_window`, as `name xN us` by
    kernel (launches recorded, mean device us a launch).  A window now
    and then records no kernel at all though its host events show the
    launches (phase 22 counts them); such a window is opened again, up to
    WINDOW_TRIES times, and the line says how many it took, or "not
    recorded".  Launches are counted, not assumed."""
    for attempt in range(1, WINDOW_TRIES + 1):
        events = profile_window(fn, runs)
        got = kernels_by_name(events)
        if got:
            break
    if not got:
        launches = sum("LaunchKernel" in e.name for e in events)
        return (f"not recorded in {WINDOW_TRIES} windows (the last: "
                f"{len(events)} host events, {launches} of them kernel "
                f"launches)")
    return ", ".join(f"{name[:60]} x{n} {ms * 1e3 / n:.1f}"
                     for name, (n, ms) in got.items()) + (
        f" (window {attempt})" if attempt > 1 else "")


def ab_ms(fn, runs=TIMED_RUNS, timer=median_ms, parent_fn=None):
    """-> (parent ms or None, new ms): `timer`'s ms of `fn` (median CUDA
    event ms by default) through the parent's library (or of
    `parent_fn`) and this tree's, in turns parent, new, new, parent, each
    the mean of its two; without --parent the new one only."""
    if PARENT is None:
        return None, timer(fn, runs)
    got = {True: [], False: []}
    for is_parent in (True, False, False, True):
        if is_parent and parent_fn is not None:
            got[True].append(timer(parent_fn, runs))
            continue
        with library(PARENT) if is_parent else contextlib.nullcontext():
            got[is_parent].append(timer(fn, runs))
    return statistics.mean(got[True]), statistics.mean(got[False])


def parent_k1(args, any_hit):
    """The parent's K1 (--parent) on `args`, as `fi.intersect_flat` takes
    them (a parent with the live-ray list's entry, as this tree's)."""
    with library(PARENT):
        return fi.intersect_flat(*args, any_hit=any_hit)


def k1_ab(args, any_hit):
    """`ab_ms` for a K1 query, the parent's K1 launched through
    `parent_k1`, whose records must equal this tree's bit for bit."""
    new = lambda: fi.intersect_flat(*args, any_hit=any_hit)  # noqa: E731
    if PARENT is None:
        return ab_ms(new)
    old = lambda: parent_k1(args, any_hit)  # noqa: E731
    a, b = old(), new()
    torch.cuda.synchronize()
    for name, x, y in zip(("t", "tri", "bary_b", "bary_c"), a, b):
        check(torch.equal(x, y), f"K1 {'any' if any_hit else 'closest'}: "
              f"{name} differs from the parent's on "
              f"{int((x != y).sum())} rays")
    return ab_ms(new, parent_fn=old)


def live_share(args, share, seed=5):
    """`args` of a K1 query with every ray's window emptied (t_max -1)
    but a scattered `share` of those that are live."""
    t_min, t_max = args[3], args[4]
    live = torch.nonzero(t_max > t_min).flatten()
    g = torch.Generator(device="cpu").manual_seed(seed)
    keep = live[torch.randperm(live.numel(), generator=g)[
        :int(round(share * live.numel()))].to(live.device)]
    out = torch.full_like(t_max, -1.0)
    out[keep] = t_max[keep]
    return args[:4] + [out, args[5]]


def fmt_ab(parent, new, bound_ms, digits=3):
    """`parent X new Y ms, bound Z (share S)` for a line of a phase."""
    head = "" if parent is None else f"parent {parent:.{digits}f} / "
    return (f"{head}kernel {new:.{digits}f} ms, bound {bound_ms:.4f} ms "
            f"(share {bound_ms / new:.3f})")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 bound_ms, bound_by, parent_ms=None):
    """One kernel of the kernels line.  No single PyTorch call computes
    K1-K4's or the probes' functions, so library_ms is null here; phase
    22 sets K5's."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / ms,
            "library_ms": None, "parent_ms": parent_ms}


def k1_bound(args, any_hit):
    """Bound of one K1 query: every live ray (t_max > t_min) tests every
    row for a closest hit; an any-hit ray needs the rows up to its first
    accepted one (all M where it has none)."""
    pack, ro, rd, t_min, t_max, exclude = args
    m = pack.shape[0]
    live = t_max > t_min
    if any_hit:
        tests = int(first_rows(*args)[live].sum())
    else:
        tests = int(live.sum()) * m
    return bound(tests * ROW_FLOPS,
                 nbytes(pack) + ro.shape[0] * (RAY_BYTES + 16))


def first_rows(pack, ro, rd, t_min, t_max, exclude, chunk=1 << 14):
    """Per ray, the rows a sweep in row order tests up to and including
    its first accepted one (M where none is accepted): K1's function as
    flat_plain writes it, kept as a [r, M] plane per chunk of rays."""
    m = pack.shape[0]
    out = torch.full((ro.shape[0],), m, dtype=torch.int64, device=ro.device)
    if m == 0:
        return out
    (nx, ny, nz, d, b0, bvx, bvy, bvz, g0, gvx, gvy, gvz,
     glass) = pack.unbind(1)
    ids = torch.arange(m, device=ro.device)
    for s in range(0, ro.shape[0], chunk):
        e = min(ro.shape[0], s + chunk)
        ox, oy, oz = (c[:, None] for c in ro[s:e].unbind(1))
        dx, dy, dz = (c[:, None] for c in rd[s:e].unbind(1))
        rddn = dx * nx + dy * ny + dz * nz
        safe = rddn.abs() > 1e-9
        t = -(ox * nx + oy * ny + oz * nz + d) / torch.where(safe, rddn, 1.0)
        beta = (b0 + ox * bvx + oy * bvy + oz * bvz
                + t * (dx * bvx + dy * bvy + dz * bvz))
        gamma = (g0 + ox * gvx + oy * gvy + oz * gvz
                 + t * (dx * gvx + dy * gvy + dz * gvz))
        ok = (safe & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1)
              & (t > t_min[s:e, None]) & (t < t_max[s:e, None])
              & ~(glass > 0.5) & (ids != exclude[s:e, None]))
        first = torch.where(ok, ids, m).amin(dim=1)
        out[s:e] = torch.where(first < m, first + 1, m)
    return out


def k2_bound(cl, r, nodes, leaves):
    """Bound of one K2 query from its per-ray counters: a slab test per
    node, a row test per slot of each swept chunk (an any-hit sweep that
    stops inside a chunk is counted whole); bytes: the rays, the outputs
    and the chunk tree's tables."""
    csz = cl.chunk_halves * tclusters.HALF
    flops = (int(nodes.sum()) * SLAB_FLOPS
             + int(leaves.sum()) * csz * ROW_FLOPS)
    return bound(flops, r * (RAY_BYTES + 8) + nbytes(
        cl.boxes_q, cl.leaf_bits, cl.links, cl.pack))


def k3_bound(cl, r, K, nodes):
    """Bound of one K3 query: a slab test per node; bytes: the rays, the
    [R, K] lists, counts and skipmin, the tables of the walk."""
    return bound(int(nodes.sum()) * SLAB_FLOPS,
                 r * (RAY_BYTES - 4 + 4 * K + 8)
                 + nbytes(cl.boxes_q, cl.leaf_bits, cl.links))


def k4_bound(cl, r, cid):
    """Bound of one K4 query: a row test per slot of each listed pair's
    chunk; bytes: the pairs in and out, the rays, the listed chunks."""
    csz = cl.chunk_halves * tclusters.HALF
    listed = cid[cid != bi.SENT]
    chunks = int(torch.unique(listed).numel())
    return bound(int(listed.numel()) * csz * ROW_FLOPS,
                 cid.numel() * 16 + r * RAY_BYTES + chunks * csz * 16 * 4)


def clocks():
    """The card's SM clock, its maximum, power draw and temperature just
    after a timing (nvidia-smi), to read the times beside it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and \
        smi.stdout.strip() else "not read"
    return f"card: {line} (SM clock, max, power, C)"


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"[1/24 device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}")


def phase_build(parent_csrc=None):
    """Builds this tree's kernels and, with --parent, the earlier
    version's from `parent_csrc` (the same entry points), which the
    later phases time in turns with this tree's."""
    global PARENT
    for who, csrc in (("", None), ("parent ", parent_csrc)):
        if who and csrc is None:
            continue
        t0 = time.perf_counter()
        if who:
            info = kernels._build_from(csrc)
            lib = kernels._open(info["path"])
        else:
            info, lib = kernels.build(), kernels.load()
        secs = time.perf_counter() - t0
        print(f"[2/24 build] {who}{os.path.relpath(info['path'], ROOT)} "
              f"nvcc {info['seconds']:.3f} s, build+load {secs:.3f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    {who}ptxas: {line.strip()}")
        if who:
            PARENT = lib


def random_soup(n_tris, seed, glass_every=97):
    """-> (vertices f32 [3n, 3], tri_vidx i32 [n, 3], tri_pack [n, 13])."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n_tris, 3))
    verts = (centers[:, None, :]
             + rng.normal(0, 0.6, (n_tris, 3, 3))).reshape(-1, 3)
    verts = verts.astype(np.float32)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    pack = np.zeros((n_tris, 13), np.float32)
    pack[:, :12] = build_tri_pack(verts, tris)
    pack[::glass_every, 12] = 1.0  # thin glass, which never blocks
    return verts, tris, pack


def random_rays(n_rays, seed, dev):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = rng.uniform(4.0, 30.0, n_rays).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, t_max)]


def phase_k1(dev):
    t_phase = time.perf_counter()
    n_tris, n_rays = K1_SOUP
    pack = torch.from_numpy(random_soup(n_tris, seed=1)[2]).to(dev)
    ro, rd, t_max = random_rays(n_rays, seed=1, dev=dev)
    none = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    window = [pack, ro, rd, torch.full_like(t_max, 0.5), t_max, none]
    k, agree1, err1 = compare(window, any_hit=False)
    hits = k[1] >= 0
    check(0.05 < hits.double().mean().item() < 0.95,
          "the soup's hit rate is degenerate")
    check(bool(((k[0][hits] > 0.5) & (k[0][hits] < t_max[hits])).all()),
          "a closest hit lies outside its t window")
    check(not bool((pack[k[1][hits].long(), 12] > 0.5).any()),
          "a thin-glass row won a closest hit")

    # The exclude pass keeps the window: near t = 0 the plane distance
    # cancels, and t carries an absolute error that no rtol bounds.
    excl = k[1].contiguous()
    k2, agree2, err2 = compare(window[:5] + [excl], any_hit=False)
    check(not bool(((k2[1] == excl) & (excl >= 0)).any()),
          "an excluded triangle id was returned")

    _, agree3, _ = compare(window, any_hit=True)
    times = []
    for m in (False, True):
        parent, new = k1_ab(window, m)
        plain = median_ms(lambda: fi.flat_plain(*window, any_hit=m),
                          runs=PLAIN_RUNS, warmup=False)
        times.append(f"{'any' if m else 'closest'} "
                     f"{fmt_ab(parent, new, k1_bound(window, m)[0])}, "
                     f"plain {plain:.3f}")
    print(f"[3/24 K1 {n_tris} tris x {n_rays} rays] closest agree "
          f"{agree1:.6f} (excl pass {agree2:.6f}) max|err| "
          f"{max(err1, err2):.3g}; any-hit agree {agree3:.6f}; median ms "
          + "; ".join(times) + f" (plain over {PLAIN_RUNS} runs); "
          f"{clocks()} ({time.perf_counter() - t_phase:.1f} s)")


def phase_k2(dev):
    """-> {layout: ClusterArrays} of the soup, for phase 9."""
    t_phase = time.perf_counter()
    n_tris, n_rays = K2_SOUP
    verts, tris, pack = random_soup(n_tris, seed=2)
    tri_pack = torch.from_numpy(pack).to(dev)
    ro, rd, t_max = random_rays(n_rays, seed=2, dev=dev)
    t_max = torch.where(torch.arange(n_rays, device=dev) % 3 == 0, -1.0,
                        t_max)
    t_min = torch.full_like(t_max, 0.5)
    none = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    trees = {}
    for layout, cap, want_halves in K2_LAYOUTS:
        saved = tclusters.CHUNK_CAP
        if cap is not None:
            tclusters.CHUNK_CAP = cap
        try:
            t0 = time.perf_counter()
            cl = tclusters.build_clusters(verts, tris, pack, device=dev)
            build_s = time.perf_counter() - t0
        finally:
            tclusters.CHUNK_CAP = saved
        halves = cl.chunk_halves
        check(halves == want_halves, f"{layout}: chunk_halves {halves}")
        trees[layout] = cl
        _, *srt = ci.sort_rays(cl, ro, rd, t_min, t_max, none)
        args = [cl, *srt]
        k, s1, err1 = compare_k2(args, False, tri_pack)
        hits = k[1] >= 0
        check(0.05 < hits.double().mean().item() < 0.95,
              f"{layout}: the soup's hit rate is degenerate")
        check(not bool(torch.from_numpy(pack[:, 12] > 0.5).to(dev)[
            k[1][hits].long()].any()), "a thin-glass row won a closest hit")
        excl = k[1].contiguous()
        k2, s2, err2 = compare_k2(args[:5] + [excl], False, tri_pack)
        check(not bool(((k2[1] == excl) & (excl >= 0)).any()),
              "an excluded triangle id was returned")
        k3, s3, _ = compare_k2(args, True, tri_pack)
        times = []
        for m, kk in ((False, k), (True, k3)):
            parent, new = ab_ms(lambda: ci.traverse(*args, any_hit=m))
            plain = median_ms(lambda: ci.cluster_plain(*args, any_hit=m),
                              runs=PLAIN_RUNS, warmup=False)
            b = k2_bound(cl, n_rays, kk[2], kk[3])[0]
            times.append(f"{'any' if m else 'closest'} "
                         f"{fmt_ab(parent, new, b)}, plain {plain:.3f}")
        tpc = max(1, halves // 2)
        print(f"[4/24 K2 {n_tris} tris x {n_rays} rays, {layout}: "
              f"chunk_halves {halves}, tpc {tpc}, "
              f"{cl.boxes_q.shape[0] // 3} nodes, host build {build_s:.3f} s]"
              f" closest agree {s1['agree']:.6f} (excl pass "
              f"{s2['agree']:.6f}), reported max|err| {max(err1, err2):.3g},"
              f" in-kernel t within rtol on {s1['raw_t_agree']:.6f}/"
              f"{s2['raw_t_agree']:.6f} of hits (max|t err| "
              f"{max(s1['raw_t_err'], s2['raw_t_err']):.3g}); any "
              f"agree {s3['agree']:.6f}; counters equal {s1['counters_equal']:.6f}"
              f"/{s3['counters_equal']:.6f}; nodes/ray closest "
              f"{s1['nodes_mean']:.1f} (max {s1['nodes_max']}), leaves "
              f"{s1['leaves_mean']:.2f} (max {s1['leaves_max']}); median ms "
              + "; ".join(times) + f" (plain over {PLAIN_RUNS} runs)")
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return trees


def write_box(d, res, ms, **overrides):
    cfg = scene_dict(res=res, ms=ms, reverse=0)
    cfg.update(overrides)
    verts, nrms, faces = mb.make_sphere(3900, 0.0, 0.9, 0.6, 0.6)
    mb._write_obj(os.path.join(d, "sphere.obj"), verts, nrms, faces)
    cfg["scene"].append({"file": "sphere.obj", "material": "white"})
    path = os.path.join(d, f"box_sphere_{res}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def stone_texture(n=512):
    """make_bigscene.make_stone_texture's image, as the texture loader
    decodes its PNG: 8-bit sRGB values gamma-decoded to linear."""
    rng = np.random.default_rng(7)
    img = np.zeros((n, n))
    for octave in range(4):
        k = 8 << octave
        coarse = rng.standard_normal((k, k))
        img += np.kron(coarse, np.ones((n // k, n // k))) / (1.6 ** octave)
    img = (img - img.min()) / (img.max() - img.min())
    line = ((np.arange(n) % 64) < 3).astype(float)
    mortar = np.maximum(line[None, :], line[:, None])
    base = 0.45 + 0.35 * img
    rgb = np.stack([base * 1.02, base * 0.98, base * 0.92], axis=-1)
    rgb = rgb * (1.0 - 0.45 * mortar[..., None])
    u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return gamma_decode(u8.astype(np.float32) / 255.0)


def write_colonnade(d, n_tris, **overrides):
    """make_bigscene.generate(d, n_tris) without PIL: the same OBJs and
    config, the stone texture as EXR.  Returns (config path, triangles)."""
    os.makedirs(d, exist_ok=True)
    gn = max(64, int(np.sqrt(0.30 * n_tris / 2 / 2.5)))
    gv, gnrm, gf, guv = mb.make_ground(gn)
    per_col = int(0.55 * n_tris / 12)
    nh = max(8, int(np.sqrt(per_col / 2 / 2.6)))
    ntheta = max(12, per_col // (2 * max(nh - 1, 1)))
    columns = mb._merge([mb.make_column(ntheta, nh, x, -15.0 + 6.0 * i)
                         for i in range(6) for x in (-3.2, 3.2)])
    per_s = int(0.15 * n_tris / 3)
    spheres = mb._merge([
        mb.make_sphere(per_s, 0.0, 1.2, -9.0, 1.2),
        mb.make_sphere(per_s, -1.5, 0.9, -1.0, 0.9),
        mb.make_sphere(per_s, 1.6, 1.0, 7.0, 1.0),
    ])
    mb._write_obj(os.path.join(d, "ground.obj"), gv, gnrm, gf, uvs=guv)
    total = len(gf)
    for name, (v, n, f) in (("columns.obj", columns),
                            ("spheres.obj", spheres),
                            ("panels.obj", mb.make_panels())):
        mb._write_obj(os.path.join(d, name), v, n, f)
        total += len(f)
    write_exr(os.path.join(d, "stone.exr"), stone_texture())
    cfg = copy.deepcopy(mb.CONFIG)
    cfg["materials"][0]["diffuse-texture"] = "stone.exr"
    cfg.update(overrides)
    path = os.path.join(d, "colonnade.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, total


def render(cfg_path, out_dir, *extra):
    check(cli.main([cfg_path, "-q", "-D", out_dir, *extra]) == 0,
          f"the CLI failed on {cfg_path}")
    with open(cfg_path) as f:
        name = json.load(f)["output-file"]
    img = read_exr(os.path.join(out_dir, name))
    with np.load(os.path.join(out_dir, name + ".ckpt.npz")) as ck:
        rays = int(ck["rays"])
    return img, rays


def load_scene(cfg_path, dev=CUDA):
    """-> (settings, scene, meta, camera) of `cfg_path` on `dev`, as the
    CLI builds them (the camera moved to `dev`, as the driver moves it)."""
    cfg = tconfig.load_config(cfg_path)
    arrays, meta, _ = tconfig.build_scene(cfg, dev)
    cam = cfg.get_camera()
    cfg.post_check()
    return cfg.settings, arrays, meta, cam.to(dev)


class EagerDriver(RenderDriver):
    """The CLI's driver with every block traced by the eager queued loop
    (`path.*_eager`: the step loop driven from the host, one sync an
    iteration, no graph): for the card renders whose instruments see
    every ray query (phase 8), and the route phase 20 holds the graphs
    against."""

    def render_round(self, round_idx, monitor=None):
        tracer = (tpath.trace_wavefront_queued_bdpt_eager if self.bdpt
                  else tpath.trace_wavefront_queued_eager)
        for px, py, pix_idx in zip(self._px, self._py, self._pix_idx):
            out = tracer(self.scene, self.meta, self.settings, self.camera,
                         px, py, round_idx * self.ms, self.ms, self.seed,
                         self.sampler_mode)
            self._acc_dev.index_add_(0, pix_idx, out[0])
            if self.bdpt:
                self._acc_dev += out[1]
            self._rays_dev += out[-1]
        self._lanes_done += self._local_lanes
        self.stats.lanes = self._lanes_done
        self.stats.rounds += 1


class HostReadGraph(tgraph.QueuedGraph):
    """The queued loop as it ran before the WHILE node, for phase 20's
    comparison and the card tests: the captured step replayed `k` times
    between two host reads of the end test, one sync each.  The step
    also writes the flag and a count of the steps that found the loop
    live into one int64 [2] device buffer, read together, so a block's
    `iterations` (and `overshoot`) cost no sync of their own."""

    def __init__(self, *args, k: int, **kw):
        if int(k) < 1:
            raise ValueError(f"k must be at least 1, got {k}")
        self.k = int(k)
        super().__init__(*args, **kw)

    def _graphs_for(self, seed):
        self.flags = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._build(lambda: self._warm(seed),
                    ([("light", self._light)] if self.bdpt else [])
                    + [("step", self._step)])

    def _step(self):
        self.flags[1].add_(self.live)
        super()._step()
        self.flags[0].copy_(self.live)

    def block(self, px, py, sample0, seed, cam):
        with torch.no_grad(), self._device():
            self._load(px, py, sample0, seed, cam)
            self.flags.zero_()
            if self.bdpt:
                self._replay("light")
            n = reads = 0
            live = True
            while live:
                self._replay("step", self.k)
                n += self.k
                reads += 1
                live, work = self.flags.tolist()  # the end test: one sync
        tgraph._bump(blocks=1, steps=n, replays=n, flag_reads=reads,
                     iterations=work, light_replays=int(self.bdpt))


def make_driver(scene, eager=False):
    """The CLI's driver (seed 42, halton, blocks of 2^20 lanes) on a
    `load_scene` scene, or its EagerDriver."""
    s, arrays, meta, cam = scene
    return (EagerDriver if eager else RenderDriver)(
        s, arrays, meta, cam, seed=42, sampler_mode=smp.MODE_HALTON)


def render_eager(cfg_path, out_dir):
    """`render` through EagerDriver on the card: the CLI's EXR and
    checkpoint, written by the same driver code.  -> (image, rays)."""
    scene = load_scene(cfg_path)
    drv = make_driver(scene, eager=True)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, os.path.basename(scene[0].output_file))
    drv.render_frame(out_path)
    return read_exr(out_path), drv.stats.rays


class FirstCalls:
    """Wraps `module.name`: counts its calls (`n`), keeps a copy of the
    arguments of the first closest-hit and any-hit call (a call without
    `any_hit` counts as closest), to replay them at the render's shapes,
    and the host time of the first call.  On the card a render's queued
    loop calls it in the graph runner's eager warm-up (the frame's first
    pixels and samples, the render's seed: its first block's queries)
    and while capturing; a replay does not call it, so `n` counts
    neither iterations nor launches there."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.args, self.first_t, self.n = {}, None, 0
        self._orig = getattr(module, name)

    def __call__(self, *args, **kw):
        any_hit = kw.get("any_hit", False)
        self.n += 1
        if self.first_t is None:
            self.first_t = time.perf_counter()
        if (any_hit not in self.args
                and not torch.cuda.is_current_stream_capturing()):
            self.args[any_hit] = [a.detach().clone()
                                  if isinstance(a, torch.Tensor)
                                  else a for a in args]
        return self._orig(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


class GatherCalls(FirstCalls):
    """Wraps `vm.take_rows`: keeps a copy of the table and the ids, flat
    int32 as K5 takes them, of the first call for each table width that
    K5 serves (at most MATMUL_GATHER_MAX_ROWS rows), outside captures:
    phase 16's material pack (20 columns), point pack (8) and areal-light
    rows (15)."""

    def __call__(self, table, idx):
        self.n += 1
        if (table.shape[0] <= vm.MATMUL_GATHER_MAX_ROWS
                and table.shape[1] not in self.args
                and not torch.cuda.is_current_stream_capturing()):
            self.args[table.shape[1]] = (
                table.detach().clone(),
                idx.detach().reshape(-1).to(torch.int32).clone())
        return self._orig(table, idx)


def graph_line():
    """The queued-loop runners' counters since the last reset_launches():
    what a render's blocks did as CUDA graphs with a WHILE node."""
    st = tgraph.read_stats()
    return (f"queued loop as CUDA graphs: {st['runners']} runner(s), "
            f"{st['captures']} graphs captured in {st['capture_ms']:.1f} ms, "
            f"graph pool {st['pool_bytes'] / 2**20:.1f} MiB, max memory "
            f"allocated {st['peak_before'] / 2**30:.3f} -> "
            f"{st['peak_after'] / 2**30:.3f} GiB across the capture; "
            f"{st['blocks']} blocks, {st['while_launches']} WHILE-graph "
            f"launches, {st['iterations']} iterations, {st['replays']} "
            f"steps run + {st['warmup_steps']} warm-up steps "
            f"({st['overshoot']} past the end), {st['setter_runs']} "
            f"condition-setter runs, {st['light_replays']} light phases, "
            f"{st['flag_reads']} end-test reads on the host")


def profiled_round(cfg_path, out_dir, module, name, kernels_, binned=None):
    """With --profile: one more CLI render of `cfg_path`
    (with RGK_BINNED=`binned` when given) under torch.profiler (card
    activity only), the round timed from the first call of `module.name`
    (in the graph runner's warm-up, so the capture counts) to the EXR on
    the host clock.  Prints the device ms of every kernel
    event, of those whose name holds each of `kernels_` (K1 and K2 per
    variant), the busy share, kernel ms over the round (the tracing
    slows the host, so the share reads low), and the kernels run per
    iteration of the queued loop.  -> a dict of those numbers, or None."""
    if not PROFILE:
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    tgraph.reset_stats()
    with binned_mode(binned) if binned else contextlib.nullcontext(), \
            FirstCalls(module, name) as first, profile(
                activities=[ProfilerActivity.CUDA]) as prof:
        render(cfg_path, out_dir)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    iterations = tgraph.read_stats()["iterations"]
    round_ms = (t1 - first.first_t) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    total = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    mine = {}
    for e in kern:
        for kernel in kernels_:
            if kernel not in e.name:
                continue
            key = kernel
            if kernel in ("flat_sweep", "cluster_walk"):
                # The any-hit variant, demangled or not.
                key += (" any" if ("<true>" in e.name or "ILb1E" in e.name)
                        else " closest")
            n, ms = mine.get(key, (0, 0.0))
            mine[key] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    if not kern:
        print("    profiled round: the profiler recorded no kernel; busy "
              "share not measured")
        return None
    per_iter = len(kern) / max(iterations, 1)
    print(f"    profiled round{f' (RGK_BINNED={binned})' if binned else ''}"
          f" (torch.profiler): round {round_ms:.3f} ms, "
          f"{len(kern)} kernels {total:.3f} ms, busy {total / round_ms:.4f}, "
          f"{iterations} iterations, {per_iter:.1f} kernels an iteration; "
          + ", ".join(f"{k} {n} launches {ms:.3f} ms"
                      for k, (n, ms) in sorted(mine.items())))
    return {"round_ms": round_ms, "kernels": len(kern), "kernel_ms": total,
            "busy": total / round_ms, "iterations": iterations,
            "per_iteration": per_iter, "by_kernel": mine}


def phase_render(d):
    t_phase = time.perf_counter()
    res, ms = FLAT_RES, FLAT_MS
    path = write_box(d, res=res, ms=ms)
    out_dir = os.path.join(d, "render")
    reset_launches()
    with FirstCalls(isect, "intersect_flat") as first:
        t0 = time.perf_counter()
        img, rays = render(path, out_dir)
        wall = time.perf_counter() - t0
    launches, k2 = launched(fi), launched(ci)
    k5 = render_k5()
    check(img.shape == (res, res, 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "the image has non-finite pixels")
    check(float(img.mean()) > 0.0, "the image is black")
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the render did not go through K1: launches {launches}")
    check(k2 == {"closest": 0, "any": 0}, f"a flat scene launched K2: {k2}")
    check_k5_render(k5, "the render")
    n_tris = first.args[False][0].shape[0]
    check(n_tris == 3870, f"scene has {n_tris} triangles, not 3870")
    print(f"[5/24 flat render {res}x{res} {ms}spp {n_tris} tris] wall "
          f"{wall:.3f} s, "
          f"{rays} extension rays, {rays / wall:.1f} rays/s, K1 launches "
          f"{launches}, K5 launches {k5}, image mean "
          f"{float(img.mean()):.5f}")
    print(f"    {graph_line()}")

    # The render's first queries as they are (the closest one fully
    # live), then with the windows of all but a scattered LIVE_SHARES of
    # their live rays emptied, as the queued loop's straggler tail asks.
    entries = []
    for any_hit in (False, True):
        mode = "any" if any_hit else "closest"
        for share in (None,) + LIVE_SHARES:
            args = first.args[any_hit]
            if share is not None:
                args = live_share(args, share)
            _, agree, err = compare(args, any_hit)
            parent, kms = k1_ab(args, any_hit)
            pms = median_ms(lambda: fi.flat_plain(*args, any_hit=any_hit),
                            runs=PLAIN_RUNS, warmup=False)
            bms, by = k1_bound(args, any_hit)
            live = int((args[4] > args[3]).sum())
            print(f"    K1 {mode} at the render's shapes ({args[1].shape[0]}"
                  f" rays, {live} live, x {n_tris} tris): agree "
                  f"{agree:.6f} max|err| {err:.3g}, median ms "
                  f"{fmt_ab(parent, kms, bms)} by {by}, plain {pms:.3f} "
                  f"(over {PLAIN_RUNS} runs); {clocks()}")
            name = f"flat_intersect_{mode}" + (
                "" if share is None else f"_live{round(share * 100)}")
            entries.append(kernel_entry(
                name, K1_SOURCE, K1_REPLACES,
                launches[mode] if share is None else None, err, kms, pms,
                bms, by, parent))
    profiled_round(path, os.path.join(d, "render_prof"), isect,
                   "intersect_flat", ("flat_sweep",))
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return entries, k5


def phase_cpu_parity(d):
    t_phase = time.perf_counter()
    path = write_box(d, res=64, ms=4, **{"recursion-max": 3})
    gpu, _ = render(path, os.path.join(d, "gpu64"))
    cpu, _ = render(path, os.path.join(d, "cpu64"), "--cpu")
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"card vs CPU image parity failed: {stats}")
    print(f"[6/24 flat card vs CPU 64x64 4spp depth 3] corr {stats['corr']:.6f}"
          f" trimmed {stats['corr_trim']:.6f} mean rel diff "
          f"{stats['mean_rel_diff']:.3g} max|diff| {stats['max_abs_diff']:.3g}"
          f" outlier pixels {stats['outlier_pixels']}, max per tile "
          f"{stats['max_outliers_per_tile']} (cap {stats['tile_cap']}) "
          f"({time.perf_counter() - t_phase:.1f} s)")


def phase_colonnade(d):
    t_phase = time.perf_counter()
    res = COLONNADE_RES
    t0 = time.perf_counter()
    path, n_tris = write_colonnade(
        os.path.join(d, "colonnade"), COLONNADE_BUDGET,
        **{"multisample": COLONNADE_MS, "output-width": res[0],
           "output-height": res[1]})
    gen_s = time.perf_counter() - t0
    check(n_tris == COLONNADE_TRIS, f"colonnade of {n_tris} triangles")
    with open(path) as f:
        check(json.load(f)["recursion-max"] == 2, "colonnade depth")
    print(f"    colonnade: {n_tris} triangles, {res[0]}x{res[1]}, depth 2, "
          f"multisample cut from {mb.CONFIG['multisample']} to "
          f"{COLONNADE_MS}; OBJ + texture written in {gen_s:.3f} s")

    built = []
    build_scene = cli.build_scene

    def keep_builder(*a, **kw):
        out = build_scene(*a, **kw)
        built.append(out)
        return out

    out_dir = os.path.join(d, "colonnade_out")
    reset_launches()
    cli.build_scene = keep_builder
    try:
        with FirstCalls(ci, "traverse") as first:
            t0 = time.perf_counter()
            img, rays = render(path, out_dir)
            t1 = time.perf_counter()
    finally:
        cli.build_scene = build_scene
    launches, k1 = launched(ci), launched(fi)
    k5 = render_k5()
    check(img.shape == (res[1], res[0], 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "the image has non-finite pixels")
    check(float(img.mean()) > 0.0, "the image is black")
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the render did not go through K2: launches {launches}")
    check(k1 == {"closest": 0, "any": 0}, f"the colonnade launched K1: {k1}")
    check_k5_render(k5, "the colonnade")
    arrays, _, builder = built[0]
    check(builder.sah_builder == "native",
          f"SAH builder {builder.sah_builder}")
    host = builder.timings
    round_s = t1 - first.first_t
    print(f"[7/24 colonnade {res[0]}x{res[1]} {COLONNADE_MS}spp depth 2 "
          f"{n_tris} tris]"
          f" CLI wall {t1 - t0:.3f} s, of which host build "
          f"{sum(host.values()):.3f} s ({builder.sah_builder} SAH builder: "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
          + f"); round (first query to EXR) {round_s:.3f} s, {rays} "
          f"extension rays, {rays / round_s:.1f} rays/s; K2 launches "
          f"{launches}, K5 launches {k5}; image mean "
          f"{float(img.mean()):.5f}")
    print(f"    {graph_line()}")

    entries = []
    for any_hit in (False, True):
        args = first.args[any_hit]
        kout, st, err = compare_k2(args, any_hit, arrays.tri_pack)
        print(f"    K2 {'any' if any_hit else 'closest'} SIMD efficiency "
              f"(mean/max per {WARP} sorted rays, averaged over warps): "
              f"leaves {simd_efficiency(kout[3]):.4f}, nodes "
              f"{simd_efficiency(kout[2]):.4f}")
        parent, kms = ab_ms(lambda: ci.traverse(*args, any_hit=any_hit))
        pms = median_ms(lambda: ci.cluster_plain(*args, any_hit=any_hit),
                        runs=PLAIN_RUNS, warmup=False)
        bms, by = k2_bound(args[0], args[1].shape[0], kout[2], kout[3])
        mode = "any" if any_hit else "closest"
        live = int((args[4] > args[3]).sum())
        print(f"    K2 {mode} at the render's shapes ({args[1].shape[0]} "
              f"rays, {live} with a non-empty interval, x {n_tris} tris): "
              f"agree {st['agree']:.6f}, reported max|err| {err:.3g}, "
              f"in-kernel t within rtol on {st['raw_t_agree']:.6f} of hits "
              f"(max|t err| {st['raw_t_err']:.3g}), hit rate "
              f"{st['hit_rate']:.4f}; per ray nodes {st['nodes_mean']:.1f} "
              f"(max {st['nodes_max']}), leaves {st['leaves_mean']:.2f} (max "
              f"{st['leaves_max']}), counters equal {st['counters_equal']:.6f};"
              f" median ms {fmt_ab(parent, kms, bms)} by {by}, plain "
              f"{pms:.3f} (plain over {PLAIN_RUNS} runs); {clocks()}")
        # The kernel's own output: in-kernel t (closest), validity (any).
        entries.append(kernel_entry(
            f"cluster_intersect_{mode}", K2_SOURCE, K2_REPLACES,
            launches[mode], err if any_hit else st["raw_t_err"], kms, pms,
            bms, by, parent))
    profiled_round(path, os.path.join(d, "colonnade_prof"), ci, "traverse",
                   ("cluster_walk",))
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return entries, path, img, k5


@contextlib.contextmanager
def plain_k2():
    """Inside the block, `cluster_intersect.traverse` runs the plain
    version `cluster_plain` on the card instead of launching K2."""
    saved = ci.traverse

    def traverse(cl, ro, rd, t_min, t_max, exclude, any_hit=False,
                 stats=False):
        return ci.cluster_plain(cl, ro, rd, t_min, t_max, exclude,
                                any_hit=any_hit, stats=stats)

    ci.traverse = traverse
    try:
        yield
    finally:
        ci.traverse = saved


class QueryLog:
    """Records, inside the block, every ray query the integrator makes
    (through `intersect.make_intersector`): its rays and the ids it
    returned, on the host, in call order."""

    def __init__(self):
        self.queries, self._orig = [], None

    def __enter__(self):
        self._orig = isect.make_intersector

        def make(meta):
            fn = self._orig(meta)

            def logged(scene, ro, rd, t_min, t_max, exclude=None,
                       any_hit=False):
                hit = fn(scene, ro, rd, t_min, t_max, exclude=exclude,
                         any_hit=any_hit)
                self.queries.append((any_hit, ro.cpu(), rd.cpu(),
                                     hit.tri.cpu()))
                return hit
            return logged

        isect.make_intersector = make
        return self

    def __exit__(self, *exc):
        isect.make_intersector = self._orig


def where_they_part(a, b):
    """Two renders' query logs (card, CPU) compared query by query: the
    first query whose rays differ anywhere, the largest difference of
    its rays in float32 ulps of each value, and over the queries both
    made, the lanes whose rays differ and the lanes whose rays are equal
    but whose answers differ (those the intersection route decides: the
    id of a closest hit, hit or miss of an any hit)."""
    first, ulps, moved, flipped, n = None, 0, 0, 0, min(len(a), len(b))
    for i, ((any_a, ro_a, rd_a, tri_a), (_, ro_b, rd_b, tri_b)) in \
            enumerate(zip(a, b)):
        if ro_a.shape != ro_b.shape:
            n = i
            break
        same_in = ((ro_a == ro_b) & (rd_a == rd_b)).all(dim=1)
        moved += int((~same_in).sum())
        # Any hit: K2 answers with a witness id, intersect_bvh with the
        # triangle it met; only hit or miss is the query's answer.
        out_a, out_b = (tri_a >= 0, tri_b >= 0) if any_a else (tri_a, tri_b)
        flipped += int((same_in & (out_a != out_b)).sum())
        if first is None and not bool(same_in.all()):
            d = torch.cat([ro_a - ro_b, rd_a - rd_b], dim=1).abs()
            scale = torch.cat([ro_b, rd_b], dim=1).abs().clamp(min=1e-30)
            ulps = float((d / (scale * 2.0 ** -23)).max())
            first = (i, "any" if any_a else "closest", int((~same_in).sum()),
                     ro_a.shape[0])
    return {"queries": (len(a), len(b), n), "first": first, "ulps": ulps,
            "moved": moved, "flipped": flipped}


def camera_rays_apart(path, dev):
    """Where the card's and the CPU's first queries part: for sample 0 of
    every pixel of `path`'s image, the lanes whose pixel jitter (the
    sampler) differs bit for bit between the card and the CPU, the lanes
    whose camera rays differ when both start from the same jitter, and
    the share of float32 values x for which x / yres on the card differs
    from the CPU's (a tensor divided by a Python number).  -> a line."""
    from rgk_tpu_torch.ops import sampler as smp
    from rgk_tpu_torch.scene import config as tconfig
    from rgk_tpu_torch.scene.camera import pixel_rays

    cfg = tconfig.load_config(path)
    cam = cfg.get_camera()
    pix = torch.arange(cam.xres * cam.yres)
    px, py = (pix % cam.xres).to(torch.int32), (pix // cam.xres).to(
        torch.int32)
    out = {}
    for where in ("cpu", dev):
        ctx = smp.SampleCtx(seed=42, pixel=pix.to(where),
                            sample=torch.zeros_like(pix).to(where),
                            n_set=int(cfg.settings.multisample))
        out[str(where)] = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER).cpu()
    jit = out["cpu"]
    jitter_apart = int((out["cpu"] != out[str(dev)]).any(dim=1).sum())
    rays = [torch.cat(pixel_rays(cam.to(w), px.to(w), py.to(w), jit.to(w)),
                      dim=1).cpu() for w in ("cpu", dev)]
    rays_apart = int((rays[0] != rays[1]).any(dim=1).sum())
    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(1)) * 64
    div_apart = ((x.to(dev) / cam.yres).cpu() != x / cam.yres).double()
    return (f"sample 0 of {pix.numel()} pixels: jitter differs on "
            f"{jitter_apart} lanes, camera rays from the same jitter on "
            f"{rays_apart}; x / {cam.yres} differs from the CPU's on "
            f"{div_apart.mean().item():.4f} of 2^20 values")


def fmt_parity(stats):
    return (f"corr {stats['corr']:.6f} trimmed {stats['corr_trim']:.6f} "
            f"mean rel diff {stats['mean_rel_diff']:.3g} max|diff| "
            f"{stats['max_abs_diff']:.3g} outlier pixels "
            f"{stats['outlier_pixels']}, max per tile "
            f"{stats['max_outliers_per_tile']} (cap {stats['tile_cap']})")


def phase_colonnade_parity(d):
    """-> (config path, the port's CPU image), for phase 11.  The third
    image, on the card with K2's plain version, splits the card's
    outliers against the CPU image into those of K2's arithmetic (card
    against card-plain) and those of the shading ops on the card
    (card-plain against the CPU)."""
    t_phase = time.perf_counter()
    path, n_tris = write_colonnade(
        os.path.join(d, "colonnade_small"), 20000,
        **{"output-width": 64, "output-height": 36, "multisample": 4})
    check(n_tris == 33960, f"small colonnade of {n_tris} triangles")
    reset_launches()
    with QueryLog() as log_gpu:
        gpu, _ = render_eager(path, os.path.join(d, "col_gpu"))
    check(ci.launches["closest"] > 0 and fi.launches["closest"] == 0,
          f"the small colonnade did not go through K2: {ci.launches}")
    graph_img, _ = render(path, os.path.join(d, "col_gpu_graph"))
    check(np.array_equal(graph_img, gpu), "the CLI's image (CUDA graphs) "
          "differs from the eager loop's")
    with QueryLog() as log_cpu:
        cpu, _ = render(path, os.path.join(d, "col_cpu"), "--cpu")
    part = where_they_part(log_gpu.queries, log_cpu.queries)
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"colonnade card vs CPU image parity failed: {stats}")
    reset_launches()
    with plain_k2():
        gpu_plain, _ = render_eager(path, os.path.join(d, "col_gpu_plain"))
    check(ci.launches == {"closest": 0, "any": 0},
          f"the plain-K2 card render launched K2: {ci.launches}")
    print(f"[8/24 colonnade card vs CPU {n_tris} tris 64x36 4spp depth 2] "
          f"card (eager loop; the CLI's CUDA-graph image equal bit for "
          f"bit) vs CPU: "
          f"{fmt_parity(stats)}; card with cluster_plain vs CPU: "
          f"{fmt_parity(image_parity(gpu_plain, cpu))}; card K2 vs card "
          f"cluster_plain: {fmt_parity(image_parity(gpu, gpu_plain))} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    q = part["queries"]
    first = ("none" if part["first"] is None else
             f"query {part['first'][0]} ({part['first'][1]} hit), rays of "
             f"{part['first'][2]} of {part['first'][3]} lanes, by up to "
             f"{part['ulps']:.3g} ulps")
    print(f"    card vs CPU query by query ({q[0]} / {q[1]} queries, {q[2]} "
          f"compared): first rays that differ: {first}; over the compared "
          f"queries {part['moved']} lanes with other rays, {part['flipped']} "
          f"lanes with the same rays and another answer; "
          f"{camera_rays_apart(path, torch.device('cuda'))}")
    return path, cpu


# ------------------------------------------------ the binned pipeline


def compare_k3(cl, srt, K):
    """K3 (`walk`) against `walk_plain` on sorted rays srt = (ro, rd,
    t_min, t_max, ...).  -> (kernel outputs, share of lanes whose list,
    count and skipmin (bitwise) agree, max |count difference|)."""
    ro, rd, t_min, t_max = srt[:4]
    k = bi.walk(cl, ro, rd, t_min, t_max, K)
    torch.cuda.synchronize()
    p = bi.walk_plain(cl, ro, rd, t_min, t_max, K)
    same = ((k[0] == p[0]).all(dim=1) & (k[1] == p[1])
            & (k[2].view(torch.int32) == p[2].view(torch.int32)))
    agree = same.double().mean().item()
    check(agree >= MIN_AGREE, f"K3 K={K}: lists agree on {agree:.6f} of "
          f"lanes, below {MIN_AGREE}")
    empty = ~(t_max > t_min)
    check(not bool((k[1][empty] != 0).any()),
          "K3: a lane with an empty interval listed a chunk")
    return k, agree, int((k[1] - p[1]).abs().max())


def pairs_of(ids, K):
    cid, pos = bi.make_pairs(ids)
    return cid, torch.div(pos, K, rounding_mode="floor").to(torch.int32)


def well_conditioned(tri_pack, ro, rd, tri):
    """True where float32 rounding cannot move t = -(ro.n + d) / (rd.n)
    by rtol: the cancellation factors of numerator and denominator
    (sum of the terms' magnitudes over the magnitude of the sum, in
    float64), times 16 float32 epsilons for the two roundings' worth of
    kernel and plain version, stay within T_RTOL."""
    rows = tri_pack[tri.long()].double()
    n, d = rows[:, 0:3], rows[:, 3]
    o, v = ro.double(), rd.double()
    num = (o * n).sum(1) + d
    den = (v * n).sum(1)
    kappa = (((o * n).abs().sum(1) + d.abs()) / num.abs()
             + (v * n).abs().sum(1) / den.abs())
    return kappa * 16 * float(torch.finfo(torch.float32).eps) <= T_RTOL


def compare_k4(cl, tri_pack, srt, cid, ray_of, any_hit):
    """K4 (`sweep_pairs`) against `sweep_plain` on the same sorted pairs.
    -> (share of listed pairs whose id agrees, share of their hits whose
    t is within rtol, share of the well-conditioned hits whose t is
    within rtol, share of hits that are well conditioned, max |t error|
    where ids agree).  As for K2, the in-kernel t is held to rtol on
    every hit of a closest-hit query; a shadow ray starts on a surface,
    and on hits near its origin the plane distance cancels, so FMA and
    separate roundings part by more than any rtol.  Any-hit t is held
    to rtol where the computation is well conditioned
    (`well_conditioned`), which excludes that region."""
    k = bi.sweep_pairs(cl, cid, ray_of, *srt)
    torch.cuda.synchronize()
    p = bi.sweep_plain(cl, cid, ray_of, *srt)
    listed = cid != bi.SENT
    same = k[1] == p[1]
    agree = same[listed].double().mean().item() if bool(listed.any()) else 1.0
    check(agree >= MIN_AGREE, f"K4 ids agree on {agree:.6f} of the pairs")
    check(not bool((k[1][~listed] >= 0).any()), "K4: a sentinel pair hit")
    both = same & (p[1] >= 0)
    t_ok, t_cond, share_cond, err = 1.0, 1.0, 1.0, 0.0
    if bool(both.any()):
        kt, pt = k[0][both], p[0][both]
        within = (kt - pt).abs() <= T_ATOL + T_RTOL * pt.abs()
        t_ok = within.double().mean().item()
        err = float((kt - pt).abs().max())
        rays = ray_of[both].long()
        cond = well_conditioned(tri_pack, srt[0][rays], srt[1][rays],
                                p[1][both])
        share_cond = cond.double().mean().item()
        if bool(cond.any()):
            t_cond = within[cond].double().mean().item()
        check(t_ok >= MIN_AGREE or any_hit,
              f"K4 t within rtol on {t_ok:.6f} of hits")
        check(t_cond >= MIN_AGREE, f"K4 t within rtol on {t_cond:.6f} of "
              f"the well-conditioned hits ({share_cond:.6f} of hits)")
    return agree, t_ok, t_cond, share_cond, err


def same_as_parent(cl, srt, K, cid, ray_of, k3, k4):
    """With --parent: the share of lanes whose K3 list, count and
    skipmin, and of pairs whose K4 id and t, are bit-equal to the parent
    kernels' on the same inputs (both take the same node and row
    decisions, so the check is that they are 1); else None."""
    if PARENT is None:
        return None
    with library(PARENT):
        p3 = bi.walk(cl, *srt[:4], K)
        p4 = bi.sweep_pairs(cl, cid, ray_of, *srt)
    s3 = ((k3[0] == p3[0]).all(dim=1) & (k3[1] == p3[1])
          & (k3[2].view(torch.int32) == p3[2].view(torch.int32)))
    s4 = (k4[1] == p4[1]) & (k4[0].view(torch.int32) == p4[0].view(
        torch.int32))
    out = (s3.double().mean().item(), s4.double().mean().item())
    check(out == (1.0, 1.0), f"K3/K4 not bit-equal to the parent's: "
          f"lanes {out[0]:.7f}, pairs {out[1]:.7f}")
    return out


def compare_front(args, any_hit, K=bi.DEFAULT_K):
    """The binned front end against K2's on one unsorted query (cl,
    tri_pack, ro, rd, t_min, t_max, exclude).  -> (K2's outputs, share
    of rays whose id (closest) or validity (any) agrees)."""
    b = bi.intersect_clusters_binned(*args, any_hit=any_hit, K=K)
    k = ci.intersect_clusters(*args, any_hit=any_hit)
    same = ((b[1] >= 0) == (k[1] >= 0)) if any_hit else (b[1] == k[1])
    agree = same.double().mean().item()
    mode = "any" if any_hit else "closest"
    check(agree >= BINNED_AGREE, f"binned {mode} ids agree with K2 on "
          f"{agree:.7f} of rays, below {BINNED_AGREE}")
    if not any_hit:
        both = same & (k[1] >= 0)
        check(bool(torch.equal(b[0][both], k[0][both])),
              "binned reported t differs from K2's where ids agree")
    return k, agree


def phase_binned_soup(dev, trees):
    t_phase = time.perf_counter()
    n_tris, n_rays = K2_SOUP
    tri_pack = torch.from_numpy(random_soup(n_tris, seed=2)[2]).to(dev)
    ro, rd, t_max = random_rays(n_rays, seed=2, dev=dev)
    t_max = torch.where(torch.arange(n_rays, device=dev) % 3 == 0, -1.0,
                        t_max)
    t_min = torch.full_like(t_max, 0.5)
    none = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    for layout, cl in trees.items():
        _, *srt = ci.sort_rays(cl, ro, rd, t_min, t_max, none)
        sub = [x[::PLAIN_STRIDE].contiguous() for x in srt]
        args = [cl, tri_pack, ro, rd, t_min, t_max, none]
        for K in BINNED_KS:
            k3, a3, _ = compare_k3(cl, sub, K)
            over = (k3[1] > K).double().mean().item()
            a4, t4, c4, s4, e4 = compare_k4(cl, tri_pack, sub,
                                            *pairs_of(k3[0], K), False)
            k2, af = compare_front(args, False, K)
            _, ax = compare_front(args[:6] + [k2[1].contiguous()], False, K)
            _, aa = compare_front(args, True, K)
            line = (f"[9/24 K3+K4 {n_tris} tris x {n_rays} rays, {layout}, "
                    f"K={K}] K3 lists agree {a3:.6f} (lanes overflowing "
                    f"{over:.4f}); K4 ids agree {a4:.6f}, t within rtol "
                    f"{t4:.6f}, {c4:.6f} of the {s4:.6f} well-conditioned "
                    f"(max|t err| {e4:.3g}); front end vs K2: "
                    f"closest {af:.7f}, excl pass {ax:.7f}, any {aa:.7f}")
            if K == bi.DEFAULT_K:
                cid, ray_of = pairs_of(bi.walk(cl, *srt[:4], K)[0], K)
                scid, sray = pairs_of(k3[0], K)
                full = bi.walk(cl, *srt[:4], K)
                eq = same_as_parent(cl, srt, K, cid, ray_of, full,
                                    bi.sweep_pairs(cl, cid, ray_of, *srt))
                nodes = bi.walk(cl, *srt[:4], K, stats=True)[3]
                p3, n3 = ab_ms(lambda: bi.walk(cl, *srt[:4], K))
                p4, n4 = ab_ms(lambda: bi.sweep_pairs(cl, cid, ray_of, *srt))
                ms = {
                    "K3 parent": p3, "K3": n3,
                    "K3 plain": median_ms(
                        lambda: bi.walk_plain(cl, *sub[:4], K),
                        runs=PLAIN_RUNS, warmup=False),
                    "K4 parent": p4, "K4": n4,
                    "K4 plain": median_ms(
                        lambda: bi.sweep_plain(cl, scid, sray, *sub),
                        runs=PLAIN_RUNS, warmup=False),
                    "binned front end": median_ms(
                        lambda: bi.intersect_clusters_binned(*args, K=K),
                        runs=5),
                    "K2 front end": median_ms(
                        lambda: ci.intersect_clusters(*args), runs=5)}
                line += ("; median ms " + ", ".join(
                    f"{k} {v:.3f}" for k, v in ms.items() if v is not None)
                    + f" (plain on every {PLAIN_STRIDE}th sorted ray); K3 "
                    f"node SIMD efficiency {simd_efficiency(nodes):.4f}, "
                    f"nodes per ray mean {nodes.double().mean():.2f} max "
                    f"{int(nodes.max())}; K4 runs: {fmt_runs(pair_runs(cid))}")
                if eq is not None:
                    line += (f"; bit-equal to the parent's: K3 lanes "
                             f"{eq[0]:.7f}, K4 pairs {eq[1]:.7f}")
            print(line)
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")


@contextlib.contextmanager
def binned_mode(mode):
    """RGK_BINNED=mode inside the block, the caller's value after."""
    saved = os.environ.get("RGK_BINNED")
    os.environ["RGK_BINNED"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("RGK_BINNED", None)
        else:
            os.environ["RGK_BINNED"] = saved


def render_binned(path, out_dir, mode):
    """One CLI render with RGK_BINNED=mode (restored after).  -> (image,
    rays, launches, stats of the round: the queued loop's steps, every
    one issued, warm-up and replays)."""
    reset_launches()
    with binned_mode(mode), \
            FirstCalls(isect, "intersect_clusters_binned") as front:
        t0 = time.perf_counter()
        img, rays = render(path, out_dir)
        t1 = time.perf_counter()
    launches = {"K1": launched(fi), "K2": launched(ci),
                "K3/K4": launched(bi), "K5": render_k5()}
    st = tgraph.read_stats()
    return img, rays, launches, {
        "wall": t1 - t0, "round": t1 - front.first_t,
        "steps": st["steps"] + st["warmup_steps"], "args": front.args}


def phase_binned_colonnade(d, path, k2_img):
    """Phase 7's colonnade under RGK_BINNED=any, then all.  -> (the K3/K4
    entries of the kernels line, timed at the `all` run's first
    (closest-hit) binned query; {mode: K5's launches of that render})."""
    t_phase = time.perf_counter()
    res = COLONNADE_RES
    total = {"walk": 0, "sweep": 0}
    k5 = {}
    for mode in ("any", "all"):
        img, rays, launches, st = render_binned(
            path, os.path.join(d, f"colonnade_{mode}"), mode)
        check(img.shape == (res[1], res[0], 3), f"image shape {img.shape}")
        check(bool(np.isfinite(img).all()), "non-finite pixels")
        check(float(img.mean()) > 0.0, "the image is black")
        # A step of the NEE loop makes one closest-hit and one shadow
        # query; each binned query launches K3, K4 and pass 2's K2.
        steps = st["steps"]
        nb = steps * (2 if mode == "all" else 1)
        k34 = launches["K3/K4"]
        check(nb > 0 and k34 == {"walk": nb, "sweep": nb},
              f"RGK_BINNED={mode}: {steps} steps, {nb} binned queries, "
              f"K3/K4 launches {k34}")
        check(launches["K1"] == {"closest": 0, "any": 0},
              f"the colonnade launched K1: {launches['K1']}")
        k5[mode] = launches["K5"]
        check_k5_render(k5[mode], f"the RGK_BINNED={mode} render")
        k2 = launches["K2"]
        check(k2 == {"closest": 2 * steps, "any": 0},
              f"RGK_BINNED={mode}: K2 launches {k2} for {nb} binned "
              f"queries of {steps} steps")
        for key in total:
            total[key] += k34[key]
        stats = image_parity(img, k2_img)
        check(stats["ok"], f"RGK_BINNED={mode} image against the K2 image: "
              f"{stats}")
        print(f"[10/24 colonnade RGK_BINNED={mode} {res[0]}x{res[1]} "
              f"{COLONNADE_MS}spp] CLI wall {st['wall']:.3f} s, round "
              f"(first query to EXR) {st['round']:.3f} s, {rays} extension "
              f"rays, {rays / st['round']:.1f} rays/s; launches K3 "
              f"{k34['walk']}, K4 {k34['sweep']}, K2 {k2} ({steps} steps of "
              f"the queued loop, warm-up included), K5 {k5[mode]}; image vs K2's: max|diff| "
              f"{stats['max_abs_diff']:.3g}, corr {stats['corr']:.6f}, "
              f"outlier pixels {stats['outlier_pixels']}")
        print(f"    {graph_line()}")

        any_hit = mode == "any"
        args = st["args"][any_hit]
        _, af = compare_front(args, any_hit)
        cl = args[0]
        _, *srt = ci.sort_rays(cl, *args[2:7])
        k3, a3, e3 = compare_k3(cl, srt, bi.DEFAULT_K)
        cid, ray_of = pairs_of(k3[0], bi.DEFAULT_K)
        a4, t4, c4, s4, e4 = compare_k4(cl, args[1], srt, cid, ray_of,
                                        any_hit)
        p3, n3 = ab_ms(lambda: bi.walk(cl, *srt[:4]))
        p4, n4 = ab_ms(lambda: bi.sweep_pairs(cl, cid, ray_of, *srt))
        ms = {"K3 parent": p3, "K3": n3,
              "K3 plain": median_ms(lambda: bi.walk_plain(cl, *srt[:4]),
                                    runs=PLAIN_RUNS, warmup=False),
              "K4 parent": p4, "K4": n4,
              "K4 plain": median_ms(
                  lambda: bi.sweep_plain(cl, cid, ray_of, *srt),
                  runs=PLAIN_RUNS, warmup=False)}
        live = int((srt[3] > srt[2]).sum())
        r = srt[0].shape[0]
        nodes = bi.walk(cl, *srt[:4], stats=True)[3]
        eq = same_as_parent(cl, srt, bi.DEFAULT_K, cid, ray_of, k3,
                            bi.sweep_pairs(cl, cid, ray_of, *srt))
        b3 = k3_bound(cl, r, bi.DEFAULT_K, nodes)
        b4 = k4_bound(cl, r, cid)
        print(f"    first {'any' if any_hit else 'closest'}-hit binned query "
              f"({srt[0].shape[0]} rays, {live} live, "
              f"{int(cid.ne(bi.SENT).sum())} listed pairs, lanes "
              f"overflowing {(k3[1] > bi.DEFAULT_K).double().mean():.4f}): "
              f"front end vs K2 {af:.7f}; K3 lists agree {a3:.6f}; K4 ids "
              f"agree {a4:.6f}, t within rtol {t4:.6f}, {c4:.6f} of the "
              f"{s4:.6f} well-conditioned (max|t err| {e4:.3g}); median ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()
                          if v is not None)
              + f" (plain over {PLAIN_RUNS} runs); bound K3 {b3[0]:.4f} ms "
              f"by {b3[1]} (share {b3[0] / ms['K3']:.3f}), K4 {b4[0]:.4f} "
              f"ms by {b4[1]} (share {b4[0] / ms['K4']:.3f}); {clocks()}")
        print(f"    K3 node SIMD efficiency (mean/max per {WARP} sorted "
              f"rays) {simd_efficiency(nodes):.4f}, nodes per ray mean "
              f"{nodes.double().mean():.2f} max {int(nodes.max())}; K4 "
              f"runs: {fmt_runs(pair_runs(cid))}" + (
                  "" if eq is None else f"; bit-equal to the parent's: K3 "
                  f"lanes {eq[0]:.7f}, K4 pairs {eq[1]:.7f}"))
        if mode == "all":
            entries = [
                kernel_entry("binned_walk", K3_SOURCE, K3_REPLACES,
                             total["walk"], e3, ms["K3"], ms["K3 plain"],
                             *b3, p3),
                kernel_entry("binned_sweep", K4_SOURCE, K4_REPLACES,
                             total["sweep"], e4, ms["K4"], ms["K4 plain"],
                             *b4, p4)]
            profiled_round(path, os.path.join(d, "colonnade_all_prof"), isect,
                           "intersect_clusters_binned",
                           ("binned_walk", "binned_sweep", "cluster_walk"),
                           binned="all")
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return entries, k5


def phase_binned_small(d, path, cpu):
    t_phase = time.perf_counter()
    reset_launches()
    with binned_mode("all"):
        gpu, _ = render(path, os.path.join(d, "col_gpu_binned"))
    tgraph.settle()
    check(bi.launches["walk"] > 0 and bi.launches["sweep"] > 0
          and ci.launches["any"] == 0 and fi.launches["closest"] == 0,
          f"the small colonnade did not go through K3/K4: {bi.launches}, "
          f"K2 {ci.launches}")
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"binned colonnade card vs CPU parity failed: {stats}")
    print(f"[11/24 colonnade RGK_BINNED=all card vs CPU 33960 tris 64x36 "
          f"4spp depth 2] launches K3/K4 {launched(bi)}, K2 "
          f"{launched(ci)}; corr {stats['corr']:.6f} trimmed "
          f"{stats['corr_trim']:.6f} mean rel diff "
          f"{stats['mean_rel_diff']:.3g} max|diff| "
          f"{stats['max_abs_diff']:.3g} outlier pixels "
          f"{stats['outlier_pixels']}, max per tile "
          f"{stats['max_outliers_per_tile']} (cap {stats['tile_cap']}) "
          f"({time.perf_counter() - t_phase:.1f} s)")


def phase_probes(dev):
    """P1 and P2 through their tools' entry points (launches counted
    there), then one kernel of each timed against its plain version."""
    t_phase = time.perf_counter()
    reset_launches()
    print("[12/24 probes] P1 (rgk_tpu_torch/tools/prof_smem_probe.py):")
    check(p1.main([]) == 0, "P1 failed")
    print("    P2 (rgk_tpu_torch/tools/prof_sync.py):")
    check(p2.main([]) == 0, "P2 failed")
    counts = {**p1.launches, **p2.launches}
    check(all(v > 0 for v in counts.values()), f"probe launches {counts}")

    x = torch.arange(p1.THREADS, dtype=torch.float32, device=dev) + 0.5
    w, xu = p1.unpack_inputs(dev)
    table = p1.row_table(p1.ROW_SIZES[-1], dev)
    px, ptab, tile, tiles = p2.inputs(dev)
    n = p2.DEFAULT_ITERS
    thr = p2.thresh("f", n)
    # Bounds: the inputs and the output moved once; for P2, one operation
    # per thread and loop iteration (a lower bound of the loop's work).
    out = p1.THREADS * 4
    cases = (
        ("probe_smem", P1_REPLACES, "smem",
         lambda: p1.smem(x, 48 * 1024), lambda: p1.smem_plain(x, 0),
         bound(0, nbytes(x) + out)),
        ("probe_unpack", P1_REPLACES, "unpack",
         lambda: p1.unpack(w, xu), lambda: p1.unpack_plain(w, xu),
         bound(0, nbytes(w, xu) + out)),
        ("probe_row_copy", P1_REPLACES, "row_copy",
         lambda: p1.row_copy(table), lambda: p1.row_copy_plain(table, p1.ROW),
         bound(0, nbytes(table) + out)),
        ("probe_sync_f", P2_REPLACES, "sync",
         lambda: p2.sync("f", px, ptab, n, thr)[0],
         lambda: p2.sync_plain("f", px, ptab, n, thr)[0],
         bound(p2.n_iterations("f", n) * p2.THREADS,
               nbytes(px, ptab) + 2 * out)),
        ("probe_fetch_depth4", P2_REPLACES, "fetch",
         lambda: p2.fetch(tiles, 4, n, 0.0),
         lambda: p2.fetch_plain(tiles, 4, n, 0.0),
         bound(n * p2.THREADS, nbytes(tiles) + out)))
    entries = []
    for name, replaces, key, kernel, plain, (bms, by) in cases:
        k = kernel()
        torch.cuda.synchronize()
        err = float((k.double() - plain().double()).abs().max())
        check(err == 0.0, f"{name} differs from its plain version by {err}")
        kms, pms = median_ms(kernel), median_ms(plain)
        print(f"    {name}: kernel {kms:.3f} ms, plain {pms:.3f} ms, "
              f"equal; bound {bms:.5f} ms by {by}")
        entries.append(kernel_entry(name, PROBE_SOURCE, replaces,
                                    counts[key], err, kms, pms, bms, by))
    print(f"    launches in the tools' runs {counts} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return entries


# ------------------------------------------------ thin glass and BDPT


def write_bdpt(d, name, res, ms, reverse, sphere=0, glass=False,
               **overrides):
    """tools/bdpt_scene's box as a config `name`.json in `d`: plus a
    make_sphere OBJ of `sphere` triangles (5,000 make it a BVH scene),
    and with `glass` a pane between the emitter and the floor whose
    material name matches the "thinglass" phrase, tinted
    (tint-thinglass)."""
    cfg = scene_dict(res=res, ms=ms, reverse=reverse)
    cfg.update(overrides)
    if sphere:
        verts, nrms, faces = mb.make_sphere(sphere, 0.0, 0.9, 0.6, 0.6)
        mb._write_obj(os.path.join(d, f"sphere_{sphere}.obj"), verts, nrms,
                      faces)
        cfg["scene"].append({"file": f"sphere_{sphere}.obj",
                             "material": "white"})
    if glass:
        cfg["materials"].append({"name": "pane_thinglass", "brdf": "diffuse",
                                 "diffuse": [0.35, 0.55, 0.9]})
        # Turned over (normal up): the shadow segments toward the
        # emitter enter it, so they are tinted.
        cfg["scene"].append({"primitive": "plane", "axis": "Y",
                             "scale": [1.2, 1, 1.2], "rotate": [0, 0, 180],
                             "translate": [0, 2.0, 0],
                             "material": "pane_thinglass"})
        cfg["thinglass"] = ["thinglass"]
        cfg["tint-thinglass"] = True
    path = os.path.join(d, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def card_vs_cpu(d, name, *write_args, **overrides):
    """One scene rendered at 64x64, 4 spp, depth 3 on the card and on the
    CPU; fails unless the images pass the parity bounds.  -> stats."""
    path = write_bdpt(d, name, 64, 4, *write_args,
                      **{"recursion-max": 3, **overrides})
    gpu, _ = render(path, os.path.join(d, f"{name}_gpu"))
    cpu, _ = render(path, os.path.join(d, f"{name}_cpu"), "--cpu")
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"{name}: card vs CPU image parity failed: {stats}")
    return stats


def check_image(img, shape):
    check(img.shape == shape, f"image shape {img.shape}, not {shape}")
    check(bool(np.isfinite(img).all()), "the image has non-finite pixels")
    check(float(img.mean()) > 0.0, "the image is black")


def phase_glass(d):
    """-> {"K1": launches, "K2": launches, "K5": launches} of the two
    glass renders."""
    t_phase = time.perf_counter()
    got = {"K5": {"forward": 0, "backward": 0}}
    for kernel, sphere in (("K1", 0), ("K2", BVH_SPHERE)):
        path = write_bdpt(d, f"glass_{kernel}", FLAT_RES, FLAT_MS, 0, sphere,
                          glass=True)
        reset_launches()
        with FirstCalls(tpath, "_tinted") as tinted:
            t0 = time.perf_counter()
            img, rays = render(path, os.path.join(d, f"glass_{kernel}_out"))
            wall = time.perf_counter() - t0
        k1, k2 = launched(fi), launched(ci)
        k5 = render_k5()
        check_image(img, (FLAT_RES, FLAT_RES, 3))
        used, unused = (k1, k2) if kernel == "K1" else (k2, k1)
        check(used["closest"] > 0 and used["any"] > 0
              and unused == {"closest": 0, "any": 0},
              f"glass render via {kernel}: K1 {k1}, K2 {k2}")
        check(tinted.n > 0, "the tint-thinglass render tinted nothing")
        check_k5_render(k5, f"the glass render via {kernel}")
        glass_graphs = graph_line()
        got[kernel] = used
        got["K5"] = add_counts(got["K5"], k5)
        stats = card_vs_cpu(d, f"glass_{kernel}_64", 0, sphere, True)
        print(f"[13/24 thin glass, tint on, {FLAT_RES}x{FLAT_RES} {FLAT_MS}spp"
              f" via {kernel}{f', + {sphere}-tri sphere' if sphere else ''}]"
              f" wall {wall:.3f} s, {rays} extension rays, "
              f"{rays / wall:.1f} rays/s, launches {kernel} {used} (the other "
              f"kernel none), K5 {k5}, {tinted.n} tinted segment sets, "
              f"image mean {float(img.mean()):.5f}; card vs CPU 64x64 4spp "
              f"depth 3: {fmt_parity(stats)}")
        print(f"    {glass_graphs}")
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return got


def splat_contract(splats):
    """The block's splats scattered twice on the card: -> (bit-equal,
    max relative difference); fails beyond rtol 1e-5 / atol 1e-6."""
    pix, val, hw = splats
    a = tpath._splat_image(pix, val, hw)
    b = tpath._splat_image(pix, val, hw)
    torch.cuda.synchronize()
    diff = (a - b).abs()
    check(bool((diff <= 1e-6 + 1e-5 * a.abs()).all()),
          f"two scatters of one splat set differ by {float(diff.max())}")
    rel = float((diff / a.abs().clamp(min=1e-30)).max())
    return bool(torch.equal(a, b)), rel


def phase_bdpt_k1(d):
    """-> kernel entries of the splat query, the render's K1 launches and
    its K5 launches."""
    t_phase = time.perf_counter()
    path = write_bdpt(d, "bdpt", BDPT_RES, BDPT_MS, BDPT_REVERSE)
    reset_launches()
    with FirstCalls(isect, "intersect_flat") as first, \
            FirstCalls(tpath, "_splat_image") as scat:
        t0 = time.perf_counter()
        img, rays = render(path, os.path.join(d, "bdpt_out"))
        t1 = time.perf_counter()
    launches, k2 = launched(fi), launched(ci)
    k5 = render_k5()
    check_image(img, (BDPT_RES, BDPT_RES, 3))
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the BDPT render did not go through K1: {launches}")
    check(k2 == {"closest": 0, "any": 0}, f"a flat scene launched K2: {k2}")
    check_k5_render(k5, "the BDPT render")
    block = min((1 << 20) // BDPT_MS, BDPT_RES * BDPT_RES)  # the CLI's
    n_blocks = -(-BDPT_RES * BDPT_RES // block)
    st = tgraph.read_stats()
    check(st["light_replays"] == st["blocks"] == n_blocks,
          f"{st['light_replays']} light-phase replays, {st['blocks']} "
          f"blocks, for {n_blocks} blocks")
    round_s = t1 - first.first_t
    print(f"[14/24 BDPT {BDPT_RES}x{BDPT_RES} {BDPT_MS}spp reverse "
          f"{BDPT_REVERSE} depth 4 via K1] CLI wall {t1 - t0:.3f} s, round "
          f"(first query to EXR) {round_s:.3f} s, {rays} extension rays "
          f"(light + eye), {rays / round_s:.1f} rays/s; {n_blocks} blocks of "
          f"{block} pixels, {st['iterations']} loop iterations; K1 "
          f"launches {launches}, K5 launches {k5}; image mean "
          f"{float(img.mean()):.5f}")
    print(f"    {graph_line()}")
    prof = profiled_round(path, os.path.join(d, "bdpt_prof"), isect,
                          "intersect_flat", ("flat_sweep",))

    args = first.args[True]
    r = args[1].shape[0]
    check(r == block * BDPT_MS * BDPT_REVERSE,
          f"the first any-hit query has {r} rays, not the splat query's "
          f"{block * BDPT_MS * BDPT_REVERSE}")
    k = fi.intersect_flat(*args, any_hit=True)
    torch.cuda.synchronize()
    p = fi.flat_plain(*args, any_hit=True)
    same = k[1] == p[1]
    agree = same.double().mean().item()
    check(agree >= MIN_AGREE, f"splat query: K1 any-hit ids agree with "
          f"flat_plain on {agree:.6f} of the rays")
    parent, kms = k1_ab(args, True)
    pms = median_ms(lambda: fi.flat_plain(*args, any_hit=True),
                    runs=PLAIN_RUNS, warmup=False)
    bms, by = k1_bound(args, True)
    live = int((args[4] > args[3]).sum())
    bitwise, rel = splat_contract(scat.args[False])
    print(f"    first splat visibility query ({r} rays, {live} live, x "
          f"{args[0].shape[0]} tris, one launch): K1 any-hit ids equal "
          f"flat_plain's on {agree:.6f} of the rays, hit rate "
          f"{(k[1] >= 0).double().mean().item():.4f}; median ms "
          f"{fmt_ab(parent, kms, bms)} by {by}, plain {pms:.3f} (over "
          f"{PLAIN_RUNS} runs); {clocks()}")
    print(f"    the block's splats ({scat.args[False][0].shape[0]} slots) "
          f"scattered twice on the card: bit-equal {bitwise}, max relative "
          f"difference {rel:.3g} (contract: rtol 1e-5)")
    stats = card_vs_cpu(d, "bdpt_64", 2)
    print(f"    card vs CPU 64x64 4spp depth 3 reverse 2: {fmt_parity(stats)}")
    if prof is not None:
        print(f"    BDPT round profile: {prof['iterations']} iterations, "
              f"{prof['per_iteration']:.1f} kernels an iteration, "
              f"{prof['kernel_ms']:.3f} ms of device time in "
              f"{prof['round_ms']:.3f} ms (busy {prof['busy']:.4f})")
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    entry = kernel_entry("flat_intersect_any_bdpt_splat", K1_SOURCE,
                         K1_REPLACES, launches["any"], 0.0 if bool(same.all())
                         else 1.0, kms, pms, bms, by, parent)
    return [entry], launches, k5


def phase_bdpt_k2(d):
    """-> kernel entries of the splat query, the render's K2 launches and
    its K5 launches."""
    t_phase = time.perf_counter()
    path = write_bdpt(d, "bdpt_k2", K2_BDPT_RES, K2_BDPT_MS, BDPT_REVERSE,
                      BVH_SPHERE)
    reset_launches()
    with FirstCalls(ci, "traverse") as first:
        t0 = time.perf_counter()
        img, rays = render(path, os.path.join(d, "bdpt_k2_out"))
        t1 = time.perf_counter()
    launches, k1 = launched(ci), launched(fi)
    k5 = render_k5()
    check_image(img, (K2_BDPT_RES, K2_BDPT_RES, 3))
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the BDPT render did not go through K2: {launches}")
    check(k1 == {"closest": 0, "any": 0}, f"a BVH scene launched K1: {k1}")
    check_k5_render(k5, "the BDPT render")
    round_s = t1 - first.first_t
    print(f"[15/24 BDPT {K2_BDPT_RES}x{K2_BDPT_RES} {K2_BDPT_MS}spp reverse "
          f"{BDPT_REVERSE} via K2, box + {BVH_SPHERE}-tri sphere] CLI wall "
          f"{t1 - t0:.3f} s, round {round_s:.3f} s, {rays} extension rays, "
          f"{rays / round_s:.1f} rays/s, "
          f"{tgraph.read_stats()['iterations']} loop iterations; K2 "
          f"launches {launches}, K5 launches {k5}; image mean "
          f"{float(img.mean()):.5f}")
    print(f"    {graph_line()}")
    args = first.args[True]
    cl, r = args[0], args[1].shape[0]
    check(r == K2_BDPT_RES * K2_BDPT_RES * K2_BDPT_MS * BDPT_REVERSE,
          f"the first any-hit query has {r} rays")
    k = ci.traverse(*args, any_hit=True, stats=True)
    torch.cuda.synchronize()
    p = ci.cluster_plain(*args, any_hit=True)
    empty = ~(args[4] > args[3])
    check(not bool((k[1][empty] >= 0).any()),
          "K2 splat query: a lane with an empty interval hit")
    same = (k[1] >= 0) == (p[1] >= 0)
    agree = same.double().mean().item()
    check(agree >= MIN_AGREE, f"splat query: K2 any-hit validity agrees "
          f"with cluster_plain on {agree:.6f} of the rays")
    parent, kms = ab_ms(lambda: ci.traverse(*args, any_hit=True))
    pms = median_ms(lambda: ci.cluster_plain(*args, any_hit=True),
                    runs=PLAIN_RUNS, warmup=False)
    bms, by = k2_bound(cl, r, k[2], k[3])
    print(f"    first splat visibility query ({r} rays, "
          f"{int((~empty).sum())} live): K2 any-hit validity equals "
          f"cluster_plain's on {agree:.6f} of the rays, hit rate "
          f"{(k[1] >= 0).double().mean().item():.4f}, nodes per ray "
          f"{k[2].double().mean().item():.1f}, leaves "
          f"{k[3].double().mean().item():.2f}; median ms "
          f"{fmt_ab(parent, kms, bms)} by {by}, plain {pms:.3f} (over "
          f"{PLAIN_RUNS} runs); {clocks()}")
    stats = card_vs_cpu(d, "bdpt_k2_64", BDPT_REVERSE, BVH_SPHERE)
    print(f"    card vs CPU 64x64 4spp depth 3 reverse {BDPT_REVERSE}: "
          f"{fmt_parity(stats)} ({time.perf_counter() - t_phase:.1f} s)")
    entry = kernel_entry("cluster_intersect_any_bdpt_splat", K2_SOURCE,
                         K2_REPLACES, launches["any"], 0.0 if bool(same.all())
                         else 1.0, kms, pms, bms, by, parent)
    return [entry], launches, k5


# ------------------------------------------ gradients, replay, distribution


# The light-pick tables, which apply_params recomputes from the
# parameters but detaches.
PICK_TABLES = ("point_cum", "total_point_power", "areal_cum",
               "total_areal_power")


def grad_setup(path, dev, res, ms):
    """The scene at `path` on `dev`, its lanes (every pixel x `ms`
    samples), and make_loss_fn's L2 loss against a target rendered with
    the diffuse albedo scaled by 0.8.  -> (loss_fn, held_loss, params,
    meta, make_graph): `held_loss` is the same loss with the light-pick
    tables held at the base parameters', the function whose derivative
    the gradient is (the sampling distribution is detached);
    `make_graph()` builds the same loss's gradient step as one CUDA
    graph (`diff.graph.make_value_and_grad`), capture included."""
    cfg = tconfig.load_config(path)
    arrays, meta, _ = tconfig.build_scene(cfg, dev)
    pix = torch.arange(res * res, device=dev)
    px = (pix % res).to(torch.int32).repeat(ms)
    py = (pix // res).to(torch.int32).repeat(ms)
    si = torch.arange(ms, device=dev).repeat_interleave(res * res)
    cam = cfg.get_camera().to(dev)
    scaled = dparams.extract_params(arrays)
    with torch.no_grad():
        scaled["mat_diffuse"] = scaled["mat_diffuse"] * 0.8
        target = tpath.render_lanes(
            dparams.apply_params(arrays, scaled), meta, cfg.settings, cam,
            px, py, si, 42, differentiable=True).radiance
    loss_fn = dparams.make_loss_fn(arrays, meta, cfg.settings, cam, px, py,
                                   si, 42, target)

    def make_graph():
        return dgraph.make_value_and_grad(arrays, meta, cfg.settings, cam,
                                          px, py, si, 42, target)

    base = dparams.apply_params(arrays, dparams.extract_params(arrays))
    held = {f: getattr(base.lights, f).detach() for f in PICK_TABLES}

    def held_loss(params):
        s = dparams.apply_params(arrays, params)
        s = s._replace(lights=s.lights._replace(**held))
        diff = tpath.render_lanes(s, meta, cfg.settings, cam, px, py, si, 42,
                                  differentiable=True).radiance - target
        return torch.mean(diff * diff)

    return loss_fn, held_loss, dparams.extract_params(arrays), meta, make_graph


def central_diff(loss_fn, params, key, idx, eps=1e-3):
    """(loss(p + eps) - loss(p - eps)) / 2 eps at flat `idx` of leaf
    `key`, on the card."""
    flat = params[key].detach().reshape(-1).double()

    def loss_at(v):
        arr = flat.clone()
        arr[idx] = v
        with torch.no_grad():
            return float(loss_fn({**params, key: arr.reshape(
                params[key].shape).float()}))

    return (loss_at(float(flat[idx]) + eps)
            - loss_at(float(flat[idx]) - eps)) / (2 * eps)


def fd_agrees(grads, key, idx, fd, rtol=0.03, route="eager"):
    """The gradient of leaf `key` at flat `idx` against the central
    difference `fd` (tests/test_grad.py's bound).  -> the gradient."""
    g = float(grads[key].reshape(-1)[idx])
    check(np.isfinite(g), f"{key}[{idx}]: {route} gradient {g}")
    check(abs(g - fd) <= rtol * max(abs(fd), abs(g)) + 1e-6,
          f"{key}[{idx}]: {route} gradient {g} against central difference "
          f"{fd}")
    return g


def fd_check(loss_fn, params, grads, key, idx, eps=1e-3, rtol=0.03):
    """tests/test_grad.py's check on the card: the gradient of leaf
    `key` at flat `idx` against central differences of `loss_fn`.
    -> (gradient, finite difference)."""
    fd = central_diff(loss_fn, params, key, idx, eps)
    return fd_agrees(grads, key, idx, fd, rtol), fd


def timed_grads(loss_fn, params, runs=GRAD_RUNS):
    """`runs` forward + backward passes: -> (median forward ms, median
    backward ms, peak bytes allocated, loss, gradients of the last)."""
    fwd, bwd = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(runs):
        t0 = time.perf_counter()
        loss = loss_fn(params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((time.perf_counter() - t1) * 1e3)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(params.items(), grads)}
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"non-finite gradient of {k}")
    return (statistics.median(fwd), statistics.median(bwd),
            torch.cuda.max_memory_allocated(), float(loss.detach()), grads)


def eager_step(loss_fn, params):
    """One eager gradient step: -> (loss, {key: gradient or None})."""
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), dict(zip(params, grads))


def profile_grad_step(loss_fn, params, fwd_ms, bwd_ms):
    """One eager step under torch.profiler (host and card activity): the
    forward, then torch.autograd.grad, each in its own window.  Prints
    each one's kernels and device ms, its busy share over `fwd_ms` /
    `bwd_ms` (the unprofiled medians of the same work), and the 10
    backward nodes (autograd functions) and 5 kernels of the backward
    with the most device time, and the backward's gather nodes by the
    forward line that made them (the forward runs under anomaly mode,
    which keeps each node's traceback)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as pf, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # anomaly mode announces itself
        with torch.autograd.detect_anomaly(check_nan=False):
            loss = loss_fn(params)
        torch.cuda.synchronize()
    sites = gather_sites(loss)
    with profile(activities=acts) as pb:
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        torch.cuda.synchronize()

    def device_us(e):
        v = getattr(e, "device_time_total", None)
        return v if v is not None else e.cuda_time_total

    got = {}
    for name, prof, wall in (("forward", pf, fwd_ms), ("backward", pb,
                                                      bwd_ms)):
        kern = profiled_kernels(prof)
        ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        got[name] = {"kernels": len(kern), "ms": ms, "busy": ms / wall}
    prefix = "autograd::engine::evaluate_function: "
    nodes = sorted((e for e in pb.key_averages()
                    if e.key.startswith(prefix)), key=device_us,
                   reverse=True)[:10]
    got["top_nodes"] = [(e.key[len(prefix):], e.count, device_us(e) / 1e3)
                        for e in nodes]
    got["top_kernels"] = sorted(kernels_by_name(pb.events()).items(),
                                key=lambda kv: -kv[1][1])[:5]
    by_site = {}
    for e in pb.events():
        if e.name.startswith(prefix) and e.sequence_nr in sites:
            key = sites[e.sequence_nr]
            n, ms = by_site.get(key, (0, 0.0))
            by_site[key] = (n + 1, ms + device_us(e) / 1e3)
    if not got["backward"]["kernels"]:
        print("    profiled step: the profiler recorded no kernel; device "
              "time not measured")
        return
    f, b = got["forward"], got["backward"]
    print(f"    eager step under torch.profiler: forward {f['kernels']} "
          f"kernels, {f['ms']:.3f} ms of device time (busy {f['busy']:.4f} "
          f"over the unprofiled {fwd_ms:.3f} ms); backward {b['kernels']} "
          f"kernels, {b['ms']:.3f} ms (busy {b['busy']:.4f} over "
          f"{bwd_ms:.3f} ms)")
    print("    backward's top 10 autograd nodes by device time: " + "; ".join(
        f"{k} x{n} {ms:.3f} ms" for k, n, ms in got["top_nodes"]))
    print("    backward's top 5 kernels: " + "; ".join(
        f"{k[:90]} x{n} {ms:.3f} ms" for k, (n, ms) in got["top_kernels"]))
    print("    backward's gathers by the forward line that made them: "
          + "; ".join(f"{node} at {site} x{n} {ms:.3f} ms"
                      for (node, site), (n, ms) in sorted(
                          by_site.items(), key=lambda kv: -kv[1][1])))


GATHER_NODES = ("IndexBackward0", "_TakeRowsBackward")


def gather_sites(loss):
    """{sequence number: (node, "file:line function")} of every gather's
    backward node (`GATHER_NODES`) in `loss`'s graph, the line being the
    innermost frame of the port outside ops/vecmath.py in the traceback
    that anomaly mode kept of the forward that made the node."""
    pkg = os.path.join(ROOT, "rgk_tpu_torch") + os.sep
    vecmath = os.path.join(pkg, "ops", "vecmath.py")
    sites, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or (fn.name(), fn._sequence_nr()) in seen:
            continue
        seen.add((fn.name(), fn._sequence_nr()))
        todo.extend(f for f, _ in fn.next_functions)
        if fn.name() not in GATHER_NODES:
            continue
        site = "not recorded"
        for frame in reversed(fn.metadata.get("traceback_", [])):
            head = frame.strip().splitlines()[0]  # File "f", line n, in fn
            parts = head.split('"')
            if len(parts) < 3 or not parts[1].startswith(pkg) \
                    or parts[1] == vecmath:
                continue
            line, func = parts[2].split(", line ")[1].split(", in ")
            site = f"{os.path.relpath(parts[1], ROOT)}:{line} {func}"
            break
        sites[fn._sequence_nr()] = (fn.name(), site)
    return sites


def max_gap(got, want):
    """-> {key: (max |got - want|, max |want|)} over the gradients that
    are not None; fails if one side has a gradient and the other not."""
    out = {}
    for k, w in want.items():
        g = got[k]
        check((g is None) == (w is None), f"gradient of {k}: {g} vs {w}")
        if w is not None:
            out[k] = (float((g - w).abs().max()), float(w.abs().max()))
    return out


def graph_step_vs_eager(label, make_graph, loss_fn, params):
    """The gradient step as one CUDA graph (`make_graph()`) against the
    eager step, in one process: the build (warm-up and capture) timed
    and reported apart with the graph pool and the peak memory; one
    step of each dropped; then steps timed in turns graph, eager, eager,
    graph on the host clock from a synchronized card.  The graph's loss
    and every leaf's gradient must equal the eager step's bit for bit
    (K5's backward sums in a fixed order; two eager steps' gap is
    printed beside it).  -> (graph's loss, graph's gradients), copies."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tgraph.reset_stats()
    t0 = time.perf_counter()
    vg = make_graph()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build = tgraph.read_stats()
    gw.launches["stamp"] = 0
    vg(params)
    eager_step(loss_fn, params)
    times = {"graph": [], "eager": []}
    outs = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "graph":
            loss, grads = vg(params)
        else:
            loss, grads = eager_step(loss_fn, params)
        torch.cuda.synchronize()
        times[route].append((time.perf_counter() - t0) * 1e3)
        outs[route].append((loss.clone(), {
            k: None if g is None else g.clone() for k, g in grads.items()}))
    # A traced graph step stamps three times (diff/graph.py); the eager
    # step none.
    steps = tgraph.read_stats()["grad_steps"] - build["grad_steps"]
    stamps = launched(gw)["stamp"]
    check(steps == 3 and stamps == 3 * steps,
          f"{label}: {stamps} phase stamps in {steps} graph steps")
    STAMP_RUNS.append(stamps)
    peak = torch.cuda.max_memory_allocated()
    (g_loss, g_grads), (e_loss, e_grads) = outs["graph"][-1], \
        outs["eager"][-1]
    rel = abs(float(g_loss) - float(e_loss)) / abs(float(e_loss))
    check(bool(torch.equal(g_loss, e_loss)), f"{label}: graph loss "
          f"{float(g_loss)} against eager {float(e_loss)}")
    gaps = max_gap(g_grads, e_grads)
    for k, (gap, top) in gaps.items():
        check(bool(torch.equal(g_grads[k], e_grads[k])), f"{label}: {k}'s "
              f"graph gradient {gap} from the eager step's (largest {top})")
    noise = max_gap(outs["eager"][0][1], e_grads)
    worst = max(gaps, key=lambda k: gaps[k][0] / max(gaps[k][1], 1e-30))
    nworst = max(noise, key=lambda k: noise[k][0] / max(noise[k][1], 1e-30))
    mean = {k: statistics.mean(v) for k, v in times.items()}
    print(f"    gradient step as one CUDA graph: build {build_s * 1e3:.1f} "
          f"ms ({tgraph.WARMUP_STEPS} eager warm-up steps and the capture, "
          f"{build['capture_ms']:.1f} ms of it), graph pool "
          f"{build['pool_bytes'] / 2**30:.3f} GiB, max memory allocated "
          f"{peak / 2**30:.3f} GiB with the pool; steps (graph, eager, "
          f"eager, graph) graph {times['graph'][0]:.3f} / "
          f"{times['graph'][1]:.3f} ms, eager {times['eager'][0]:.3f} / "
          f"{times['eager'][1]:.3f} ms (eager / graph "
          f"{mean['eager'] / mean['graph']:.3f}x); loss rel diff "
          f"{rel:.3g}; largest gradient gap {worst} "
          f"{gaps[worst][0]:.3g} of {gaps[worst][1]:.3g} (eager vs eager: "
          f"{nworst} {noise[nworst][0]:.3g} of {noise[nworst][1]:.3g})")
    return g_loss, g_grads


def sgd_step_lowers(loss_fn, params, grads):
    """One torch.optim.SGD step on every leaf, the largest change 0.01:
    -> (loss before, loss after); fails unless it went down."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    g_max = max(float(g.abs().max()) for g in grads.values())
    opt = torch.optim.SGD(list(p.values()), lr=0.01 / g_max)
    opt.zero_grad()
    loss = loss_fn(p)
    loss.backward()
    opt.step()
    with torch.no_grad():
        after = float(loss_fn(p))
    before = float(loss.detach())
    check(after < before, f"an SGD step did not lower the loss: {before} "
          f"-> {after}")
    return before, after


def grad_roughness(d):
    """tests/test_grad.py's scene, lanes, seed and black target on the
    card: the roughness of the glossy cube moves its bounce's rays, so
    its gradient needs K1's hit points differentiated along the ray.
    -> (card gradient, card central difference, CPU gradient) of
    GRAD_ROUGHNESS's leaf, the first two checked at its eps and rtol,
    the first and the last within GRAD_CARD_CPU_RTOL."""
    path = os.path.join(d, "grad_scene.json")
    with open(path, "w") as f:
        json.dump(GRAD_SCENE, f)
    key, idx, eps, rtol = GRAD_ROUGHNESS

    def setup(dev):
        cfg = tconfig.load_config(path)
        arrays, meta, _ = tconfig.build_scene(cfg, dev, build_bvh=False)
        i = torch.arange(64)
        loss_fn = dparams.make_loss_fn(
            arrays, meta, cfg.settings, cfg.get_camera(),
            (i % 8).to(torch.int32), (i // 8).to(torch.int32),
            torch.zeros(64, dtype=torch.int64), 3, torch.zeros(64, 3))
        params = dparams.extract_params(arrays)
        (g,) = torch.autograd.grad(loss_fn(params), [params[key]])
        return loss_fn, params, {key: g}

    g, fd = fd_check(*setup(CUDA), key, idx, eps, rtol)
    g_cpu = float(setup(torch.device("cpu"))[2][key].reshape(-1)[idx])
    check(abs(g - g_cpu) <= GRAD_CARD_CPU_RTOL * abs(g_cpu),
          f"{key}[{idx}]: card gradient {g}, CPU gradient {g_cpu}")
    return g, fd, g_cpu


def phase_grad_k1(d):
    """-> K1 and K5 launches of the gradient runs, the scene's path, and
    K5's first call for each table width."""
    t_phase = time.perf_counter()
    res, ms = GRAD_RES, GRAD_MS
    sub = os.path.join(d, "grad_k1")
    os.makedirs(sub)
    path = write_box(sub, res=res, ms=ms, lights=[GRAD_LIGHT])
    loss_fn, held_loss, params, meta, make_graph = grad_setup(path, CUDA,
                                                              res, ms)
    check(not meta.has_bvh and meta.n_triangles == 3870,
          f"phase 16's scene: {meta.n_triangles} triangles, bvh "
          f"{meta.has_bvh}")
    reset_launches()
    index = {k: 0 if m is None else 3 * meta.material_names.index(m)
             for k, m in GRAD_K1_CHECKS}
    print(f"[16/24 gradients via K1, {res}x{res} {ms}spp = {res * res * ms} "
          f"lanes, depth 4, 3870 tris + a point light, L2 against albedo "
          f"x 0.8] {clocks()}")
    with FirstCalls(isect, "intersect_flat") as first, \
            GatherCalls(vm, "take_rows") as gathers:
        fwd, bwd, peak, loss, grads = timed_grads(loss_fn, params)
        profile_grad_step(loss_fn, params, fwd, bwd)
        g_loss, g_grads = graph_step_vs_eager("phase 16", make_graph,
                                              loss_fn, params)
        checks = []
        for k, i in index.items():
            fd = central_diff(held_loss, params, k, i)
            checks.append((k, i, fd_agrees(grads, k, i, fd),
                           fd_agrees(g_grads, k, i, fd, route="graph"), fd,
                           central_diff(loss_fn, params, k, i)))
        before, after = sgd_step_lowers(loss_fn, params, grads)
    rough_g, rough_fd, rough_cpu = grad_roughness(sub)
    launches, k2 = launched(fi), launched(ci)
    k5 = render_k5()
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the gradient runs did not go through K1: {launches}")
    check(k2 == {"closest": 0, "any": 0}, f"a flat scene launched K2: {k2}")
    check(k5["forward"] > 0 and k5["backward"] > 0,
          f"the gradient runs did not go through K5: {k5}")
    check(sorted(gathers.args) == [8, 15, 20], f"phase 16's K5 tables: "
          f"widths {sorted(gathers.args)}")
    check(peak <= GRAD_PEAK_LIMIT, f"peak memory {peak} bytes")
    args = first.args[False]
    _, agree, err = compare(args, False)
    print(f"    eager: forward {fwd:.3f} ms, backward {bwd:.3f} ms (medians "
          f"of {GRAD_RUNS}), peak memory {peak / 2**30:.3f} GiB in one block "
          f"(no split), loss {loss:.6g}, graph loss {float(g_loss):.6g}, K1 "
          f"launches {launches}, K5 launches {k5}; "
          + "; ".join(f"{k}[{i}] grad {g:.6g} (graph {gg:.6g}) central diff "
                      f"{fd:.6g} (tables free: {fd_free:.6g})"
                      for k, i, g, gg, fd, fd_free in checks)
          + f"; SGD step loss {before:.6g} -> {after:.6g}; test_grad's "
          f"scene {GRAD_ROUGHNESS[0]}[{GRAD_ROUGHNESS[1]}] grad {rough_g:.6g}"
          f" central diff {rough_fd:.6g} (CPU grad {rough_cpu:.6g}); first "
          f"closest query ({args[1].shape[0]} rays) K1 vs flat_plain agree "
          f"{agree:.6f} max|err| {err:.3g} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return launches, k5, path, gathers.args


def phase_grad_k2(d):
    """-> K2 and K5 launches of the gradient runs."""
    t_phase = time.perf_counter()
    res, ms = K2_GRAD_RES, K2_GRAD_MS
    cfg = scene_dict(res=res, ms=ms, reverse=0)
    cfg["materials"].append({"name": "ball", "brdf": "diffuse",
                             "diffuse": [0.6, 0.3, 0.2]})
    verts, nrms, faces = mb.make_sphere(BVH_SPHERE, 0.0, 0.9, 0.6, 0.6)
    mb._write_obj(os.path.join(d, "grad_ball.obj"), verts, nrms, faces)
    cfg["scene"].append({"file": "grad_ball.obj", "material": "ball"})
    path = os.path.join(d, "grad_k2.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    loss_fn, held_loss, params, meta, make_graph = grad_setup(path, CUDA,
                                                              res, ms)
    check(meta.has_bvh, "phase 17's scene has no BVH")
    ball = 3 * meta.material_names.index("ball")
    reset_launches()
    print(f"[17/24 gradients via K2, box + {BVH_SPHERE}-tri sphere, "
          f"{res}x{res} {ms}spp]")
    fwd, bwd, peak, loss, grads = timed_grads(loss_fn, params, runs=1)
    profile_grad_step(loss_fn, params, fwd, bwd)
    g_loss, g_grads = graph_step_vs_eager("phase 17", make_graph, loss_fn,
                                          params)
    fd = central_diff(held_loss, params, "mat_diffuse", ball)
    g = fd_agrees(grads, "mat_diffuse", ball, fd)
    gg = fd_agrees(g_grads, "mat_diffuse", ball, fd, route="graph")
    check(abs(g) > 1e-7, "no gradient reaches the sphere's albedo")
    launches, k1 = launched(ci), launched(fi)
    k5 = render_k5()
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the gradient runs did not go through K2: {launches}")
    check(k1 == {"closest": 0, "any": 0}, f"a BVH scene launched K1: {k1}")
    check(k5["forward"] > 0 and k5["backward"] > 0,
          f"the gradient runs did not go through K5: {k5}")
    print(f"    eager: forward {fwd:.3f} ms, backward {bwd:.3f} ms, peak "
          f"memory {peak / 2**30:.3f} GiB, loss {loss:.6g}, graph loss "
          f"{float(g_loss):.6g}; the sphere's albedo mat_diffuse[{ball}] "
          f"grad {g:.6g} (graph {gg:.6g}) central diff {fd:.6g}; K2 "
          f"launches {launches}, K1 none, K5 launches {k5} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return launches, k5


def phase_debug_rtc(d):
    """-> K1 and K5 launches of the CLI runs on the card."""
    t_phase = time.perf_counter()
    sub = os.path.join(d, "debug")
    os.makedirs(sub)
    path = write_box(sub, res=FLAT_RES, ms=1)
    x, y = DEBUG_PIXEL
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main([path, "-q", "-D", os.path.join(sub, "out"), "-d",
                        str(x), str(y)]) == 0, "the CLI with -d failed")
    printed = buf.getvalue()
    check(f"[debug {x},{y} s0] camera ray" in printed,
          "the CLI's -d printed no camera ray")
    recs = {}
    for dev in ("card", "cpu"):
        cfg = tconfig.load_config(path)
        arrays, meta, _ = tconfig.build_scene(
            cfg, CUDA if dev == "card" else torch.device("cpu"))
        recs[dev] = trace_pixel_debug(arrays, meta, cfg.settings,
                                      cfg.get_camera(), x, y,
                                      printer=lambda *_: None)
    gpu, cpu = recs["card"][0], recs["cpu"][0]
    name = meta.material_names[cpu["mat_id"]]
    check(f"b0: tri {cpu['tri']} mat '{name}'" in printed,
          f"the CLI's bounce 0 is not the CPU replay's tri {cpu['tri']} "
          f"mat '{name}':\n{printed}")
    check((gpu["tri"], gpu["mat_id"]) == (cpu["tri"], cpu["mat_id"]),
          f"bounce 0: card tri/mat {gpu['tri']}/{gpu['mat_id']}, CPU "
          f"{cpu['tri']}/{cpu['mat_id']}")
    pos_err = float(np.max(np.abs(np.subtract(gpu["pos"], cpu["pos"]))
                           / np.maximum(np.abs(cpu["pos"]), 1e-30)))
    check(np.allclose(gpu["pos"], cpu["pos"], rtol=1e-4, atol=0.0),
          f"bounce 0 position: card {gpu['pos']}, CPU {cpu['pos']}")
    debug_k1, debug_k5 = launched(fi), render_k5()
    check_k5_render(debug_k5, "the debug replay")

    rtc_dir = os.path.join(d, "rtc")
    os.makedirs(rtc_dir)
    rtc = write_rtc_scene(rtc_dir, RTC_RES, 4, 3)
    reset_launches()
    check(cli.main([rtc, "-q", "-D", os.path.join(rtc_dir, "gpu")]) == 0,
          "the CLI failed on the .rtc scene")
    rtc_k1, rtc_k5 = launched(fi), render_k5()
    rtc_graphs = graph_line()
    check(rtc_k1["closest"] > 0 and rtc_k1["any"] > 0,
          f"the .rtc render did not go through K1: {rtc_k1}")
    check_k5_render(rtc_k5, "the .rtc render")
    check(cli.main([rtc, "-q", "--cpu", "-D",
                    os.path.join(rtc_dir, "cpu")]) == 0,
          "the CLI failed on the .rtc scene on the CPU")
    gpu_img = read_exr(os.path.join(rtc_dir, "gpu", "rtc.exr"))
    cpu_img = read_exr(os.path.join(rtc_dir, "cpu", "rtc.exr"))
    check_image(gpu_img, (RTC_RES[1], RTC_RES[0], 3))
    stats = image_parity(gpu_img, cpu_img)
    check(stats["ok"], f".rtc card vs CPU image parity failed: {stats}")
    print(f"[18/24 debug replay -d {x} {y} on the {FLAT_RES}x{FLAT_RES} flat "
          f"scene; .rtc scene {RTC_RES[0]}x{RTC_RES[1]} 4spp depth 3] the "
          f"CLI printed {len(printed.splitlines())} lines; {len(recs['card'])}"
          f" bounces on the card, {len(recs['cpu'])} on the CPU; bounce 0 "
          f"tri {gpu['tri']} mat '{name}' on both, position max rel diff "
          f"{pos_err:.3g}; K1 launches {debug_k1}, K5 {debug_k5}; .rtc "
          f"render K1 launches {rtc_k1}, K5 {rtc_k5}, card vs CPU: "
          f"{fmt_parity(stats)} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    print(f"    the .rtc card render's {rtc_graphs}")
    return add_counts(debug_k1, rtc_k1), add_counts(debug_k5, rtc_k5)


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def outputs(out_dir, name):
    img = read_exr(os.path.join(out_dir, name + ".exr"))
    with np.load(os.path.join(out_dir, name + ".exr.ckpt.npz")) as ck:
        return img, {k: ck[k] for k in ck.files}


def phase_distribution(d):
    """-> K1 and K5 launches of the distributed renders."""
    t_phase = time.perf_counter()
    path = write_bdpt(d, "dist", DIST_RES, 4, 0)
    runs = (("plain", []), ("devices", ["--devices", "1"]),
            ("nccl", ["--coordinator", f"localhost:{free_port()}",
                      "--num-processes", "1", "--process-id", "0"]))
    reset_launches()
    got = {}
    for name, extra in runs:
        out = os.path.join(d, f"dist_{name}")
        check(cli.main([path, "-q", "-D", out, *extra]) == 0,
              f"the CLI failed with {extra}")
        got[name] = outputs(out, "bdpt_box")
    world = torch.distributed.get_world_size()
    backend = torch.distributed.get_backend()
    torch.distributed.destroy_process_group()
    launches, k5 = launched(fi), render_k5()
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the distributed renders did not go through K1: {launches}")
    check_k5_render(k5, "the distributed renders")
    for name in ("devices", "nccl"):
        check(np.array_equal(got[name][0], got["plain"][0]),
              f"--{name} EXR differs from the plain render's")
        for k, v in got["plain"][1].items():
            check(np.array_equal(got[name][1][k], v),
                  f"--{name} checkpoint {k} differs from the plain render's")

    # Shards on one card would share K2's per-card work counter.
    try:
        MeshContext(devices=[CUDA, CUDA])
    except ValueError:
        refused = True
    else:
        refused = False
    check(refused, "a mesh listing the card twice was built")
    print(f"[19/24 distribution on one card, {DIST_RES}x{DIST_RES} 4spp] "
          f"--devices 1 and {backend} world size {world} (--coordinator "
          f"localhost) write the plain render's EXR and checkpoint bit for "
          f"bit; a mesh listing the card twice is refused; K1 launches "
          f"{launches}, K5 launches {k5} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    print(f"    the three renders' {graph_line()}")
    return launches, k5


# ------------------------------------------------ the queued loop as graphs


def timed_round(drv, r):
    """-> (seconds, rays) of `drv.render_round(r)`, host clock from a
    synchronized card to the round's end on the card."""
    n0 = int(drv._rays_dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drv.render_round(r)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dt, int(drv._rays_dev) - n0


def counted_syncs(fn):
    """-> the syncs that set_sync_debug_mode("warn") reports while fn()
    runs (the process's own: an end-test read, a `.item()`, a copy to
    the host)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def profiled(fn, names):
    """fn() under torch.profiler (card activity): -> its ms on the host
    clock, the kernels and their device ms (all, and those whose name
    holds each of `names`), busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]
    total = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by = {n: sum(e.time_range.elapsed_us() for e in kern if n in e.name)
          / 1e3 for n in names}
    return {"wall_ms": wall, "kernels": len(kern), "kernel_ms": total,
            "busy": total / wall, "by": by}


def fmt_prof(p, wall_s, eager=None):
    """A profiled block: its kernels, device ms and busy share under the
    profiler, and the device ms over `wall_s`, the unprofiled time of
    the same work.  With `eager`, the eager profile of the same work, `p`
    is a WHILE graph's, whose records of the bodies the profiler keeps
    in some windows only: its numbers stand as measured only where each
    named kernel's device ms is within 10% of the eager route's (the
    same kernels on the same rays) and the device time does not exceed
    the unprofiled time, which one stream cannot; else they are printed
    as not measured."""
    if not p["kernels"]:
        return "the profiler recorded no kernel (busy share not measured)"
    text = (f"{p['kernels']} kernels, {p['kernel_ms']:.3f} ms of device time "
            f"in {p['wall_ms']:.3f} ms, busy {p['busy']:.4f} under the "
            f"profiler, {p['kernel_ms'] / (wall_s * 1e3):.4f} over the "
            f"unprofiled time (" + ", ".join(
                f"{k} {v:.3f} ms" for k, v in p["by"].items()) + ")")
    if eager is None:
        return text
    off = [k for k, v in eager["by"].items()
           if v > 0 and abs(p["by"][k] - v) > 0.1 * v]
    if not off and p["kernel_ms"] <= wall_s * 1e3:
        return text + " [agrees with the eager profile]"
    why = ", ".join(f"{k} {p['by'][k]:.3f} against eager "
                    f"{eager['by'][k]:.3f} ms" for k in off)
    if p["kernel_ms"] > wall_s * 1e3:
        why += (", " if why else "") + "device time above the unprofiled time"
    return (f"not measured: the profiler's records of the WHILE bodies "
            f"disagree with the eager profile ({why}); as recorded: {text}")


def graph_vs_eager(label, scene, names):
    """Phase 20 on one scene (under the caller's RGK_BINNED): the CLI's
    driver (one WHILE-graph launch a block) against EagerDriver.  The
    graph driver's round 0 (it holds the capture) is dropped; block 0 of
    round 1 is traced by the graph runner (with its accumulation) and by
    the eager loop (the eager route's first work, dropped from the
    timing), each under set_sync_debug_mode("warn") to count the syncs
    of a block (the graph route's must be 0), and must be bit-equal
    (BDPT: the eye radiance; the splat image within rtol 1e-5); rounds 2
    and 3 are timed in turns graph, eager, eager, graph, and the two
    drivers' images of them must be equal (BDPT within rtol 1e-5); block
    0 runs once more on each route under torch.profiler; then
    `end_test_routes`.  -> a dict of the numbers."""
    t_case = time.perf_counter()
    s, arrays, meta, cam = scene
    g, e = make_driver(scene), make_driver(scene, eager=True)
    tgraph.reset_stats()
    g.render_round(0)
    build = tgraph.read_stats()
    runner = g._runner
    check(type(runner) is tgraph.QueuedGraph and runner._exec is not None,
          f"{label}: the driver's runner has no WHILE graph")
    bdpt = g.bdpt
    eager = (tpath.trace_wavefront_queued_bdpt_eager if bdpt
             else tpath.trace_wavefront_queued_eager)
    px, py, pix = g._px[0], g._py[0], g._pix_idx[0]
    s0 = g.ms  # round 1's first sample

    def graph_block():
        runner.block(px, py, s0, 42, cam)
        runner.accumulate(g._acc_dev, g._rays_dev, pix)

    def eager_block():
        return eager(arrays, meta, s, cam, px, py, s0, g.ms, 42,
                     smp.MODE_HALTON)

    g_syncs = counted_syncs(graph_block)
    outs = runner.state.radiance, runner.splat, runner.state.rays
    got = [t.clone() for t in outs if t is not None]
    syncs = {"graph": g_syncs}
    after = tgraph.read_stats()
    reads = after["flag_reads"] - build["flag_reads"]
    iters = after["iterations"] - build["iterations"]  # block 0's loop
    over = after["overshoot"] - build["overshoot"]
    e_out = []
    syncs["eager"] = counted_syncs(lambda: e_out.append(eager_block()))
    want = e_out[0]
    check(torch.equal(got[0], want[0]) and torch.equal(got[-1], want[-1]),
          f"{label}: block 0's radiance or rays differ between the graph "
          f"route and the eager loop")
    splat_rel = 0.0
    if bdpt:
        diff = (got[1] - want[1]).abs()
        check(bool((diff <= 1e-6 + 1e-5 * want[1].abs()).all()),
              f"{label}: block 0's splat image beyond rtol 1e-5")
        splat_rel = float((diff / want[1].abs().clamp(min=1e-30)).max())
    check(g_syncs == reads == over == 0 and iters > 0,
          f"{label}: {g_syncs} syncs in a graph block of {iters} "
          f"iterations, {reads} end-test reads, {over} steps past the end")

    for drv in (g, e):
        drv._acc_dev.zero_()
    tgraph.reset_stats()
    gw.launches["stamp"] = 0
    times = {"graph": [], "eager": []}
    rays = {"graph": [], "eager": []}
    for r, route in ((2, "graph"), (2, "eager"), (3, "eager"),
                     (3, "graph")):
        dt, n = timed_round(g if route == "graph" else e, r)
        times[route].append(dt)
        rays[route].append(n)
    gst = tgraph.read_stats()
    SETTER_RUNS.append(gst["setter_runs"])
    # A traced step: a mark, two stamps around each ray query, one at
    # its end; a BDPT step two more around its connections, and a BDPT
    # block's light phase a mark, two around each query and one at its
    # end (integrator/graph.py `_Probe`); the eager loop runs none.
    stamps = launched(gw)["stamp"]
    queries = sum(gst[k] for k in (
        "closest_queries", "any_queries", "connect_queries",
        "light_closest_queries", "light_any_queries"))
    check(stamps == 2 * (gst["iterations"] * (2 if bdpt else 1) + queries
                         + gst["light_replays"]) > 0,
          f"{label}: {stamps} phase stamps in {gst['iterations']} steps, "
          f"{gst['light_replays']} light phases and {queries} queries "
          f"({gst})")
    STAMP_RUNS.append(stamps)
    check(rays["graph"] == rays["eager"],
          f"{label}: rays of rounds 2 and 3, graph {rays['graph']}, eager "
          f"{rays['eager']}")
    ga, ea = g._acc_dev[:-1], e._acc_dev[:-1]
    if bdpt:
        same = bool((ga - ea).abs().le(1e-6 + 1e-5 * ea.abs()).all())
    else:
        same = bool(torch.equal(ga, ea))
    check(same, f"{label}: rounds 2-3's image differs between the graph "
          f"route and the eager loop")
    blocks = len(g._px)
    check(gst["blocks"] == gst["while_launches"] == 2 * blocks
          and gst["replays"] == gst["steps"] == gst["iterations"]
          and gst["setter_runs"] == gst["iterations"] + 2 * blocks
          and gst["flag_reads"] == 0,
          f"{label}: graph counters {gst}")
    block_s = {"graph": [], "eager": []}
    for route, fn in (("graph", graph_block), ("eager", eager_block),
                      ("eager", eager_block), ("graph", graph_block)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        block_s[route].append(time.perf_counter() - t0)
    prof = {"graph": profiled(graph_block, names),
            "eager": profiled(eager_block, names)}

    mean = {k: statistics.mean(v) for k, v in times.items()}
    mean_block = {k: statistics.mean(v) for k, v in block_s.items()}
    print(f"    {label}: block 0 ({px.shape[0]} lanes, {iters} iterations) "
          f"radiance and rays bit-equal" + (
              f", splat image max rel diff {splat_rel:.3g}" if bdpt else "")
          + f"; rounds 2-3 image "
          f"{'within rtol 1e-5' if bdpt else 'bit-equal'}; rounds (graph, "
          f"eager, eager, graph) graph {times['graph'][0]:.4f} / "
          f"{times['graph'][1]:.4f} s, eager {times['eager'][0]:.4f} / "
          f"{times['eager'][1]:.4f} s (eager / graph "
          f"{mean['eager'] / mean['graph']:.2f}x), {rays['graph'][0]} / "
          f"{rays['graph'][1]} rays, {sum(rays['graph']) / 2 / mean['graph']:.1f}"
          f" rays/s graph, {sum(rays['eager']) / 2 / mean['eager']:.1f} "
          f"eager")
    print(f"      syncs a block (block 0): graph {syncs['graph']} (the end "
          f"test on the device), eager {syncs['eager']}; rounds 2-3: "
          f"{gst['blocks']} blocks, {gst['while_launches']} WHILE-graph "
          f"launches, {gst['iterations']} iterations, {gst['replays']} "
          f"steps run ({gst['overshoot']} past the end), "
          f"{gst['setter_runs']} condition-setter runs, "
          f"{gst['flag_reads']} end-test reads on the host, "
          f"{gst['light_replays']} light phases; capture "
          f"{build['capture_ms']:.1f} ms for {build['captures']} graphs, "
          f"graph pool {build['pool_bytes'] / 2**20:.1f} MiB, max memory "
          f"allocated {build['peak_before'] / 2**30:.3f} -> "
          f"{build['peak_after'] / 2**30:.3f} GiB across the capture")
    body = gw.node_count(runner._graphs["step"][0], "step")
    plain_body = plain_bxdf_nodes(g)
    check(body < plain_body, f"{label}: the body holds {body} nodes, the "
          f"same body with the plain BxDF {plain_body}")
    print(f"      block 0 (graph, eager, eager, graph) graph "
          f"{mean_block['graph'] * 1e3:.3f} ms, eager "
          f"{mean_block['eager'] * 1e3:.3f} ms; profiled: graph "
          f"{fmt_prof(prof['graph'], mean_block['graph'], prof['eager'])} "
          f"(the block ran {iters} bodies of {body} nodes, {plain_body} "
          f"with the plain BxDF in the kernel's place); eager "
          f"{fmt_prof(prof['eager'], mean_block['eager'])}")
    out = {"times": times, "rays": rays, "syncs": syncs, "stats": gst,
           "build": build, "prof": prof, "block_s": mean_block,
           "nodes": body, "plain_bxdf_nodes": plain_body,
           "routes": end_test_routes(label, scene, g)}
    print(f"      ({time.perf_counter() - t_case:.1f} s)")
    return out


BXDF_ENTRIES = ("eval_bxdf", "sample_bxdf")


@contextlib.contextmanager
def plain_bxdf():
    """The BxDF's public functions replaced by its plain version (every
    lobe in ATen ops, as the card ran them before the BxDF kernel)."""
    saved = {name: getattr(bx, name) for name in BXDF_ENTRIES}
    try:
        for name in BXDF_ENTRIES:
            setattr(bx, name, getattr(bx, f"{name}_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(bx, name, fn)


def plain_bxdf_nodes(drv):
    """Nodes of the queued step that `drv`'s runner captures, captured
    once more with the plain BxDF in the kernel's place."""
    with plain_bxdf():
        runner = tgraph.QueuedGraph(drv.scene, drv.meta, drv.settings,
                                    drv.camera, drv.block, drv.ms,
                                    drv.sampler_mode, seed=drv.seed)
        nodes = gw.node_count(runner._graphs["step"][0], "step")
    del runner
    torch.cuda.empty_cache()
    return nodes


def end_test_routes(label, scene, g):
    """Block 0 of round 0 through a runner of the WHILE graph and through
    runners of the host route that read the end test every
    k replays, k in HOST_KS, and k = n, the block's iterations (one read,
    no step past the end): the device route's radiance, rays (and BDPT
    splat image, within rtol 1e-5) against the host route's at k =
    HOST_K bit for bit, the same iterations, no end-test read and no step
    past the end on the device route; then the block timed on each route
    in turns (device, k ascending, k descending, device), ROUTE_CYCLES
    times, after one dropped block each.  -> {route: median seconds},
    printed with each route's steps past the end and its runs."""
    s, arrays, meta, cam = scene
    px, py = g._px[0], g._py[0]

    def runner(cls=tgraph.QueuedGraph, **kw):
        return cls(arrays, meta, s, cam, g.block, g.ms, smp.MODE_HALTON,
                   seed=42, **kw)

    # Every route's runner built here, one after another: a runner built
    # earlier in the process (the driver's) can sit at another speed.
    routes = {"device": runner()}
    for k in HOST_KS:
        routes[f"k {k}"] = runner(HostReadGraph, k=k)

    def traced(runner):
        tgraph.reset_stats()
        got = [t.clone() for t in runner.trace(px, py, 0, 42, cam)]
        return got, tgraph.read_stats()

    got, st = traced(routes["device"])
    want, st_host = traced(routes[f"k {HOST_K}"])
    check(torch.equal(got[0], want[0]) and torch.equal(got[-1], want[-1]),
          f"{label}: block 0's radiance or rays differ between the WHILE "
          f"graph and the host route")
    if g.bdpt:
        check(bool((got[1] - want[1]).abs().le(
            1e-6 + 1e-5 * want[1].abs()).all()),
              f"{label}: block 0's splat image, WHILE graph against the "
              f"host route, beyond rtol 1e-5")
    check(st["iterations"] == st_host["iterations"] > 0
          and st["flag_reads"] == st["overshoot"] == 0
          and st["setter_runs"] == st["iterations"] + 1,
          f"{label}: WHILE graph {st}, host route {st_host}")
    # The host route that reads once, after exactly the block's steps.
    routes["k n"] = runner(HostReadGraph, k=st["iterations"])
    for runner in routes.values():
        runner.block(px, py, 0, 42, cam)
    got_s = {name: [] for name in routes}
    over = {}
    order = list(routes)
    for name in (order + order[::-1]) * ROUTE_CYCLES:
        torch.cuda.synchronize()
        tgraph.reset_stats()
        t0 = time.perf_counter()
        routes[name].block(px, py, 0, 42, cam)
        torch.cuda.synchronize()
        got_s[name].append(time.perf_counter() - t0)
        over[name] = tgraph.read_stats()["overshoot"]
    med = {name: statistics.median(v) for name, v in got_s.items()}
    # Each cycle runs every route twice; the WHILE graph's mean over the
    # exact replays' (k n) within each, the level that moves every route
    # between cycles divided out.
    per_cycle = [statistics.mean(got_s["device"][2 * c:2 * c + 2])
                 / statistics.mean(got_s["k n"][2 * c:2 * c + 2])
                 for c in range(ROUTE_CYCLES)]
    print(f"      block 0 through the WHILE graph = the host route at k "
          f"{HOST_K} bit for bit ({st['iterations']} iterations each, "
          f"{st_host['flag_reads']} host reads there, none here; k n = k "
          f"{st['iterations']}); in turns "
          f"(median of {2 * ROUTE_CYCLES}; the runs): " + "; ".join(
              f"{name} {med[name] * 1e3:.2f} ms ({over[name]} past the end; "
              + " ".join(f"{t * 1e3:.1f}" for t in got_s[name]) + ")"
              for name in order)
          + "; device over k n, a cycle each: "
          + ", ".join(f"{r:.4f}" for r in per_cycle))
    return med


def setter_entry():
    """The condition setter alone, on the main path's buffers (a bool []
    flag, an int64 [] counter): a WHILE graph around a three-kernel body
    that counts to SETTER_ITERS, against the same body replayed from the
    host with a read of the flag after each replay (the plain version's
    loop, `graph_while.run_plain`, on the card), in turns (graph, plain,
    plain, graph).  Both must stop at SETTER_ITERS, and the counter must
    hold the setter's runs.  -> the kernels line's entry (launches 0
    here; main() sets phases 20-21's)."""
    dev = CUDA
    x = torch.zeros((), dtype=torch.int64, device=dev)
    n = torch.full((), SETTER_ITERS, dtype=torch.int64, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    runs = torch.zeros((), dtype=torch.int64, device=dev)
    side = torch.cuda.Stream(dev)

    def start():
        x.zero_()
        flag.copy_(x < n)

    def step():
        x.add_(1)
        flag.copy_(x < n)

    def capture(fn, keep):
        g = torch.cuda.CUDAGraph(keep_graph=keep)
        with torch.cuda.graph(g, stream=side):
            fn()
        return g

    loop = gw.WhileGraph(capture(step, True), flag, runs,
                         capture(start, True))
    plain_step = capture(step, False)

    def graph_run():
        loop.launch()

    def plain_run():
        start()
        while bool(flag):
            plain_step.replay()

    got = {"graph": [], "plain": []}
    ends = {}
    for route in ("graph", "plain", "graph", "plain", "plain", "graph"):
        fn = graph_run if route == "graph" else plain_run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        got[route].append(time.perf_counter() - t0)
        ends[route] = int(x)
    ms = {k: statistics.mean(v[1:]) * 1e3 / SETTER_ITERS
          for k, v in got.items()}  # each route's first run dropped
    err = abs(ends["graph"] - ends["plain"]) + abs(
        int(runs) - 3 * (SETTER_ITERS + 1))
    check(err == 0 and ends["graph"] == SETTER_ITERS,
          f"the condition setter's loop ended at {ends}, counter "
          f"{int(runs)}")
    bms, by = bound(2, SETTER_BYTES)
    print(f"    condition setter (csrc/graph_while.cu): {SETTER_ITERS} "
          f"iterations of a 3-kernel body, WHILE graph {ms['graph'] * 1e3:.3f}"
          f" us an iteration (setter and body), host reads "
          f"{ms['plain'] * 1e3:.3f} us (replay and read), counter "
          f"{int(runs)} = 3 x {SETTER_ITERS + 1}; bound {bms:.3g} ms by {by}")
    return kernel_entry("while_condition", SETTER_SOURCE, SETTER_REPLACES, 0,
                        err, ms["graph"], ms["plain"], bms, by)


def stamp_entry():
    """The phase stamp alone, on a queued runner's accumulator (a
    `tgraph._Probe`, its slots named `other_ns` and `intersect_ns`), in
    captured bodies
    replayed from the host, as the queued and gradient steps run it:
    STAMP_ITERS stamps back to back, timed by CUDA events around the
    replay (a stamp's ms: its node's launch latency and the kernel); and
    a mark, then STAMP_SLEEPS device sleeps each closed by a stamp into
    `intersect_ns` or `other_ns` in turn, whose two slots together must
    equal the CUDA events around the replay, less those around a replay
    of a lone mark (the launch and the edges the stamps cannot see),
    within STAMP_RTOL of the events.  The plain version is the
    host clock on a CPU accumulator (`gw.stamp` on the CPU).  -> the
    kernels line's entry (launches 0 here; main() sets those of phases
    16, 17, 20, 21 and 23)."""
    dev = CUDA
    probe = tgraph._Probe(dev)
    other, inside = probe.slot("other_ns"), probe.slot("intersect_ns")
    acc = probe.acc
    side = torch.cuda.Stream(dev)

    def bare():
        gw.stamp(acc)
        for _ in range(STAMP_ITERS):
            gw.stamp(acc, other)

    def mark():
        gw.stamp(acc)

    def slept():
        gw.stamp(acc)
        for i in range(STAMP_SLEEPS):
            torch.cuda._sleep(SLEEP_CYCLES // 4)
            gw.stamp(acc, (inside, other)[i % 2])

    graphs = {}
    for name, fn in (("bare", bare), ("mark", mark), ("slept", slept)):
        fn()  # eager, outside the capture
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], stream=side):
            fn()
    ms = median_ms(graphs["bare"].replay) / STAMP_ITERS
    edge_ns = median_ms(graphs["mark"].replay) * 1e6
    acc.zero_()
    graphs["bare"].replay()
    torch.cuda.synchronize()
    check(int(acc[other]) > 0 and int(acc[inside]) == 0,
          f"the bare stamps' slots: {acc.tolist()}")
    errs, seen = [], []
    for _ in range(3):
        acc.zero_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        graphs["slept"].replay()
        ev[1].record()
        ev[1].synchronize()
        ev_ns = ev[0].elapsed_time(ev[1]) * 1e6
        got = int(acc[inside]) + int(acc[other])
        errs.append(abs(ev_ns - edge_ns - got) / ev_ns)
        seen.append((got / 1e6, ev_ns / 1e6))
        check(int(acc[inside]) > 0 and int(acc[other]) > 0,
              f"the slept stamps' slots: {acc.tolist()}")
    err = max(errs)
    check(err <= STAMP_RTOL, f"the stamps saw {seen} ms (stamped, events) "
          f"of device sleeps, {err:.3g} apart")
    host = torch.zeros_like(acc, device="cpu")
    t0 = time.perf_counter()
    gw.stamp(host)
    for _ in range(STAMP_ITERS):
        gw.stamp(host, other)
    plain_ms = (time.perf_counter() - t0) * 1e3 / (STAMP_ITERS + 1)
    bms, by = bound(2, STAMP_BYTES)
    print(f"    phase stamp (csrc/graph_while.cu): {STAMP_ITERS} captured "
          f"stamps back to back {ms * 1e3:.3f} us a stamp (node launch and "
          f"kernel); {STAMP_SLEEPS} stamped device sleeps, stamps against "
          f"CUDA events (ms): " + ", ".join(f"{a:.4f} / {b:.4f}"
                                            for a, b in seen)
          + f", less a lone mark's replay {edge_ns / 1e6:.4f} ms: largest "
          f"gap {err:.3g} (limit {STAMP_RTOL:g}); host clock "
          f"on a CPU accumulator {plain_ms * 1e3:.3f} us a stamp; bound "
          f"{bms:.3g} ms by {by}")
    return kernel_entry("phase_stamp", SETTER_SOURCE, None, 0, err, ms,
                        plain_ms, bms, by)


def phase_graph(flat_path, col_path, bdpt_path):
    """Phase 20: the queued loop's WHILE graph against the eager loop and
    against the host route on the flat smoke scene (K1), the colonnade
    (K2) with RGK_BINNED off and all, and the BDPT box (K1); then the
    condition setter and the phase stamp alone.  -> (numbers, the
    setter's entry, the stamp's entry)."""
    t_phase = time.perf_counter()
    print(f"[20/24 queued loop: one CUDA graph with a WHILE node vs the "
          f"eager loop and the host route] {clocks()}")
    v = gw.driver_version()
    print(f"    conditional WHILE nodes: CUDA driver {v // 1000}."
          f"{v % 1000 // 10} ({v}), built by the port's "
          f"csrc/graph_while.cu (rgk_while_graph_create) around torch "
          f"{torch.__version__} captures (CUDAGraph(keep_graph=True)."
          f"raw_cuda_graph()); the end test never leaves the card; the "
          f"host route (end test read every k replays) only for the "
          f"comparisons below")
    got = {"flat": graph_vs_eager(
        f"flat smoke {FLAT_RES}x{FLAT_RES} {FLAT_MS}spp", load_scene(
            flat_path), ("flat_sweep",))}
    col = load_scene(col_path)
    for mode in ("off", "all"):
        with binned_mode(mode):
            got[f"colonnade {mode}"] = graph_vs_eager(
                f"colonnade {COLONNADE_RES[0]}x{COLONNADE_RES[1]} "
                f"{COLONNADE_MS}spp RGK_BINNED={mode}", col,
                ("cluster_walk", "binned_walk", "binned_sweep"))
    del col
    got["bdpt"] = graph_vs_eager(
        f"BDPT {BDPT_RES}x{BDPT_RES} {BDPT_MS}spp reverse {BDPT_REVERSE}",
        load_scene(bdpt_path), ("flat_sweep",))
    entry = setter_entry()
    stamp = stamp_entry()
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return got, entry, stamp


def all_bounce_capture(runner):
    """The per-sample path as captured before the WHILE node, for the
    comparison: `trace_wavefront(differentiable=True)` over `runner`'s
    lane buffers, every bounce unrolled into one graph (kept, never
    launched).  -> (capture ms, graph pool bytes, nodes)."""
    s = runner.settings
    dev = runner.device
    ctx = smp.SampleCtx(
        seed=runner.seed,
        pixel=runner.py.long() * runner.cam.xres + runner.px.long(),
        sample=runner.sample, mode=runner.sampler_mode, n_set=runner.su.n_set)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    before = tgraph._snapshot()
    t0 = time.perf_counter()
    with torch.no_grad(), torch.cuda.graph(graph, stream=side):
        tpath.trace_wavefront(runner.scene, runner.meta, s, runner.cam, ctx,
                              runner.px, runner.py, differentiable=True)
    ms = (time.perf_counter() - t0) * 1e3
    pool = torch.cuda.memory_reserved(dev) - reserved
    # The wrappers counted the launches this capture only recorded.
    tgraph._add_launches([{k: c[k] - b[k] for k in c} for c, b in zip(
        tgraph._COUNTERS, before)], -1)
    nodes = gw.node_count(graph, "all-bounce")
    del graph
    torch.cuda.empty_cache()
    return ms, pool, nodes


def lane_round_vs_eager(label, scene, names):
    """Phase 21 on one scene: `render_image_round` through a LaneGraph
    (the per-sample path as one CUDA graph with a WHILE node) against
    `render_image_round_eager` (the host bounce loop) in one process.
    The runner's build is timed apart, its graphs' nodes counted, and
    the capture of every bounce (the route before the WHILE node) is
    made once for its capture ms, pool and nodes; round 0 of each route
    is dropped; round 1 runs on each route under
    set_sync_debug_mode("warn") (the graph route must make no sync) and
    the two images must be equal (radiance bit for bit; with splats,
    which add with atomics, within rtol 1e-5), as must the counts and
    rays, and the WHILE graph must run as many bounces as the host loop;
    rounds 2 and 3 are timed in turns graph, eager, eager, graph, images
    held the same way; one round of each runs under torch.profiler."""
    t_case = time.perf_counter()
    s, arrays, meta, cam = scene
    ms = int(s.multisample)
    depth = int(s.recursion_max)
    lanes = cam.xres * cam.yres * ms
    splats = int(s.reverse) > 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tgraph.reset_stats()
    t0 = time.perf_counter()
    runner = tgraph.LaneGraph(arrays, meta, s, cam, lanes, smp.MODE_HALTON,
                              seed=42)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build = tgraph.read_stats()
    nodes = {name: gw.node_count(runner._graphs[name][0], name)
             for name in ("init", "bounce", "finish")}
    old = all_bounce_capture(runner)

    def graph_round(r):
        return tpath.render_image_round(arrays, meta, s, cam, r, 42,
                                        smp.MODE_HALTON, runner=runner)

    def eager_round(r):
        return tpath.render_image_round_eager(arrays, meta, s, cam, r, 42,
                                              smp.MODE_HALTON)

    def same(a, b, what, routes="the graph and the eager route"):
        if splats:
            ok = bool((a[0] - b[0]).abs().le(1e-6 + 1e-5 * b[0].abs()).all())
        else:
            ok = torch.equal(a[0], b[0])
        check(ok and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]),
              f"{label}: {what}'s image, counts or rays differ between "
              f"{routes}")

    graph_round(0)
    eager_round(0)
    got, want = [], []
    bounce_fn, eager_bounces = tpath._lane_bounce, []

    def counted_bounce(*args):
        eager_bounces.append(1)
        return bounce_fn(*args)

    tgraph.reset_stats()
    syncs = {"graph": counted_syncs(lambda: got.append(graph_round(1)))}
    bounces = tgraph.read_stats()["lane_bounces"]
    tpath._lane_bounce = counted_bounce
    try:
        syncs["eager"] = counted_syncs(lambda: want.append(eager_round(1)))
    finally:
        tpath._lane_bounce = bounce_fn
    check(syncs["graph"] == 0, f"{label}: {syncs['graph']} syncs in a graph "
          f"round")
    check(bounces == len(eager_bounces) <= depth, f"{label}: the WHILE graph "
          f"ran {bounces} bounces, the host loop {len(eager_bounces)}")
    same(got[0], want[0], "round 1")
    with plain_rows():
        same(eager_round(1), want[0], "round 1",
             "K5 and plain indexing (the route before K5)")
    times = {"graph": [], "eager": []}
    images = {"graph": {}, "eager": {}}
    tgraph.reset_stats()
    for r, route in ((2, "graph"), (2, "eager"), (3, "eager"),
                     (3, "graph")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (graph_round if route == "graph" else eager_round)(r)
        torch.cuda.synchronize()
        times[route].append(time.perf_counter() - t0)
        images[route][r] = out
    st = tgraph.read_stats()
    SETTER_RUNS.append(st["setter_runs"])
    for r in (2, 3):
        same(images["graph"][r], images["eager"][r], f"round {r}")
    peak = torch.cuda.max_memory_allocated()
    rays = int(want[0][2])
    mean = {k: statistics.mean(v) for k, v in times.items()}
    prof = {"graph": profiled(lambda: graph_round(4), names),
            "eager": profiled(lambda: eager_round(4), names)}
    img = got[0][0]
    check(img.shape == (cam.yres, cam.xres, 3)
          and bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
          f"{label}: image {tuple(img.shape)} mean {float(img.mean())}")
    print(f"    {label} ({lanes} lanes, depth {depth}, russian "
          f"{float(s.russian):g}): round 1 image "
          f"{'within rtol 1e-5' if splats else 'bit-equal'} (and bit-equal "
          f"to the eager round with plain indexing in place of take_rows), "
          f"counts and {rays} rays equal; syncs a round: graph "
          f"{syncs['graph']}, eager {syncs['eager']} (its end-test reads); "
          f"bounces run {bounces} of {depth} (the device counter; the host "
          f"loop ran {len(eager_bounces)}); rounds 2-3 equal ({st['lane_bounces']}"
          f" bounces in 2 launches); rounds (graph, eager, eager, graph) "
          f"graph {times['graph'][0]:.4f} / {times['graph'][1]:.4f} s, "
          f"eager {times['eager'][0]:.4f} / {times['eager'][1]:.4f} s "
          f"(eager / graph {mean['eager'] / mean['graph']:.2f}x), "
          f"{rays / mean['graph']:.1f} rays/s graph, "
          f"{rays / mean['eager']:.1f} eager")
    print(f"      build {build_s * 1e3:.1f} ms ({tgraph.WARMUP_STEPS} eager "
          f"warm-up runs and the capture, {build['capture_ms']:.1f} ms of "
          f"it), graph pool {build['pool_bytes'] / 2**30:.3f} GiB, nodes "
          f"prologue {nodes['init']} / one-bounce body {nodes['bounce']} / "
          f"epilogue {nodes['finish']}; the all-bounce capture (the route "
          f"before the WHILE node): "
          f"{old[0]:.1f} ms, graph pool {old[1] / 2**30:.3f} GiB, "
          f"{old[2]} nodes; max memory allocated {peak / 2**30:.3f} GiB; "
          f"profiled round: graph "
          f"{fmt_prof(prof['graph'], mean['graph'], prof['eager'])} (the "
          f"round ran {bounces} bodies of {nodes['bounce']} nodes); eager "
          f"{fmt_prof(prof['eager'], mean['eager'])} "
          f"({time.perf_counter() - t_case:.1f} s)")


def write_default_depth(d, res, ms):
    """The flat smoke scene (phase 5's box and sphere) with no
    `recursion-max` and no `russian` in its JSON, so that the config's
    defaults hold (40 and 0.74), under `d`.  -> the path."""
    os.makedirs(d, exist_ok=True)
    path = write_box(d, res=res, ms=ms)
    with open(path) as f:
        cfg = json.load(f)
    del cfg["recursion-max"], cfg["russian"]
    out = os.path.join(d, f"default_{res}_{ms}.json")
    with open(out, "w") as f:
        json.dump(cfg, f)
    return out


def default_depth(d):
    """Phase 21's scene at the JSON defaults: the per-sample round of
    LANE_MS spp (1,048,576 lanes) through `lane_round_vs_eager`, the
    queued round of FLAT_MS spp through `graph_vs_eager` (the WHILE graph
    against the eager loop and the host route), and the card image
    against the port's CPU image at 64x64, 4 spp (phase 6's bounds)."""
    sub = os.path.join(d, "default")
    lanes_path = write_default_depth(sub, FLAT_RES, LANE_MS)
    scene = load_scene(lanes_path)
    s = scene[0]
    check(int(s.recursion_max) == DEFAULT_DEPTH
          and abs(float(s.russian) - DEFAULT_RUSSIAN) < 1e-9,
          f"the JSON defaults: recursion-max {s.recursion_max}, russian "
          f"{s.russian}")
    label = (f"flat smoke at the JSON defaults {FLAT_RES}x{FLAT_RES} "
             f"(recursion-max {DEFAULT_DEPTH}, russian {DEFAULT_RUSSIAN})")
    lane_round_vs_eager(f"{label} {LANE_MS}spp", scene, ("flat_sweep",))
    del scene
    torch.cuda.empty_cache()
    print(f"    {label} {FLAT_MS}spp, the queued round:")
    graph_vs_eager(f"{label} {FLAT_MS}spp queued", load_scene(
        write_default_depth(sub, FLAT_RES, FLAT_MS)), ("flat_sweep",))
    torch.cuda.empty_cache()
    small = write_default_depth(os.path.join(d, "default64"), 64, 4)
    gpu, _ = render(small, os.path.join(d, "default_gpu64"))
    cpu, _ = render(small, os.path.join(d, "default_cpu64"), "--cpu")
    stats = image_parity(gpu, cpu)
    check(stats["ok"], f"{label}: card vs CPU image parity failed: {stats}")
    print(f"    {label} card vs CPU 64x64 4spp: corr {stats['corr']:.6f} "
          f"trimmed {stats['corr_trim']:.6f} mean rel diff "
          f"{stats['mean_rel_diff']:.3g} max|diff| {stats['max_abs_diff']:.3g}"
          f" outlier pixels {stats['outlier_pixels']}, max per tile "
          f"{stats['max_outliers_per_tile']} (cap {stats['tile_cap']})")


def phase_lane_graph(d, col_path):
    """Phase 21: the per-sample path's round as one CUDA graph with a
    WHILE node against the eager route, on the flat smoke scene at
    512x512 4 spp (K1) and the colonnade at its config's 960x540 and
    phase 7's 8 spp (K2); then the flat smoke scene at the JSON defaults
    (`default_depth`).  -> {"K1": launches, "K2": launches, "K5":
    launches} of the phase's renders."""
    t_phase = time.perf_counter()
    print(f"[21/24 per-sample path: one CUDA graph with a WHILE node vs "
          f"the eager bounce loop] {clocks()}")
    sub = os.path.join(d, "lanes")
    os.makedirs(sub)
    flat = write_box(sub, res=FLAT_RES, ms=LANE_MS)
    reset_launches()
    lane_round_vs_eager(f"flat smoke {FLAT_RES}x{FLAT_RES} {LANE_MS}spp",
                        load_scene(flat), ("flat_sweep",))
    k1, k2_flat = launched(fi), launched(ci)
    k5_flat = render_k5()
    check(k1["closest"] > 0 and k1["any"] > 0 and k2_flat == {
        "closest": 0, "any": 0}, f"flat rounds: K1 {k1}, K2 {k2_flat}")
    check_k5_render(k5_flat, "the flat rounds")
    torch.cuda.empty_cache()
    reset_launches()
    lane_round_vs_eager(f"colonnade {COLONNADE_RES[0]}x{COLONNADE_RES[1]} "
                        f"{COLONNADE_MS}spp", load_scene(col_path),
                        ("cluster_walk",))
    k2, k1_col = launched(ci), launched(fi)
    k5_col = render_k5()
    check(k2["closest"] > 0 and k2["any"] > 0 and k1_col == {
        "closest": 0, "any": 0}, f"colonnade rounds: K2 {k2}, K1 {k1_col}")
    check_k5_render(k5_col, "the colonnade rounds")
    torch.cuda.empty_cache()
    reset_launches()
    default_depth(d)
    k1_deep, k5_deep = launched(fi), render_k5()
    check(k1_deep["closest"] > 0 and k1_deep["any"] > 0,
          f"the default-depth renders: K1 {k1_deep}")
    check_k5_render(k5_deep, "the default-depth renders")
    k1 = add_counts(k1, k1_deep)
    print(f"    K1 launches {k1} (flat, default depth), K2 launches {k2} "
          f"(colonnade), K5 launches {k5_flat} (flat), {k5_col} "
          f"(colonnade), {k5_deep} (default depth) "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return {"K1": k1, "K2": k2, "K5": add_counts(k5_flat, k5_col, k5_deep)}


@contextlib.contextmanager
def plain_rows():
    """Inside, `vm.take_rows` is plain indexing (`table[idx]`), the port's
    row fetch before K5: the same rows, the backward PyTorch's
    index_put_(accumulate=True)."""
    saved = vm.take_rows
    vm.take_rows = lambda table2d, idx: table2d[idx.long()]
    try:
        yield
    finally:
        vm.take_rows = saved


def k5_bounds(r, m, k):
    """(forward, backward) bounds of K5 on r ids into an [m, k] table:
    bytes, each input read once and each output written once (the
    backward's per-block partials belong to its design, not to the
    function, and are not counted); the backward's r * k additions are
    far below the FP32 peak."""
    fwd = bound(0, r * 4 + r * k * 4 + m * k * 4)
    bwd = bound(r * k, r * k * 4 + r * 4 + m * k * 4)
    return fwd, bwd


def k5_checks(table, idx, seed):
    """K5 against its plain version on `table` and `idx`: the rows bit
    for bit, the backward of a seeded gradient twice bit for bit and
    within 1e-5 x max of a float64 sum.  -> (g, backward's max error,
    largest entry of the float64 sum)."""
    m, k = table.shape
    r = idx.shape[0]
    got = vm.take_rows(table, idx)
    check(torch.equal(got.view(torch.int32),
                      vm.take_rows_plain(table, idx).view(torch.int32)),
          f"K5's rows of the [{m}, {k}] table differ from the plain "
          f"version's")
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(r, k)).astype(np.float32)).to(CUDA)
    a = vm.take_rows_backward(g, idx, m)
    b = vm.take_rows_backward(g, idx, m)
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
          f"K5's backward of the [{m}, {k}] table differs run to run")
    ref = vm.take_rows_backward_plain(g.double(), idx, m)
    top = float(ref.abs().max())
    err = float((a.double() - ref).abs().max())
    check(err <= 1e-5 * top, f"K5's backward of the [{m}, {k}] table "
          f"{err} from the float64 sum (largest {top})")
    return g, err, top


def phase_take_rows(grad_path, gathers):
    """Phase 22: K5 against its plain version on phase 16's gathers (its
    material pack, point pack and areal rows with the ids of its first
    gradient step, 1,048,576 lanes) and on tables of K5_BOUNDARY rows
    around the small-table route's bound (the same ids' count, drawn
    with numpy), timed in turns with --parent's K5; and phase 16's step
    through K5 against the same step with plain indexing.  Its
    comparison launches are not counted.  -> K5's two kernel entries
    (the material pack's shape, 4 of the step's 6 fetches)."""
    t_phase = time.perf_counter()
    print(f"[22/24 K5 take_rows at phase 16's gathers] {clocks()}")
    check(sorted(gathers) == [8, 15, 20], f"phase 16's K5 tables: widths "
          f"{sorted(gathers)}")
    table, idx = gathers[20]

    def fetch():
        vm.take_rows(table, idx)

    def after_timing():
        queued_ms(fetch)
        return profile_window(fetch)

    ways = {"bare": lambda: profile_window(fetch, warmup_step=False),
            "after a warm-up step": lambda: profile_window(fetch),
            "after a warm-up step, right after 20 calls timed behind a "
            "sleeping kernel": after_timing}
    def fetches(events):
        return sum("gather_rows" in e.name for e in kernel_events(events))

    seen = {way: sorted(collections.Counter(
                fetches(window()) for _ in range(WINDOW_TRIES)).items())
            for way, window in ways.items()}
    print(f"    profiler windows of 3 forward calls at the material pack, "
          f"{WINDOW_TRIES} of each kind, as (K5 forward kernels recorded, "
          f"windows): "
          + "; ".join(f"{way} {n}" for way, n in seen.items()))
    entries = []
    for k in sorted(gathers, reverse=True):
        table, idx = gathers[k]
        m, r = table.shape[0], idx.shape[0]
        g, err, top = k5_checks(table, idx, k)
        fp, fk = ab_ms(lambda: vm.take_rows(table, idx), timer=queued_ms)
        fwd = {"kernel": fk, "parent": fp,
               "plain": queued_ms(lambda: vm.take_rows_plain(table, idx)),
               "index_select": queued_ms(
                   lambda: torch.index_select(table, 0, idx))}
        out = torch.zeros((m, k), device=CUDA)
        lidx = idx.long()
        onehot_t = (torch.arange(m, device=CUDA, dtype=torch.int32)[:, None]
                    == idx[None, :]).float()          # [m, r]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            bp, bk = ab_ms(lambda: vm.take_rows_backward(g, idx, m),
                           timer=queued_ms)
            bwd = {"kernel": bk, "parent": bp,
                   "plain": queued_ms(
                       lambda: vm.take_rows_backward_plain(g, idx, m),
                       runs=PLAIN_RUNS),
                   "index_add_": queued_ms(
                       lambda: out.index_add_(0, idx, g)),
                   "index_put_": queued_ms(
                       lambda: out.index_put_((lidx,), g, accumulate=True),
                       runs=PLAIN_RUNS),
                   "onehot_matmul": queued_ms(
                       lambda: torch.matmul(onehot_t, g))}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del onehot_t
        (fb, fby), (bb, bby) = k5_bounds(r, m, k)
        print(f"    [{m}, {k}] table, {r} ids ({int(idx.unique().numel())} "
              f"distinct): rows bit-equal; backward twice bit-equal, "
              f"max|err| {err:.3g} of {top:.4g} (float64 sum); "
              + "forward " + fmt_ab(fwd["parent"], fwd["kernel"], fb, 4)
              + f" by {fby}, plain {fwd['plain']:.4f}, index_select "
              f"{fwd['index_select']:.4f}; "
              + "backward " + fmt_ab(bwd["parent"], bwd["kernel"], bb, 4)
              + f" by {bby}, plain {bwd['plain']:.4f}, index_add_ "
              f"{bwd['index_add_']:.4f}, index_put_(accumulate=True) "
              f"{bwd['index_put_']:.3f}, one-hot matmul (TF32 off) "
              f"{bwd['onehot_matmul']:.4f}")
        print("    its kernels under torch.profiler, 3 calls (device us a "
              "launch): forward "
              + device_kernels(lambda: vm.take_rows(table, idx))
              + "; backward "
              + device_kernels(lambda: vm.take_rows_backward(g, idx, m)))
        deterministic = max(bwd["index_put_"], bwd["onehot_matmul"])
        check(bwd["kernel"] <= deterministic, f"K5's backward "
              f"{bwd['kernel']} ms, slower than the slowest deterministic "
              f"library call ({deterministic} ms)")
        if k != 20:
            continue
        entries = [
            {**kernel_entry("take_rows_forward", K5_SOURCE, K5_REPLACES, 0,
                            0.0, fwd["kernel"], fwd["plain"], fb, fby,
                            fwd["parent"]),
             "library_ms": fwd["index_select"],
             "library_call": "torch.index_select"},
            {**kernel_entry("take_rows_backward", K5_SOURCE, K5_REPLACES, 0,
                            err, bwd["kernel"], bwd["plain"], bb, bby,
                            bwd["parent"]),
             "library_ms": bwd["index_add_"],
             "library_call": "torch.Tensor.index_add_",
             "library_ms_deterministic": {
                 "index_put_(accumulate=True)": bwd["index_put_"],
                 "onehot_matmul": bwd["onehot_matmul"]}}]
    check(len(entries) == 2, "phase 16 recorded no material-pack fetch")
    rng = np.random.default_rng(22)
    r = gathers[20][1].shape[0]
    for m in K5_BOUNDARY:
        table = torch.from_numpy(rng.normal(size=(m, 20)).astype(
            np.float32)).to(CUDA)
        idx = torch.from_numpy(rng.integers(0, m, r).astype(np.int32)).to(
            CUDA)
        g, err, top = k5_checks(table, idx, m)
        fp, fk = ab_ms(lambda: vm.take_rows(table, idx), timer=queued_ms)
        bp, bk = ab_ms(lambda: vm.take_rows_backward(g, idx, m),
                       timer=queued_ms)
        (fb, _), (bb, _) = k5_bounds(r, m, 20)
        route = "small-table" if m <= K5_SMALL_ROWS else "grouped"
        print(f"    [{m}, 20] table ({route} backward), {r} ids drawn "
              f"uniformly: rows bit-equal; backward twice bit-equal, "
              f"max|err| {err:.3g} of {top:.4g}; "
              + "forward " + fmt_ab(fp, fk, fb, 4) + "; backward "
              + fmt_ab(bp, bk, bb, 4))
    loss_fn, _, params, _, _ = grad_setup(grad_path, CUDA, GRAD_RES, GRAD_MS)
    timed_grads(loss_fn, params, runs=1)
    with plain_rows():
        timed_grads(loss_fn, params, runs=1)
    runs = {"K5": [], "plain": []}
    for route in ("plain", "K5", "K5", "plain"):
        with plain_rows() if route == "plain" else contextlib.nullcontext():
            runs[route].append(timed_grads(loss_fn, params, runs=1))
    (*_, l5, g5), (*_, lp, gp) = runs["K5"][-1], runs["plain"][-1]
    # float32 losses as Python floats: equal floats are equal bits.
    check(l5 == lp, f"phase 16's loss through K5 {l5}, through plain "
          f"indexing {lp}")
    # index_put_(accumulate=True) adds each row's run of up to 1M lanes
    # serially in float32 (a relative error up to ~n * 2^-24), K5 by a
    # tree: the two may part by more than K5 parts from a float64 sum
    # (phase 16's central differences hold K5's).
    gaps = {}
    for key, b in gp.items():
        gap, top = float((g5[key] - b).abs().max()), float(b.abs().max())
        gaps[key] = gap / max(top, 1e-30)
        check(gap <= 1e-3 * top + 1e-12, f"{key}'s gradient through K5 "
              f"{gap} from plain indexing's (largest {top})")
    print("    phase 16's eager step, in turns plain, K5, K5, plain: "
          + "; ".join(f"{route} forward {', '.join(f'{x[0]:.3f}' for x in v)}"
                      f" ms, backward {', '.join(f'{x[1]:.3f}' for x in v)} "
                      f"ms, peak {', '.join(f'{x[2] / 2**30:.3f}' for x in v)}"
                      f" GiB" for route, v in runs.items())
          + "; loss bit-equal; largest gradient gap "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
              gaps.items(), key=lambda kv: -kv[1])[:3])
          + " of the leaf's largest (within 1e-3) "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return entries


def phase_grad_bdpt(d):
    """Phase 23: bench.py's BDPT box (reverse 4) at full width through
    make_loss_fn, eager and as one CUDA graph in turns.  -> K1 and K5
    launches of its runs."""
    t_phase = time.perf_counter()
    res, ms = GRAD_RES, BDPT_GRAD_MS
    sub = os.path.join(d, "grad_bdpt")
    os.makedirs(sub)
    path = write_bdpt(sub, "grad_bdpt", res, ms, BDPT_REVERSE)
    loss_fn, held_loss, params, meta, make_graph = grad_setup(path, CUDA,
                                                              res, ms)
    check(not meta.has_bvh, "phase 23's scene has a BVH")
    white = 3 * meta.material_names.index("white")
    reset_launches()
    print(f"[23/24 BDPT gradients via K1, bench.py's box {res}x{res} {ms}spp "
          f"= {res * res * ms} lanes, reverse {BDPT_REVERSE}, depth 4, L2 "
          f"against albedo x 0.8] {clocks()}")
    # timed_grads fails on a non-finite gradient of any leaf.
    fwd, bwd, peak, loss, grads = timed_grads(loss_fn, params, runs=1)
    g_loss, g_grads = graph_step_vs_eager("phase 23", make_graph, loss_fn,
                                          params)
    fd = central_diff(held_loss, params, "mat_diffuse", white)
    g = fd_agrees(grads, "mat_diffuse", white, fd)
    gg = fd_agrees(g_grads, "mat_diffuse", white, fd, route="graph")
    launches, k2, k5 = launched(fi), launched(ci), render_k5()
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the BDPT gradient runs did not go through K1: {launches}")
    check(k2 == {"closest": 0, "any": 0}, f"a flat scene launched K2: {k2}")
    check(k5["forward"] > 0 and k5["backward"] > 0,
          f"the BDPT gradient runs did not go through K5: {k5}")
    check(peak <= GRAD_PEAK_LIMIT, f"peak memory {peak} bytes")
    nonzero = sorted(k for k, v in grads.items() if float(v.abs().max()) > 0)
    print(f"    eager: forward {fwd:.3f} ms, backward {bwd:.3f} ms, peak "
          f"memory {peak / 2**30:.3f} GiB, loss {loss:.6g}, graph loss "
          f"{float(g_loss):.6g}; every leaf's gradient finite (non-zero: "
          f"{', '.join(nonzero)}); mat_diffuse[{white}] grad {g:.6g} "
          f"(graph {gg:.6g}) central diff {fd:.6g}; K1 launches {launches}, "
          f"K2 none, K5 launches {k5} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return launches, k5


def aten_ops(fn):
    """ATen operations `fn` dispatches: on a card, about one kernel each
    (the plain sampler's count of launches a call)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def phase_sampler(launches):
    """Phase 24: the sampler kernel at the box cell's step (one block of
    SAMPLER_LANES lanes, Halton, a 0-d device seed, per-lane pixel ids,
    samples and bounces): each sampler call of a queued NEE step against
    the plain version on the card, bit for bit, kernel and plain ms
    (`queued_ms`), the bound by bytes (per-lane inputs read once, the
    output written once) and the plain version's ATen ops a call.
    `launches`: the kernel's launches by entry in the renders of phases
    1-23.  -> the kernel entries; an entry's launches are on its first
    row, and 0 on the rows after it that share the entry."""
    t_phase = time.perf_counter()
    print(f"[24/24 sampler kernel at the box step's {SAMPLER_LANES} lanes] "
          f"{clocks()}; launches in the renders of phases 1-23 "
          f"{launches}")
    launches = dict(launches)  # each entry's count goes on one row
    n = SAMPLER_LANES
    seed = torch.tensor(42, dtype=torch.int64, device=CUDA)
    pixel = torch.arange(n, dtype=torch.int64, device=CUDA)
    sample = 40 + pixel % 4
    bounce1 = pixel % 21 + 1
    ctx = smp.SampleCtx(seed=seed, pixel=pixel, sample=sample,
                        mode=smp.MODE_HALTON, n_set=4)
    bseed = smp.hash_u32(seed, 1, bounce1)
    bctx = ctx._replace(seed=bseed, mode=smp.MODE_INDEPENDENT)
    # (name, entry, the call, its per-lane inputs)
    calls = (
        ("jitter", "sample_2d",
         lambda f: f(ctx, smp.DIM_PIXEL_JITTER), (pixel, sample)),
        ("areal", "sample_2d", lambda f: f(ctx, smp.DIM_AREAL),
         (pixel, sample)),
        ("light_choice", "sample_2d",
         lambda f: f(ctx, smp.DIM_LIGHT_CHOICE), (pixel, sample)),
        ("bounce_seed", "hash_u32", lambda f: f(seed, 1, bounce1),
         (bounce1,)),
        ("bxdf", "sample_2d", lambda f: f(bctx, smp.DIM_EYE_BOUNCE),
         (pixel, sample, bseed)),
        ("roulette", "sample_1d",
         lambda f: f(bctx, smp.DIM_EYE_BOUNCE + 2), (pixel, sample, bseed)))
    entries, sums = [], {"kernel": 0.0, "plain": 0.0, "bound": 0.0, "ops": 0}
    for name, entry, call, inputs in calls:
        kernel, plain = (getattr(smp, entry),
                         getattr(smp, f"{entry}_plain"))
        got, want = call(kernel), call(plain)
        same = (torch.equal(got.view(torch.int32), want.view(torch.int32))
                if got.dtype == torch.float32 else torch.equal(got, want))
        check(same and got.shape == want.shape,
              f"the sampler kernel's {name} differs from the plain version")
        k_ms = queued_ms(lambda: call(kernel))
        p_ms = queued_ms(lambda: call(plain))
        ops = aten_ops(lambda: call(plain))
        b_ms, by = bound(0, nbytes(*inputs, got))
        print(f"    {name} ({entry}): {fmt_ab(None, k_ms, b_ms, 4)}; plain "
              f"{p_ms:.4f} ms in {ops} ATen ops; bit-equal")
        e = kernel_entry(f"sampler_{name}", SAMPLER_SOURCE,
                         SAMPLER_REPLACES, launches.pop(entry, 0), 0.0,
                         k_ms, p_ms, b_ms, by)
        e["plain_ops"] = ops
        entries.append(e)
        for key, v in (("kernel", k_ms), ("plain", p_ms), ("bound", b_ms),
                       ("ops", ops)):
            sums[key] += v
    print(f"    a queued NEE step's {len(calls)} calls: kernel "
          f"{sums['kernel']:.4f} ms in {len(calls)} launches, bound "
          f"{sums['bound']:.4f} ms, plain {sums['plain']:.4f} ms in "
          f"{sums['ops']} ATen ops ({time.perf_counter() - t_phase:.1f} s)")
    return entries


def bxdf_entries(launches):
    """Phase 24, its second half: the BxDF kernel at the box cell's
    SAMPLER_LANES lanes (diffuse and mirror, no mix, no LTC) and at the
    same lanes of the colonnade's lobes (diffuse, LTC-GGX and its diffuse
    mix, the LTC rows read): eval and sample against the plain version
    on the card, bit for bit; each entry's kernel and plain ms
    (`queued_ms`; a backward as `torch.autograd.grad` of a saved forward
    whose leaves are the material fields and the directions themselves),
    the bound by bytes (the per-lane fields read once, the outputs
    written once, the LTC rows once) and the plain version's ATen ops a
    call.  The inputs, ~20 MB, stay in the card's 50 MB L2 between the
    timed calls.  `launches`: the kernel's launches by entry in the
    renders of phases 1-23.  -> the kernel entries; an entry's launches
    are on its first row."""
    import torch_port_scenes as tps
    from rgk_tpu_torch.ops import ltc as ltc_ops

    t_phase = time.perf_counter()
    print(f"    BxDF kernel: launches in the renders of phases 1-23 "
          f"{launches}")
    launches = dict(launches)
    rows = torch.from_numpy(np.array(ltc_ops.load_tables_np())).to(CUDA)
    tables = ltc_ops.LTCTables(rows=rows)
    entries = []
    for scene, types, ltc in (("box", (0, 1), False),
                              ("colonnade", (0, 5, 7), True)):
        pack, mid, vi, vr, u2 = (t.to(CUDA) for t in tps.bxdf_lanes(
            SAMPLER_LANES, 23, types=types))
        p = bx.MatParams(None, None, mid, None,
                         row=pack[mid.long()].contiguous(),
                         has_textures=False)
        fields = (p.diffuse, p.specular, p.roughness, p.ior, p.mix_amt,
                  p.row[:, 12])
        lut = nbytes(rows) if ltc else 0

        def call(name, f, q=p, a=vi, b=vr):
            if name == "eval":
                return (f(None, None, mid, a, b, None, tables, False, ltc,
                          False, p0=q),)
            return f(None, None, mid, a, None, u2, tables, False, ltc, False,
                     p0=q)

        for name in ("eval", "sample"):
            kern, plain = (getattr(bx, f"{name}_bxdf"),
                           getattr(bx, f"{name}_bxdf_plain"))
            got, want = call(name, kern), call(name, plain)
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       if a.dtype == torch.float32 else torch.equal(a, b)
                       for a, b in zip(got, want))
            check(same, f"the BxDF kernel's {name} at the {scene}'s lanes "
                        f"differs from the plain version")
            k_ms = queued_ms(lambda: call(name, kern))
            p_ms = queued_ms(lambda: call(name, plain))
            ops = aten_ops(lambda: call(name, plain))
            b_ms, bound_by = bound(0, nbytes(*fields, vi, vr if name == "eval"
                                             else u2, *got) + lut)
            print(f"    {scene} {name}: {fmt_ab(None, k_ms, b_ms, 4)}; plain "
                  f"{p_ms:.4f} ms in {ops} ATen ops; bit-equal")
            e = kernel_entry(f"bxdf_{name}_{scene}", BXDF_SOURCE,
                             BXDF_REPLACES, launches.pop(name, 0), 0.0, k_ms,
                             p_ms, b_ms, bound_by)
            e["plain_ops"] = ops
            entries.append(e)
        # The backward entries: the leaves are the material fields and
        # the directions, so autograd runs the BxDF's backward alone.
        gen = torch.Generator(device=CUDA).manual_seed(29)
        g_out = [torch.randn(SAMPLER_LANES, 3, device=CUDA, generator=gen)
                 for _ in range(2)]
        for name in ("eval", "sample"):
            times, grads = {}, {}
            for which, fn, dtype in (
                    ("bxdf", f"{name}_bxdf", torch.float32),
                    ("bxdf_plain", f"{name}_bxdf_plain", torch.float32),
                    ("float64", f"{name}_bxdf_plain", torch.float64)):
                outs, wrt, gs = bxdf_graph(name, getattr(bx, fn), p, mid, vi,
                                           vr, u2, tables, ltc, g_out, dtype)
                grads[which] = torch.autograd.grad(
                    outs, wrt, gs, retain_graph=True, allow_unused=True)
                grads[which] = [torch.zeros_like(x) if g is None else g
                                for x, g in zip(wrt, grads[which])]
                if dtype == torch.float64:
                    continue

                def back(outs=outs, wrt=wrt, gs=gs):
                    return torch.autograd.grad(outs, wrt, gs,
                                               retain_graph=True,
                                               allow_unused=True)

                times[which] = queued_ms(back)
            err, gaps = bxdf_grad_gap(*(grads[k] for k in (
                "bxdf", "bxdf_plain", "float64")))
            check(not gaps["bad"], f"the BxDF kernel's {name} backward at "
                  f"the {scene}'s lanes departs from autograd of the plain "
                  f"version: {gaps}")
            n_leaves = 5 if name == "eval" else 4
            by = (nbytes(*fields, vi, vr if name == "eval" else u2)
                  + nbytes(g_out[0]) * (1 if name == "eval" else 2)
                  + nbytes(*grads["bxdf"][:n_leaves]) + lut)
            b_ms, bound_by = bound(0, by)
            print(f"    {scene} {name}_bwd: "
                  f"{fmt_ab(None, times['bxdf'], b_ms, 4)}; plain autograd "
                  f"{times['bxdf_plain']:.4f} ms; against it max abs err "
                  f"{err:.3e} (by leaf: plain non-finite, skipped; beyond "
                  f"rtol 1e-5 of it; the plain version's beyond rtol 1e-5 "
                  f"of float64; elements; the kernel's and the plain "
                  f"version's distance from float64 there, relative) "
                  f"{gaps['by_leaf']}")
            entries.append(kernel_entry(
                f"bxdf_{name}_bwd_{scene}", BXDF_SOURCE, BXDF_REPLACES,
                launches.pop(f"{name}_bwd", 0), err, times["bxdf"],
                times["bxdf_plain"], b_ms, bound_by))
    print(f"    ({time.perf_counter() - t_phase:.1f} s)")
    return entries


def bxdf_graph(name, fn, p, mid, vi, vr, u2, tables, ltc, g_out, dtype):
    """One BxDF call through `fn` in `dtype` whose leaves are fresh copies
    of the lanes' diffuse, specular and roughness and of the directions.
    -> (outputs, leaves, cotangents) for `torch.autograd.grad`: an eval's
    f against g_out[0]; a sample's direction and throughput against
    g_out[0] and g_out[1] (its leaves leave vr out)."""
    from rgk_tpu_torch.ops import ltc as ltc_ops

    q = bx.MatParams(None, None, mid, None, row=p.row.to(dtype),
                     has_textures=False)
    leaves = [t.to(dtype).clone().requires_grad_(True)
              for t in (p.diffuse, p.specular, p.roughness, vi, vr)]
    q.diffuse, q.specular, q.roughness = leaves[:3]
    tb = ltc_ops.LTCTables(rows=tables.rows.to(dtype))
    g_out = [g.to(dtype) for g in g_out]
    if name == "eval":
        f = fn(None, None, mid, leaves[3], leaves[4], None, tb, False, ltc,
               False, p0=q)
        return (f,), leaves, g_out[:1]
    d, t, _ = fn(None, None, mid, leaves[3], None, u2.to(dtype), tb,
                 False, ltc, False, p0=q)
    return (d, t), leaves[:4], g_out


def bxdf_grad_gap(got, want, ref):
    """The BxDF backward's check, leaf by leaf, where the plain float32
    gradient `want` is finite (the card test's criterion): at least 99%
    of the elements of `got` (the kernel's) lie within rtol 1e-5 of it,
    none departs by more than 5% (+ 1e-3 x the leaf's largest), and over
    the elements beyond rtol 1e-5 the kernel lies no farther from the
    float64 gradient `ref` than twice the plain float32 gradient does,
    plus rtol 1e-5 (sums of the distances).  On the colonnade's LTC lanes
    the plain float32 gradient itself lies beyond rtol 1e-5 of float64 on
    more than 1% of some leaves' elements, so a float64-exact backward
    would fail the 99%: there the kernel may have up to twice as many
    elements beyond rtol 1e-5 as the plain gradient has from float64.
    -> (max abs err over the finite elements, {"bad": the leaves that
    fail, "by_leaf": the counts})."""
    names = ("diffuse", "specular", "roughness", "vi", "vr")
    worst, bad, by_leaf = 0.0, [], {}
    for key, a, b, r in zip(names, got, want, ref):
        fin = torch.isfinite(b)
        diff = (a - b).abs()
        far = fin & (diff > 1e-5 * b.abs())
        plain_far = int((fin & ((b.double() - r).abs()
                                > 1e-5 * r.abs())).sum())
        scale = float(b[fin].abs().max()) if fin.any() else 0.0
        wild = far & (diff > 0.05 * b.abs() + 1e-3 * scale)
        err_k = float((a[far].double() - r[far]).abs().sum())
        err_p = float((b[far].double() - r[far]).abs().sum())
        size = float(r[far].abs().sum())
        if fin.any():
            worst = max(worst, float(diff[fin].max()))
        by_leaf[key] = (int((~fin).sum()), int(far.sum()), plain_far,
                        b.numel(), f"{err_k / max(size, 1e-300):.2e}",
                        f"{err_p / max(size, 1e-300):.2e}")
        if (int(far.sum()) > max(0.01 * b.numel(), 2 * plain_far)
                or bool(wild.any()) or err_k > 2 * err_p + 1e-5 * size):
            bad.append(key)
    return worst, {"bad": bad, "by_leaf": by_leaf}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="CSRC", help="an earlier version's "
                    "csrc/ directory: its K1-K5 are timed in turns with "
                    "this tree's in phases 3-5, 7, 9, 10 and 22")
    ap.add_argument("--profile", action="store_true", help="phases 5, 7, "
                    "10 (RGK_BINNED=all) and 14 render once more under "
                    "torch.profiler and print the round's kernel time and "
                    "the device's busy share (phase 20 always profiles a "
                    "block of each scene on both routes)")
    return ap.parse_args(argv)


def main(argv=None):
    global PROFILE
    args = parse_args(argv)
    PROFILE = args.profile
    t_all = time.perf_counter()
    phase_device()
    phase_build(args.parent)
    dev = torch.device("cuda")
    phase_k1(dev)
    trees = phase_k2(dev)
    with tempfile.TemporaryDirectory() as d:
        entries, k5_flat = phase_render(d)
        phase_cpu_parity(d)
        k2_entries, col_path, col_img, k5_col = phase_colonnade(d)
        entries += k2_entries
        small = phase_colonnade_parity(d)
        phase_binned_soup(dev, trees)
        binned_entries, k5_binned = phase_binned_colonnade(d, col_path,
                                                           col_img)
        entries += binned_entries
        phase_binned_small(d, *small)
        entries += phase_probes(dev)
        glass = phase_glass(d)
        bdpt1, k1_bdpt, k5_bdpt1 = phase_bdpt_k1(d)
        bdpt2, k2_bdpt, k5_bdpt2 = phase_bdpt_k2(d)
        k1_grad, k5_grad1, grad_path, gathers = phase_grad_k1(d)
        k2_grad, k5_grad2 = phase_grad_k2(d)
        k1_debug, k5_debug = phase_debug_rtc(d)
        k1_dist, k5_dist = phase_distribution(d)
        _, setter, stamp = phase_graph(
            os.path.join(d, f"box_sphere_{FLAT_RES}.json"), col_path,
            os.path.join(d, "bdpt.json"))
        lanes = phase_lane_graph(d, col_path)
        k5_entries = phase_take_rows(grad_path, gathers)
        k1_bdpt_grad, k5_bdpt_grad = phase_grad_bdpt(d)
    # The sampler, K1, K2 and K5 rows count every run of their kernel's
    # paths, each set to 0 just before the run and read just after it.
    launches = add_counts(*SAMPLER_RUNS)
    check(all(launches[e] > 0 for e in ("hash_u32", "sample_1d",
                                         "sample_2d")),
          f"the renders did not go through the sampler kernel: {launches}")
    sampler = phase_sampler(launches)
    bx_launches = add_counts(*BXDF_RUNS)
    check(all(bx_launches[e] > 0 for e in bx_launches),
          f"the renders did not go through every BxDF entry: {bx_launches}")
    sampler += bxdf_entries(bx_launches)
    k5 = add_counts(k5_flat, k5_col, *k5_binned.values(), glass["K5"],
                    k5_bdpt1, k5_bdpt2, k5_grad1, k5_grad2, k5_debug,
                    k5_dist, lanes["K5"], k5_bdpt_grad)
    for e, key in zip(k5_entries, ("forward", "backward")):
        check(k5[key] > 0, f"no path launched K5's {key}")
        e["launches"] = k5[key]
    more = {"flat_intersect": (glass["K1"], k1_bdpt, k1_grad, k1_debug,
                               k1_dist, lanes["K1"], k1_bdpt_grad),
            "cluster_intersect": (glass["K2"], k2_bdpt, k2_grad,
                                  lanes["K2"])}
    for e in entries:
        for kernel, mode in (("flat_intersect", "closest"),
                             ("flat_intersect", "any"),
                             ("cluster_intersect", "closest"),
                             ("cluster_intersect", "any")):
            if e["name"] == f"{kernel}_{mode}":
                e["launches"] += sum(m[mode] for m in more[kernel])
    setter["launches"] = sum(SETTER_RUNS)
    check(setter["launches"] > 0, "no path ran the condition setter")
    stamp["launches"] = sum(STAMP_RUNS)
    check(len(STAMP_RUNS) == 8 and all(STAMP_RUNS),
          f"the phase stamp's launches by path: {STAMP_RUNS}")
    entries += bdpt1 + bdpt2 + k5_entries + [setter, stamp] + sampler
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
