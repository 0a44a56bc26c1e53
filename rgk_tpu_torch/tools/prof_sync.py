"""P2: the per-iteration cost of a loop whose reduction is consumed, on
the card (port of the reference's tools/prof_sync.py, which timed the
TPU's vector->scalar sync; kernels in csrc/probes.cu).

    python -m rgk_tpu_torch.tools.prof_sync [--iters 20000] [--reps 5]

One block of 1024 threads holds the reference's [8, 128] values, one a
thread, and loops `--iters` times.  The TPU's vector->scalar reduction
becomes a block vote (`__syncthreads_or`); each variant returns the
reference's carry `s` per thread:
  a       the work only, its result unused (s = 0);
  b       a vote on v + i > thresh, consumed the same iteration;
  c       the same vote consumed one iteration late;
  d / e   a vote on v plus one / eight table reads;
  f       a vote on a slab test of six table reads (the walk's node test);
  f_warp  f with a warp vote (`__any_sync`) in place of the block's;
  g       f with one vote per row of 128, packed into power-of-two bits;
  nested  f in an inner loop of three iterations per outer one;
  sweep   one Badouel sweep of a [16, 128] tile (128 triangles, read as
          a one-tile cluster pack, against 128 rays from the same tile:
          row k of column l is coordinate k of ray l) per iteration, by
          one row of threads, for iters / 10 iterations;
  sweep8  the same behind 8 branches, one taken per iteration;
  fetch D [16, 128] f32 tiles fetched with cp.async, D = 1, 2, 4 or 8
          copies in flight; s counts fetched tiles whose first value is
          above thresh.
The sweeps return each lane's least hit t in place of s.  The inputs are
made from a seed (values in [-1, 1]) so that every vote both passes and
fails; the reference's (ones, 0..127) made every s zero.  ns/iteration
are the mean over `--reps` launches, CUDA events around each.

Each wrapper launches its kernel for a CUDA tensor, or raises, and takes
its plain version for a CPU tensor.  `launches` counts kernel launches;
nothing else adds to it.  Without a CUDA device `main` exits with 2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import kernels
from ..ops import cluster_intersect as ci

THREADS = 1024
TABLE = 128
TILE = (16, 128)
N_TILES = 64
VARIANTS = ("a", "b", "c", "d", "e", "f", "f_warp", "g", "nested", "sweep",
            "sweep8")
DEPTHS = (1, 2, 4, 8)
DEFAULT_ITERS, DEFAULT_REPS = 20000, 5
SWEEP_T_MAX = 1e30
# Iterations per plain-version chunk, to bound its [iterations, 1024]
# planes.
_CHUNK = 1024

launches = {"sync": 0, "fetch": 0}


def thresh(variant: str, iters: int) -> float:
    """The vote threshold of a variant: b and c compare v + i, so half
    the iterations pass; the others compare values near 1."""
    return iters / 2.0 if variant in ("b", "c") else 1.0


def inputs(dev, seed: int = 0):
    """-> (x f32 [1024], table f32 [128], tile f32 [2048], tiles f32
    [64 * 2048]) from `seed`."""
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1, 1, THREADS), rng.uniform(-1, 1, TABLE),
            rng.uniform(-1, 1, TILE[0] * TILE[1]),
            rng.uniform(-1, 1, N_TILES * TILE[0] * TILE[1]))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def n_iterations(variant: str, iters: int) -> int:
    """The loop iterations a variant runs (inner ones for nested)."""
    if variant in ("sweep", "sweep8"):
        return iters // 10
    if variant == "nested":
        return 3 * (iters // 4)
    return iters


# ------------------------------------------------------------ the wrappers

def _lib_stream(dev):
    return kernels.load(), torch.cuda.current_stream(dev).cuda_stream


def sync(variant: str, x, table, iters: int, thr: float):
    """-> (s i32 [1024], least t f32 [1024] of the sweeps, else 1e30).
    x is the [16, 128] tile (2048 values) for the sweeps, else [1024]."""
    v = VARIANTS.index(variant)
    if x.device.type == "cpu":
        return sync_plain(variant, x, table, iters, thr)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no sync probe kernel for {x.device}")
    want = TILE[0] * TILE[1] if variant.startswith("sweep") else THREADS
    if x.shape != (want,) or x.dtype != torch.float32 or table.shape != (
            TABLE,) or table.dtype != torch.float32:
        raise ValueError(f"{variant}: x must be f32 [{want}], table f32 "
                         f"[{TABLE}]")
    lib, stream = _lib_stream(x.device)
    s = torch.empty(THREADS, dtype=torch.int32, device=x.device)
    st = torch.full((THREADS,), SWEEP_T_MAX, dtype=torch.float32,
                    device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.rgk_probe_sync(v, x.data_ptr(), table.data_ptr(), iters, thr,
                                s.data_ptr(), st.data_ptr(), stream)
    kernels.check_launch(rc, f"sync {variant} probe")
    launches["sync"] += 1
    return s, st


def fetch(tiles, depth: int, iters: int, thr: float):
    """-> s i32 [1024]: the fetch loop at `depth` copies in flight over
    tiles f32 [n * 2048] (tile i % n at iteration i)."""
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    n = tiles.shape[0] // (TILE[0] * TILE[1])
    if tiles.device.type == "cpu":
        return fetch_plain(tiles, depth, iters, thr)
    if tiles.device.type != "cuda":
        raise NotImplementedError(f"no fetch probe kernel for {tiles.device}")
    if tiles.dtype != torch.float32 or not tiles.is_contiguous() or not n:
        raise ValueError("tiles must be contiguous f32 [n * 2048]")
    lib, stream = _lib_stream(tiles.device)
    s = torch.empty(THREADS, dtype=torch.int32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        rc = lib.rgk_probe_fetch(tiles.data_ptr(), n, depth, iters, thr,
                                 s.data_ptr(), stream)
    kernels.check_launch(rc, f"fetch depth {depth} probe")
    launches["fetch"] += 1
    return s


# --------------------------------------------------------- the plain versions

def _slab(v, tab, n):
    """The kernel's slab-like test of values v [1024] against table
    entries n .. n+5 ([I] offsets) -> bool [I, 1024]."""
    t = [(tab[n + k][:, None] - v[None, :]) * v[None, :] for k in range(6)]
    tn = torch.maximum(torch.maximum(torch.minimum(t[0], t[1]),
                                     torch.minimum(t[2], t[3])),
                       torch.minimum(t[4], t[5]))
    tf = torch.minimum(torch.minimum(torch.maximum(t[0], t[1]),
                                     torch.maximum(t[2], t[3])),
                       torch.maximum(t[4], t[5]))
    return (tf >= tn) & (tf >= 0.0)


def _pred(variant, x, tab, it, thr):
    """The per-thread predicate [I, 1024] of iterations `it` (int64)."""
    if variant in ("b", "c"):
        return x[None, :] + it.to(torch.float32)[:, None] > thr
    if variant == "d":
        return x[None, :] + tab[it & 63][:, None] > thr
    if variant == "e":
        w = x[None, :].expand(it.numel(), -1)
        for k in range(8):
            w = w + tab[(it + k) & 63][:, None]
        return w > thr
    return _slab(x, tab, it & 63)


def sync_plain(variant: str, x, table, iters: int, thr: float):
    """The kernel's function in plain PyTorch, on any device."""
    dev = x.device
    s = torch.zeros(THREADS, dtype=torch.int64, device=dev)
    st = torch.full((THREADS,), SWEEP_T_MAX, dtype=torch.float32, device=dev)
    if variant.startswith("sweep"):
        n_it = iters // 10
        rows = ci.tri_major(x.view(*TILE))                      # [128, 16]
        tile = x.view(*TILE)
        ro, rd = tile[0:3].T.contiguous(), tile[3:6].T.contiguous()
        lane_t = torch.full((TILE[1],), SWEEP_T_MAX, dtype=torch.float32,
                            device=dev)
        best, _ = ci._sweep(
            rows[None].expand(TILE[1], -1, -1), ro, rd,
            torch.zeros_like(lane_t), lane_t, torch.full(
                (TILE[1],), -1, dtype=torch.int32, device=dev),
            lane_t, torch.full((TILE[1],), -1, dtype=torch.int32,
                               device=dev), False)
        for r in range(THREADS // TILE[1]):
            swept = (r == 0 and n_it > 0) if variant == "sweep" else (
                (8 - r) % 8 < n_it)
            if swept:
                st[r * TILE[1]:(r + 1) * TILE[1]] = best
        return s.to(torch.int32), st
    if variant == "a":
        return s.to(torch.int32), st
    if variant == "nested":
        outer = torch.arange(iters // 4, device=dev)
        its = (4 * outer[:, None] + torch.arange(3, device=dev)).flatten()
    else:
        its = torch.arange(iters, device=dev)
    if variant == "c":
        its = its[:-1]  # the last vote is never consumed
    for c in range(0, its.numel(), _CHUNK):
        p = _pred(variant, x, table, its[c:c + _CHUNK], thr)
        if variant == "f_warp":
            s += p.view(p.shape[0], -1, 32).any(dim=2).sum(dim=0) \
                .repeat_interleave(32)
        elif variant == "g":
            rows = p.view(p.shape[0], -1, TILE[1]).any(dim=2).to(torch.int64)
            s += (rows << torch.arange(rows.shape[1], device=dev)).sum()
        else:
            s += p.any(dim=1).sum()
    return s.to(torch.int32), st


def fetch_plain(tiles, depth: int, iters: int, thr: float):
    """The fetch loop's s in plain PyTorch: tiles (i - depth) % n read
    at iterations depth .. iters-1."""
    n = tiles.shape[0] // (TILE[0] * TILE[1])
    first = tiles.view(n, -1)[:, 0]
    it = torch.arange(depth, iters, device=tiles.device)
    s = (first[(it - depth) % n] > thr).sum() if it.numel() else 0
    return torch.full((THREADS,), int(s), dtype=torch.int32,
                      device=tiles.device)


# ------------------------------------------------------------ entry point

def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Per-iteration cost of block votes, table reads, a slab "
        "test, a Badouel sweep and cp.async tile fetches (P2).")
    ap.add_argument("--iters", type=int, default=DEFAULT_ITERS)
    ap.add_argument("--reps", type=int, default=DEFAULT_REPS)
    return ap.parse_args(argv)


def _time_ms(fn, reps):
    fn()  # the first launch pays the module load
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return sum(ms) / len(ms)


def run(dev, iters: int, reps: int, verbose: bool = True):
    """Every variant on the card against its plain version.  -> list of
    (name, ns/iteration, ms/launch, outputs equal the plain version's,
    max |t error| of the sweeps)."""
    x, table, tile, tiles = inputs(dev)
    rows = []
    for v in VARIANTS:
        xin = tile if v.startswith("sweep") else x
        thr = thresh(v, iters)
        s, st = sync(v, xin, table, iters, thr)
        ps, pst = sync_plain(v, xin, table, iters, thr)
        err = float((st - pst).abs().max())
        same = bool(torch.equal(s, ps)) and bool(torch.allclose(
            st, pst, rtol=3e-4, atol=1e-6))
        ms = _time_ms(lambda: sync(v, xin, table, iters, thr), reps)
        rows.append((v, ms * 1e6 / max(n_iterations(v, iters), 1), ms, same,
                     err))
    for d in DEPTHS:
        s = fetch(tiles, d, iters, 0.0)
        same = bool(torch.equal(s, fetch_plain(tiles, d, iters, 0.0)))
        ms = _time_ms(lambda: fetch(tiles, d, iters, 0.0), reps)
        rows.append((f"fetch depth {d}", ms * 1e6 / max(iters, 1), ms, same,
                     0.0))
    if verbose:
        for name, ns, _, same, _ in rows:
            unit = "ns/inner-iteration" if name == "nested" else (
                "ns/tile" if name.startswith("fetch") else "ns/iteration")
            print(f"{name}: {ns:8.1f} {unit}"
                  f"{'' if same else '  (DIFFERS from the plain version)'}")
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_sync: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}")
    rows = run(dev, args.iters, args.reps)
    return 0 if all(r[3] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
