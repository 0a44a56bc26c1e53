"""Stateless counter-based sampling (port of rgk_tpu/ops/sampler.py).

Every sample value is a pure function of ``(seed, pixel_index,
sample_index, dimension)``, bitwise equal to the reference's for the
same inputs, in all five modes (independent, halton, stratified, lhs,
vdc).  Because the generator is counter-based, the render path needs
no ``torch.Generator`` and no random state at all: re-rendering with
the same seed is bitwise identical, and any lane can be recomputed on
its own.

uint32 arithmetic on int64: PyTorch's CPU build has no ``>>`` for
uint32, so a "u32" here is an int64 tensor holding a value in
[0, 2^32), masked with ``& 0xFFFFFFFF`` after every operation that can
leave that range.  A 32x32-bit multiply is done as two products with
the 16-bit halves of the constant, so no int64 product overflows
(``0x846CA68B * x`` alone would).  The u32 -> f32 conversions and the
Halton float accumulation keep the reference's op order, so values
stay bitwise equal.

Those int64 functions are the plain version (`hash_u32_plain`,
`hash01_plain`, `sample_1d_plain`, `sample_2d_plain`), which the public
functions take on a CPU tensor.  On a CUDA tensor each call of
`hash_u32`, `sample_1d` or `sample_2d` is one launch of the sampler
kernel (`csrc/sampler.cu`, built at first use by `rgk_tpu_torch.kernels`),
native uint32 arithmetic, bit for bit the plain version's on the CPU;
another device raises.  A part of a hash,
and a context's seed, pixel and sample, may be a Python int, a 0-d
tensor or a tensor of the lanes' shape (the shapes broadcast as the
plain version's ops broadcast them).  `hash01` is `hash_u32`'s top 24
bits.  `launches` counts the kernel's launches by entry; nothing else
adds to it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Union

import numpy as np
import torch

# First 256 primes — the reference's Halton dimension range.
_PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37,
    41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89,
    97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
    157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223,
    227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281,
    283, 293, 307, 311, 313, 317, 331, 337, 347, 349, 353, 359,
    367, 373, 379, 383, 389, 397, 401, 409, 419, 421, 431, 433,
    439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499, 503,
    509, 521, 523, 541, 547, 557, 563, 569, 571, 577, 587, 593,
    599, 601, 607, 613, 617, 619, 631, 641, 643, 647, 653, 659,
    661, 673, 677, 683, 691, 701, 709, 719, 727, 733, 739, 743,
    751, 757, 761, 769, 773, 787, 797, 809, 811, 821, 823, 827,
    829, 839, 853, 857, 859, 863, 877, 881, 883, 887, 907, 911,
    919, 929, 937, 941, 947, 953, 967, 971, 977, 983, 991, 997,
    1009, 1013, 1019, 1021, 1031, 1033, 1039, 1049, 1051, 1061, 1063, 1069,
    1087, 1091, 1093, 1097, 1103, 1109, 1117, 1123, 1129, 1151, 1153, 1163,
    1171, 1181, 1187, 1193, 1201, 1213, 1217, 1223, 1229, 1231, 1237, 1249,
    1259, 1277, 1279, 1283, 1289, 1291, 1297, 1301, 1303, 1307, 1319, 1321,
    1327, 1361, 1367, 1373, 1381, 1399, 1409, 1423, 1427, 1429, 1433, 1439,
    1447, 1451, 1453, 1459, 1471, 1481, 1483, 1487, 1489, 1493, 1499, 1511,
    1523, 1531, 1543, 1549, 1553, 1559, 1567, 1571, 1579, 1583, 1597, 1601,
    1607, 1609, 1613, 1619,
)

MODE_INDEPENDENT = 0
MODE_HALTON = 1
MODE_STRATIFIED = 2
MODE_LHS = 3
MODE_VDC = 4

MODE_NAMES = {
    "independent": MODE_INDEPENDENT,
    "halton": MODE_HALTON,
    "stratified": MODE_STRATIFIED,
    "lhs": MODE_LHS,
    "latin_hypercube": MODE_LHS,
    "vandercorput": MODE_VDC,
    "vdc": MODE_VDC,
}

_M32 = 0xFFFFFFFF

U32 = Union[int, torch.Tensor]

launches = {"hash_u32": 0, "sample_1d": 0, "sample_2d": 0}


class SampleCtx(NamedTuple):
    """Per-lane sampling context.

    seed:   root seed, a u32 (python int or int64 tensor)
    pixel:  int64 [...] pixel index (y * xres + x) per lane
    sample: int64 [...] global sample index per lane
    mode:   one of MODE_*
    n_set:  samples per stratification set (the round's multisample)
    """

    seed: U32
    pixel: torch.Tensor
    sample: torch.Tensor
    mode: int = 1
    n_set: int = 1


def _u32(p: U32) -> U32:
    if isinstance(p, torch.Tensor):
        return p.to(torch.int64) & _M32
    return int(p) & _M32


def _mul32(x: U32, c: int) -> U32:
    """(x * c) mod 2^32 for a u32 `x` and a constant `c`, without an
    int64 product above 2^49."""
    if not isinstance(x, torch.Tensor):
        return (x * c) & _M32
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x: U32) -> U32:
    """murmur3 finalizer: a high-quality 32-bit bit mixer."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_u32_plain(*parts: U32) -> U32:
    """`hash_u32` in int64 PyTorch ops."""
    h = 0x9E3779B9
    for p in parts:
        h = _mix(h ^ _mul32(_u32(p), 0x85EBCA6B))
    return h


def hash_u32(*parts: U32) -> U32:
    """Combine integer arrays into one well-mixed u32 (an int64 tensor
    of u32 values, or a Python int when no part is a tensor).  At most
    `MAX_CARD_PARTS` parts on a card."""
    dev = _device(parts)
    if dev is None or dev.type == "cpu":
        return hash_u32_plain(*parts)
    return _launch_hash(parts, dev)


def hash01(*parts: U32) -> torch.Tensor:
    return _u32_to_unit_float(hash_u32(*parts))


def _u32_to_unit_float(u: torch.Tensor) -> torch.Tensor:
    # Top 24 bits -> [0, 1) with full float32 resolution (exact).
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash01_plain(*parts: U32) -> torch.Tensor:
    """`hash01` in int64 PyTorch ops."""
    return _u32_to_unit_float(hash_u32_plain(*parts))


def _radical_inverse(index: torch.Tensor, base: int) -> torch.Tensor:
    """Radical inverse of the u32 `index` in integer `base`."""
    if base == 2:
        v = _u32(index)
        v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
        v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
        v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
        v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
        v = (v >> 16) | ((v << 16) & _M32)
        return v.to(torch.float32) * 2.3283064365386963e-10
    # float32 scalars advance exactly as the reference's jnp.float32s.
    inv_base = np.float32(1.0 / base)
    n_digits = int(math.ceil(32.0 / math.log2(base)))
    idx = _u32(index)
    result = torch.zeros(index.shape, dtype=torch.float32,
                         device=index.device)
    scale = np.float32(1.0)
    for _ in range(n_digits):
        digit = (idx % base).to(torch.float32)
        idx = idx // base
        scale = np.float32(scale * inv_base)
        result = result + digit * float(scale)
    return result


def _permute(idx: torch.Tensor, n: int, key: U32) -> torch.Tensor:
    """Stateless pseudorandom permutation of [0, n) by cycle-walking a
    hash (Kensler-style), as in the reference."""
    if n <= 1:
        return torch.zeros_like(idx)
    w = max(1, (n - 1).bit_length())
    mask = (1 << w) - 1

    def round_fn(x, k):
        x = x ^ k
        x = _mul32(x, 0xE170893D) & mask
        x = x ^ (x >> max(1, w // 2))
        x = _mul32(x, 0x929E3149) & mask
        x = x ^ (x >> max(1, (w + 1) // 2))
        return x & mask

    x = _u32(idx) & mask
    for i in range(6):
        k = _mix(key ^ (0x9E3779B9 + i))
        cand = round_fn(x, k)
        x = torch.where(x >= n, cand, x)
    return x % n


def _stratified_1d(ctx: SampleCtx, dim: int) -> torch.Tensor:
    n = max(1, ctx.n_set)
    s_local = _u32(ctx.sample) % n
    key = hash_u32_plain(ctx.pixel, dim, ctx.seed, _u32(ctx.sample) // n)
    stratum = _permute(s_local, n, key).to(torch.float32)
    jit = hash01_plain(ctx.pixel, ctx.sample, dim, ctx.seed)
    return (stratum + jit) / float(n)


def _stratified_2d(ctx: SampleCtx, dim: int) -> torch.Tensor:
    n = max(1, ctx.n_set)
    n2 = int(math.ceil(math.sqrt(n)))
    s_local = _u32(ctx.sample) % n
    key = hash_u32_plain(ctx.pixel, dim, ctx.seed, _u32(ctx.sample) // n)
    stratum = _permute(s_local, n2 * n2, key)
    cx = (stratum % n2).to(torch.float32)
    cy = (stratum // n2).to(torch.float32)
    jx = hash01_plain(ctx.pixel, ctx.sample, dim, ctx.seed)
    jy = hash01_plain(ctx.pixel, ctx.sample, dim + 1, ctx.seed)
    return torch.stack([(cx + jx) / float(n2), (cy + jy) / float(n2)], dim=-1)


def _vdc_1d(ctx: SampleCtx, dim: int) -> torch.Tensor:
    scramble = hash_u32_plain(ctx.pixel, dim, ctx.seed)
    v = _radical_inverse(_u32(ctx.sample) ^ scramble, 2)
    shift = hash01_plain(ctx.pixel, dim + 97, ctx.seed)
    u = v + shift
    return u - torch.floor(u)


def sample_1d(ctx: SampleCtx, dim: int) -> torch.Tensor:
    """Deterministic uniform [0,1) for (lane, dim)."""
    dev = _device((ctx.seed, ctx.pixel, ctx.sample))
    if dev.type == "cpu":
        return sample_1d_plain(ctx, dim)
    return _launch_sample(ctx, dim, dev, "sample_1d")


def sample_2d(ctx: SampleCtx, dim: int) -> torch.Tensor:
    """Deterministic uniform [0,1)^2 consuming dims (dim, dim+1)."""
    dev = _device((ctx.seed, ctx.pixel, ctx.sample))
    if dev.type == "cpu":
        return sample_2d_plain(ctx, dim)
    return _launch_sample(ctx, dim, dev, "sample_2d")


def sample_1d_plain(ctx: SampleCtx, dim: int) -> torch.Tensor:
    """`sample_1d` in int64 PyTorch ops."""
    if ctx.mode == MODE_HALTON and dim < len(_PRIMES):
        v = _radical_inverse(ctx.sample, _PRIMES[dim])
        # Cranley-Patterson rotation decorrelates pixels & dimensions.
        u = v + hash01_plain(ctx.pixel, dim, ctx.seed)
        u = u - torch.floor(u)
    elif ctx.mode in (MODE_STRATIFIED, MODE_LHS) and ctx.n_set > 1:
        u = _stratified_1d(ctx, dim)
    elif ctx.mode == MODE_VDC:
        u = _vdc_1d(ctx, dim)
    else:
        u = hash01_plain(ctx.pixel, ctx.sample, dim, ctx.seed)
    return torch.clamp(u, max=1.0 - 1e-7)


def sample_2d_plain(ctx: SampleCtx, dim: int) -> torch.Tensor:
    """`sample_2d` in int64 PyTorch ops."""
    if ctx.mode == MODE_STRATIFIED and ctx.n_set > 1:
        return _stratified_2d(ctx, dim)
    return torch.stack([sample_1d_plain(ctx, dim),
                        sample_1d_plain(ctx, dim + 1)], dim=-1)


# The kernel's side (csrc/sampler.cu): a part's kinds and the routes of
# a sample's components.
_CONST, _INT64 = 0, 1
_INDEPENDENT, _HALTON, _STRAT1D, _VDC, _STRAT2D = range(5)
MAX_CARD_PARTS = 8  # csrc/sampler.cu kMaxParts


class _Part(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                ("value", ctypes.c_uint32), ("kind", ctypes.c_int)]


class _SampleSpec(ctypes.Structure):
    _fields_ = [("seed", _Part), ("pixel", _Part), ("sample", _Part),
                ("comps", ctypes.c_int), ("route", ctypes.c_int * 2),
                ("dim", ctypes.c_uint32 * 2), ("base", ctypes.c_uint32 * 2),
                ("inv_base", ctypes.c_float * 2), ("n_set", ctypes.c_int),
                ("n2", ctypes.c_int)]


def _device(parts):
    """The device a call runs on: a CUDA device if a part lies on one
    (a 0-d tensor elsewhere is read as a constant), else the parts'
    device, else None (no tensor part)."""
    devs = [p.device for p in parts if isinstance(p, torch.Tensor)]
    dev = max(devs, key=lambda d: d.type == "cuda", default=None)
    if dev is not None and dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no sampler kernel for device {dev}")
    return dev


def _lane_parts(parts, dev):
    """-> (the lanes' shape, a `_Part` each, the tensors they point
    into, which the caller holds until its launch is queued).  A tensor
    of one element is read with stride 0, a contiguous
    one of the lanes' shape with stride 1; another is broadcast and
    copied; a type other than int64 is cast to int64."""
    # numpy's broadcast: torch.broadcast_shapes imports sympy (seconds).
    shape = torch.Size(np.broadcast_shapes(*(
        tuple(p.shape) for p in parts
        if isinstance(p, torch.Tensor) and p.device == dev)))
    specs, keep = [], []
    for p in parts:
        if not isinstance(p, torch.Tensor) or p.device != dev:
            specs.append(_Part(None, 0, int(p) & _M32, _CONST))
            continue
        if p.dtype != torch.int64:
            p = p.to(torch.int64)
        if p.numel() == 1:
            stride = 0
        else:
            if p.shape != shape or not p.is_contiguous():
                p = p.expand(shape).contiguous()
            stride = 1
        specs.append(_Part(p.data_ptr(), stride, 0, _INT64))
        keep.append(p)
    return shape, specs, keep


def _on_card(dev, entry, *args):
    """Calls the library's `entry` with `args` and the current stream of
    the card `dev`, and raises unless it launched."""
    from .. import kernels

    with torch.cuda.device(dev):
        rc = entry(*args, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(rc, "sampler")


def _launch_hash(parts, dev):
    """`hash_u32` on the card: one launch."""
    from .. import kernels

    if len(parts) > MAX_CARD_PARTS:
        raise ValueError(f"hash_u32 takes at most {MAX_CARD_PARTS} parts "
                         f"on a card, got {len(parts)}")
    shape, specs, keep = _lane_parts(parts, dev)
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    arr = (_Part * len(specs))(*specs)
    _on_card(dev, kernels.load().rgk_sampler_hash, ctypes.addressof(arr),
             len(specs), out.numel(), out.data_ptr())
    launches["hash_u32"] += 1
    return out


def _route(ctx, dim):
    """The route and Halton base `sample_1d_plain` takes for `dim`."""
    if ctx.mode == MODE_HALTON and dim < len(_PRIMES):
        return _HALTON, _PRIMES[dim]
    if ctx.mode in (MODE_STRATIFIED, MODE_LHS) and ctx.n_set > 1:
        return _STRAT1D, 0
    if ctx.mode == MODE_VDC:
        return _VDC, 0
    return _INDEPENDENT, 0


def _launch_sample(ctx, dim, dev, entry):
    """`sample_1d` or `sample_2d` on the card: one launch."""
    from .. import kernels

    comps = 1 if entry == "sample_1d" else 2
    shape, (seed, pixel, sample), keep = _lane_parts(
        (ctx.seed, ctx.pixel, ctx.sample), dev)
    spec = _SampleSpec(seed=seed, pixel=pixel, sample=sample, comps=comps,
                       n_set=max(1, ctx.n_set))
    if comps == 2 and ctx.mode == MODE_STRATIFIED and ctx.n_set > 1:
        spec.route[:] = (_STRAT2D, _STRAT2D)
        spec.dim[:] = (dim & _M32, (dim + 1) & _M32)
        spec.n2 = int(math.ceil(math.sqrt(ctx.n_set)))
    else:
        for c in range(comps):
            route, base = _route(ctx, dim + c)
            spec.route[c], spec.dim[c] = route, (dim + c) & _M32
            spec.base[c] = base
            spec.inv_base[c] = float(np.float32(1.0 / base)) if base else 0.0
    out = torch.empty(shape + ((2,) if comps == 2 else ()),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _on_card(dev, kernels.load().rgk_sampler_sample, ctypes.addressof(spec),
             out.numel() // comps, out.data_ptr())
    launches[entry] += 1
    return out


# Dimension ledger of the integrator (the reference's, unchanged).
DIM_PIXEL_JITTER = 0      # 2D subpixel offset
DIM_LENS = 2              # 2D thin-lens disc sample
DIM_AREAL = 4             # 2D areal-light surface sample
DIM_LIGHTDIR = 6          # 2D light-subpath emission direction (BDPT)
DIM_LIGHT_CHOICE = 8      # 2D light pick
DIM_LIGHT_TRI = 10        # 1D, drawn by the reference and discarded by its
#                           light pick; counter-based, so the port never
#                           draws it and no other value moves
DIM_EYE_BOUNCE = 11       # 3 dims per bounce (tag 1 eye, tag 2 light
#                           path): bxdf 2D + russian 1D
