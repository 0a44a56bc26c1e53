"""The sampler's arithmetic pinned by a numpy uint32 / float32 model.

`_Model` computes `_mix`, `hash_u32`, `_radical_inverse`, `_permute` and
the five modes with numpy's uint32 (wrapping) and float32 types, apart
from the port's int64 emulation and with its own prime table; it is the
arithmetic the sampler kernel (`rgk_tpu_torch/csrc/sampler.cu`) does.
The plain version (`*_plain` in `rgk_tpu_torch/ops/sampler.py`) is held
to it bit for bit at the edges: seeds 0 and 2^32-1, samples 0, 2^31-1,
2^32-1 and 2^32+5, pixel ids up to 2^22, dims 0-12 and 255-257 (the end
of Halton's prime table), `n_set` 1, 2, 4, 8 and 9, and each part as a
Python int, a 0-d tensor or a tensor a lane.

The kernel runs only on a card (tests/test_torch_cuda.py holds it to
the plain version there).  Here the wrapper's launches go to
`_EmulatedLib`, the kernel's C entry points computed by the model over
host memory, so the CPU checks what the wrapper hands the kernel: the
argument structs, strides, routes and Halton bases.  CPU tensors take
the plain version and count no launch, a CPU render included.

Tolerance: none; floats are compared as bit patterns.
"""

import ctypes
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch import kernels
from rgk_tpu_torch.integrator import graph
from rgk_tpu_torch.ops import sampler as smp

U = np.uint32
F = np.float32
M32 = 0xFFFFFFFF
SEEDS = (0, 2**32 - 1)
DIMS = tuple(range(13)) + (255, 256, 257)
N_SETS = (1, 2, 4, 8, 9)
MODES = (smp.MODE_INDEPENDENT, smp.MODE_HALTON, smp.MODE_STRATIFIED,
         smp.MODE_LHS, smp.MODE_VDC)


def _primes(n):
    """The first `n` primes, by trial division."""
    out = []
    k = 2
    while len(out) < n:
        if all(k % p for p in out if p * p <= k):
            out.append(k)
        k += 1
    return out


class _Model:
    """The sampler in numpy uint32 / float32 (module doc).  Parts are
    uint32 arrays, or Python ints taken mod 2^32."""

    PRIMES = _primes(256)

    @staticmethod
    def u32(p):
        if isinstance(p, np.ndarray):
            return p.astype(np.int64).astype(U) if p.dtype != U else p
        return U(int(p) & M32)

    @staticmethod
    def mix(x):
        with np.errstate(over="ignore"):
            x = x ^ (x >> U(16))
            x = x * U(0x7FEB352D)
            x = x ^ (x >> U(15))
            x = x * U(0x846CA68B)
            return x ^ (x >> U(16))

    @classmethod
    def hash(cls, *parts):
        h = U(0x9E3779B9)
        with np.errstate(over="ignore"):
            for p in parts:
                h = cls.mix(h ^ (cls.u32(p) * U(0x85EBCA6B)))
        return np.asarray(h, dtype=U)

    @staticmethod
    def unit(u):
        return (u >> U(8)).astype(F) * F(2.0**-24)

    @staticmethod
    def radical_inverse(idx, base):
        idx = np.array(idx, dtype=U)
        if base == 2:
            rev = np.zeros_like(idx)
            for b in range(32):
                rev |= ((idx >> U(b)) & U(1)) << U(31 - b)
            return rev.astype(F) * F(2.0**-32)
        inv = F(1.0 / base)
        scale = F(1.0)
        result = np.zeros(idx.shape, F)
        while idx.any():
            digit = (idx % U(base)).astype(F)
            idx = idx // U(base)
            scale = F(scale * inv)
            result = result + digit * scale
        return result

    @classmethod
    def permute(cls, idx, n, key):
        w = max(1, (n - 1).bit_length())
        mask = U((1 << w) - 1)
        s1, s2 = U(max(1, w // 2)), U(max(1, (w + 1) // 2))
        x = idx & mask
        with np.errstate(over="ignore"):
            for i in range(6):
                k = cls.mix(key ^ U(0x9E3779B9 + i))
                c = ((x ^ k) * U(0xE170893D)) & mask
                c = c ^ (c >> s1)
                c = (c * U(0x929E3149)) & mask
                c = (c ^ (c >> s2)) & mask
                x = np.where(x >= U(n), c, x)
        return x % U(n)

    @classmethod
    def sample_1d(cls, seed, pix, smp_, mode, n_set, dim):
        d = U(dim & M32)
        if mode == smp.MODE_HALTON and dim < len(cls.PRIMES):
            u = (cls.radical_inverse(smp_, cls.PRIMES[dim])
                 + cls.unit(cls.hash(pix, d, seed)))
            u = u - np.floor(u)
        elif mode in (smp.MODE_STRATIFIED, smp.MODE_LHS) and n_set > 1:
            key = cls.hash(pix, d, seed, smp_ // U(n_set))
            stratum = cls.permute(smp_ % U(n_set), n_set, key)
            jit = cls.unit(cls.hash(pix, smp_, d, seed))
            u = (stratum.astype(F) + jit) / F(n_set)
        elif mode == smp.MODE_VDC:
            v = cls.radical_inverse(smp_ ^ cls.hash(pix, d, seed), 2)
            u = v + cls.unit(cls.hash(pix, U((dim + 97) & M32), seed))
            u = u - np.floor(u)
        else:
            u = cls.unit(cls.hash(pix, smp_, d, seed))
        return np.minimum(u, F(1.0 - 1e-7))

    @classmethod
    def sample_2d(cls, seed, pix, smp_, mode, n_set, dim):
        if mode == smp.MODE_STRATIFIED and n_set > 1:
            n2 = math.isqrt(n_set - 1) + 1
            key = cls.hash(pix, U(dim & M32), seed, smp_ // U(n_set))
            stratum = cls.permute(smp_ % U(n_set), n2 * n2, key)
            jx = cls.unit(cls.hash(pix, smp_, U(dim & M32), seed))
            jy = cls.unit(cls.hash(pix, smp_, U((dim + 1) & M32), seed))
            return np.stack([((stratum % U(n2)).astype(F) + jx) / F(n2),
                             ((stratum // U(n2)).astype(F) + jy) / F(n2)],
                            axis=-1)
        return np.stack([cls.sample_1d(seed, pix, smp_, mode, n_set, dim),
                         cls.sample_1d(seed, pix, smp_, mode, n_set,
                                       dim + 1)], axis=-1)


def _lanes():
    """(pixel, sample) int64 [64]: the edges, then random values."""
    rng = np.random.default_rng(20)
    pixel = np.concatenate([[0, 1, 2**22 - 1, 2**22, 2**22, 0, 7, 2**21],
                            rng.integers(0, 2**22 + 1, 56)])
    sample = np.concatenate([[0, 2**31 - 1, 2**32 - 1, 2**32 + 5, 1, 2**31,
                              3, 2**32 + 2**31 - 1],
                             rng.integers(0, 2**20, 28),
                             rng.integers(0, 2**33, 28)])
    return pixel.astype(np.int64), sample.astype(np.int64)


def _seeds(n):
    """(name, the port's seed, the model's) for each shape a seed takes:
    Python ints and 0-d tensors at both edges, and a seed a lane."""
    per_lane = np.resize(np.array([0, 2**32 - 1, 12345, 2**31], np.int64), n)
    out = []
    for s in SEEDS:
        out.append((f"int {s}", s, U(s)))
        out.append((f"0-d {s}", torch.tensor(s, dtype=torch.int64), U(s)))
    out.append(("lanes", torch.from_numpy(per_lane), per_lane.astype(U)))
    return out


def _bits(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _ctx(seed, pixel, sample, mode, n_set):
    return smp.SampleCtx(seed=seed, pixel=torch.from_numpy(pixel),
                         sample=torch.from_numpy(sample), mode=mode,
                         n_set=n_set)


def test_digit_loop_covers_every_digit():
    """The model's prime table is the plain version's, and the plain
    version's ceil(32 / log2(base)) digits cover every u32 index, so a
    digit loop that stops at index 0 adds the same terms."""
    assert tuple(_Model.PRIMES) == smp._PRIMES
    for base in smp._PRIMES[1:]:
        n = int(math.ceil(32.0 / math.log2(base)))
        assert base**n >= 2**32 > base**(n - 1)


def test_plain_hash_matches_the_u32_model():
    pixel, sample = _lanes()
    p_t, s_t = torch.from_numpy(pixel), torch.from_numpy(sample)
    pm, sm = pixel.astype(U), sample.astype(U)
    for seed in SEEDS:
        for tseed in (seed, torch.tensor(seed, dtype=torch.int64)):
            got = smp.hash_u32_plain(p_t, s_t, 3, tseed)
            want = _Model.hash(pm, sm, 3, seed)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
            got = smp.hash01_plain(tseed, 255, s_t)
            want = _Model.unit(_Model.hash(seed, 255, sm))
            np.testing.assert_array_equal(_bits(got), want.view(U))
    # Negative int32 and int64 parts wrap mod 2^32; ten parts.
    neg = -np.arange(1, 65, dtype=np.int32)
    parts = [torch.from_numpy(neg), p_t, -5, 2**40 + 3, s_t, 1, 2, 3, 4, 5]
    want = _Model.hash(neg.astype(U), pm, -5, 2**40 + 3, sm, 1, 2, 3, 4, 5)
    np.testing.assert_array_equal(smp.hash_u32_plain(*parts).numpy(),
                                  want.astype(np.int64))
    # All Python ints: a Python int.
    assert smp.hash_u32_plain(1, 2, 3) == int(_Model.hash(1, 2, 3))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_the_u32_model(mode):
    pixel, sample = _lanes()
    pm, sm = pixel.astype(U), sample.astype(U)
    for n_set in N_SETS:
        for name, seed, mseed in _seeds(pixel.shape[0]):
            ctx = _ctx(seed, pixel, sample, mode, n_set)
            for dim in DIMS:
                what = f"mode {mode} n_set {n_set} seed {name} dim {dim}"
                want = _Model.sample_1d(mseed, pm, sm, mode, n_set, dim)
                np.testing.assert_array_equal(
                    _bits(smp.sample_1d_plain(ctx, dim)), want.view(U),
                    err_msg=f"sample_1d {what}")
                want = _Model.sample_2d(mseed, pm, sm, mode, n_set, dim)
                np.testing.assert_array_equal(
                    _bits(smp.sample_2d_plain(ctx, dim)), want.view(U),
                    err_msg=f"sample_2d {what}")


def _host_array(part, n):
    """The u32 values a part gives `n` lanes."""
    if part.kind == smp._CONST:
        return np.full(n, part.value, U)
    count = n if part.stride == 1 else 1
    assert part.kind == smp._INT64 and part.stride in (0, 1) and part.ptr
    vals = np.ctypeslib.as_array(
        (ctypes.c_int64 * count).from_address(part.ptr))
    return np.broadcast_to(vals.astype(np.int64).astype(U), (n,))


def _host_out(ptr, n, dtype):
    ctype = {np.float32: ctypes.c_float, np.int64: ctypes.c_int64}[dtype]
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


class _EmulatedLib:
    """csrc/sampler.cu's C entry points over host memory, by the model:
    the routes and the argument checks as the kernel takes them."""

    def __init__(self):
        self.calls = []

    def rgk_sampler_hash(self, parts, n_parts, n, out, stream):
        assert 1 <= n_parts <= 8 and stream is None
        parts = (smp._Part * n_parts).from_address(parts)
        self.calls.append(("hash", n_parts, n))
        h = np.full(n, 0x9E3779B9, U)
        with np.errstate(over="ignore"):
            for p in parts:
                h = _Model.mix(h ^ (_host_array(p, n) * U(0x85EBCA6B)))
        _host_out(out, n, np.int64)[:] = h
        return 0

    def rgk_sampler_sample(self, spec, n, out, stream):
        s = smp._SampleSpec.from_address(spec)
        self.calls.append(("sample", s.comps, n))
        seed, pix, sm = (_host_array(p, n) for p in (s.seed, s.pixel,
                                                      s.sample))
        got = _host_out(out, n * s.comps, np.float32).reshape(n, s.comps)
        if s.route[0] == smp._STRAT2D:
            assert s.comps == 2 and s.n2 == math.isqrt(s.n_set - 1) + 1
            got[:] = _Model.sample_2d(seed, pix, sm, smp.MODE_STRATIFIED,
                                      s.n_set, s.dim[0])
            return 0
        modes = {smp._INDEPENDENT: smp.MODE_INDEPENDENT,
                 smp._HALTON: smp.MODE_HALTON, smp._STRAT1D: smp.MODE_LHS,
                 smp._VDC: smp.MODE_VDC}
        for c in range(s.comps):
            route, dim = s.route[c], s.dim[c]
            if route == smp._HALTON:
                base = _Model.PRIMES[dim]
                assert s.base[c] == base
                assert s.inv_base[c] == F(1.0 / base)
            got[:, c] = _Model.sample_1d(seed, pix, sm, modes[route],
                                         s.n_set, dim)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """The wrapper's launches on CPU tensors, into `_EmulatedLib`; the
    launch counters zeroed."""
    lib = _EmulatedLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(smp, "_on_card",
                        lambda dev, entry, *args: entry(*args, None))
    monkeypatch.setattr(smp, "launches", dict.fromkeys(smp.launches, 0))
    return lib


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_arguments_reproduce_the_plain_version(emulated, mode):
    pixel, sample = _lanes()
    cpu = torch.device("cpu")
    calls = 0
    for n_set in N_SETS:
        for name, seed, _ in _seeds(pixel.shape[0]):
            ctx = _ctx(seed, pixel, sample, mode, n_set)
            for dim in DIMS:
                what = f"mode {mode} n_set {n_set} seed {name} dim {dim}"
                for entry, plain in (("sample_1d", smp.sample_1d_plain),
                                     ("sample_2d", smp.sample_2d_plain)):
                    got = smp._launch_sample(ctx, dim, cpu, entry)
                    want = plain(ctx, dim)
                    assert got.shape == want.shape, what
                    np.testing.assert_array_equal(
                        _bits(got), _bits(want), err_msg=f"{entry} {what}")
                    calls += 1
    assert sum(smp.launches.values()) == len(emulated.calls) == calls
    assert smp.launches["sample_1d"] == smp.launches["sample_2d"]


def test_kernel_arguments_of_hashes(emulated):
    pixel, sample = _lanes()
    p_t, s_t = torch.from_numpy(pixel), torch.from_numpy(sample)
    cpu = torch.device("cpu")
    neg = torch.from_numpy(-np.arange(1, 65, dtype=np.int32))
    cases = [
        (p_t, s_t, 7, torch.tensor(2**32 - 1)),
        (torch.tensor(5), 1, s_t + 1),       # the per-bounce seed's shape
        (neg, p_t[::1], 2**40 + 3, -1),
        (p_t[::2], s_t[::2]),                # strided views: copied
        (p_t[:32].reshape(8, 4), s_t[:32].reshape(4, 8).t()),
        (p_t.reshape(8, 8), s_t[:8]),        # broadcast: copied
        (p_t > 2**21, s_t.to(torch.int16)),  # cast to int64
        tuple([s_t] + list(range(7))),       # the most parts, 8
        (torch.tensor(3), 4),                # 0-d
    ]
    for parts in cases:
        got = smp._launch_hash(parts, cpu)
        want = smp.hash_u32_plain(*parts)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert smp.launches["hash_u32"] == len(emulated.calls) == len(cases)
    with pytest.raises(ValueError, match="at most 8 parts"):
        smp._launch_hash(tuple([s_t] + list(range(8))), cpu)
    # No lane: no launch.
    before = len(emulated.calls)
    empty = torch.zeros(0, dtype=torch.int64)
    assert smp._launch_hash((empty, 1), cpu).shape == (0,)
    ctx = smp.SampleCtx(seed=1, pixel=empty, sample=empty)
    assert smp._launch_sample(ctx, 0, cpu, "sample_2d").shape == (0, 2)
    assert len(emulated.calls) == before


def test_lane_parts():
    """Strides, kinds and constants as the kernel reads them."""
    lanes = torch.arange(6, dtype=torch.int64)
    narrow = lanes.to(torch.int32)
    shape, (a, b, c, d, e), keep = smp._lane_parts(
        (lanes, torch.tensor(9), -3, 2**32 + 7, narrow),
        torch.device("cpu"))
    assert shape == (6,)
    assert (a.stride, a.kind, a.ptr) == (1, smp._INT64, lanes.data_ptr())
    assert (b.stride, b.kind) == (0, smp._INT64)
    assert (c.kind, c.value) == (smp._CONST, 2**32 - 3)
    assert (d.kind, d.value) == (smp._CONST, 7)
    # An int32 part is cast to int64.
    assert (e.stride, e.kind) == (1, smp._INT64)
    assert e.ptr == keep[2].data_ptr() != narrow.data_ptr()
    assert keep[2].dtype == torch.int64
    assert len(keep) == 3
    # A strided view is copied; so is a part that broadcasts.
    _, (v, w), keep = smp._lane_parts((lanes[::2], lanes[:1]),
                                      torch.device("cpu"))
    assert v.ptr == keep[0].data_ptr() != lanes.data_ptr() and v.stride == 1
    assert w.stride == 0


def test_lane_parts_import_no_sympy():
    """The wrapper's shape logic leaves sympy unloaded:
    torch.broadcast_shapes imports it, seconds of a runner's warm-up in a
    fresh process."""
    code = ("import sys, torch\n"
            "from rgk_tpu_torch.ops import sampler as smp\n"
            "smp._lane_parts((torch.tensor(1), torch.arange(4), 3),\n"
            "                torch.device('cpu'))\n"
            "print('sympy' in sys.modules)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, check=True)
    assert got.stdout.strip() == "False"


def test_argument_structs_match_the_kernel():
    """`_Part` and `_SampleSpec` lay out as csrc/sampler.cu's RgkPart
    and RgkSampleSpec (x86-64 and aarch64 alike)."""
    assert ctypes.sizeof(smp._Part) == 24
    assert [getattr(smp._Part, f).offset
            for f in ("ptr", "stride", "value", "kind")] == [0, 8, 16, 20]
    offsets = [getattr(smp._SampleSpec, f).offset for f in (
        "seed", "pixel", "sample", "comps", "route", "dim", "base",
        "inv_base", "n_set", "n2")]
    assert offsets == [0, 24, 48, 72, 76, 84, 92, 100, 108, 112]
    assert ctypes.sizeof(smp._SampleSpec) == 120


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(smp, "launches", dict.fromkeys(smp.launches, 0))
    pixel, sample = _lanes()
    ctx = _ctx(torch.tensor(17), pixel, sample, smp.MODE_HALTON, 4)
    assert torch.equal(smp.sample_1d(ctx, 3), smp.sample_1d_plain(ctx, 3))
    assert torch.equal(smp.sample_2d(ctx, 0), smp.sample_2d_plain(ctx, 0))
    h = smp.hash_u32(ctx.seed, 1, ctx.sample)
    assert torch.equal(h, smp.hash_u32_plain(ctx.seed, 1, ctx.sample))
    assert torch.equal(smp.hash01(ctx.pixel, 2), smp.hash01_plain(ctx.pixel,
                                                                  2))
    assert smp.hash_u32(1, 2) == smp.hash_u32_plain(1, 2)
    assert sum(smp.launches.values()) == 0
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="no sampler kernel"):
        smp.hash_u32(meta, 1)


@pytest.mark.timeout(300)
def test_cpu_render_launches_no_sampler(tmp_path):
    arrays, meta, c = scenes.port_build(scenes.write_config(
        tmp_path, scenes.box_config(res=8, ms=2), "box.json"))
    before = graph.read_stats()["sampler_launches"]
    pix = torch.arange(64)
    runner = graph.QueuedGraph(arrays, meta, c.settings, c.get_camera(), 64,
                               2)
    radiance, rays = runner.trace((pix % 8).to(torch.int32),
                                  (pix // 8).to(torch.int32), 0, 42,
                                  c.get_camera())
    st = graph.read_stats()
    assert int(rays) > 0 and st["iterations"] > 0
    assert st["sampler_launches"] == before
    assert st["sampler_launches"] == sum(
        st[f"sampler_{k}"] for k in smp.launches)
