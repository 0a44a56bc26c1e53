"""The BxDF layer's plain version and the kernel's wrapper, on the CPU.

`eval_bxdf_plain` / `sample_bxdf_plain` are the port's BxDF as it was
before the kernel (`csrc/bxdf.cu`): they are pinned here on fixed lanes
(`torch_port_scenes.bxdf_lanes`: every type, the mix and a mix over a
mix, TIR, grazing and below-horizon directions, the mirror and
refraction tolerances' edges) by the per-type sums of their outputs,
taken from that version.  The kernel runs only on a card
(tests/test_torch_cuda.py holds it to the plain version there, bit for
bit).  Here the wrapper's launches go to `_EmulatedLib`, the kernel's C
entry points computed by the plain version over host memory, so the CPU
checks what the wrapper hands the kernel: the argument struct's fields,
strides, slots and flags, and which gradients its backward asks for.
CPU tensors take the plain version and count no launch, a CPU render
included; a CUDA call without the library raises.

Tolerance: the pinned sums within rtol 1e-6 (float64 sums of float32
values); the emulated kernel's forward equals the plain version bit for
bit, its gradients within rtol 1e-6 and 1e-6 x the largest (the pack's
rows sum the slots' gradients in another order on a mix scene, and an
LTC row's roughness gradients cancel).
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu_torch import kernels
from rgk_tpu_torch.integrator import graph
from rgk_tpu_torch.ops import bxdf as bx
from rgk_tpu_torch.ops import ltc as ltc_ops
from rgk_tpu_torch.ops import warps
from rgk_tpu_torch.scene.arrays import BSDF_MIX

FLAGS = [(False, False), (False, True), (True, False), (True, True)]

# Per type (scene/arrays.py BSDF_*): the float64 sums of eval's f,
# sample's direction and throughput, the leaking lanes and the lanes, on
# `bxdf_lanes(4096, 17)`, from the plain version before the kernel.
PINNED = {
    'mix=0 ltc=0': (
        (34.81417960883118, 415.22892724582925, 238.15710537694395, 0, 507),
        (137.20005424320698, 19.425031327472425, 597.2655219137669, 0, 485),
        (57.0, 31.844144234553674, 1557.0, 519, 519),
        (126.34855250176088, -166.68428758173127, 780.8943623006344, 275, 513),
        (0.0, 354.2047075590817, 550.4752211384475, 0, 508),
        (0.0, 404.7223700749455, 821.432704212144, 0, 514),
        (49.69414842128754, 343.0065201986581, 458.52956805191934, 0, 526),
        (50.12107473611832, 374.6569538304466, 586.7823571003973, 0, 524),
    ),
    'mix=0 ltc=1': (
        (34.81417960883118, 415.22892724582925, 238.15710537694395, 0, 507),
        (137.20005424320698, 19.425031327472425, 597.2655219137669, 0, 485),
        (57.0, 31.844144234553674, 1557.0, 519, 519),
        (126.34855250176088, -166.68428758173127, 780.8943623006344, 275, 513),
        (3132917.161640306, 237.3579703893481, 550.4752211384475, 0, 508),
        (176037.89381832047, 237.5187573370249, 821.432704212144, 0, 514),
        (961.4462070399895, 357.181734418029, 458.52956805191934, 0, 526),
        (95460.7678578049, 360.833892541199, 586.7823571003973, 0, 524),
    ),
    'mix=1 ltc=0': (
        (26.16351239825599, 333.79731091554277, 167.88178329123184, 0, 408),
        (102.48843924701214, 22.83065003922895, 505.93495586514473, 0, 407),
        (54.0, 13.03917175743544, 1224.0, 408, 408),
        (96.01675770245583, -96.73581714564509, 660.1801625341177, 215, 433),
        (0.0, 306.89033812400885, 450.73522379249334, 0, 433),
        (0.0, 291.07228801737074, 665.1383444275707, 0, 412),
        (41.17979895323515, 316.2914632287575, 340.1594994403422, 0, 419),
        (44.56269258260727, 282.9946770821698, 470.02239679545164, 0, 418),
        (59.594904558733106, 348.66157546290617, 870.4915666137822, 23, 758),
    ),
    'mix=1 ltc=1': (
        (26.16351239825599, 333.79731091554277, 167.88178329123184, 0, 408),
        (102.48843924701214, 22.83065003922895, 505.93495586514473, 0, 407),
        (54.0, 13.03917175743544, 1224.0, 408, 408),
        (96.01675770245583, -96.73581714564509, 660.1801625341177, 215, 433),
        (108847.9472733727, 193.14983501013586, 450.73522379249334, 0, 433),
        (6099314.423601166, 196.35231458373983, 665.1383444275707, 0, 412),
        (66914.77615382429, 309.43322434071706, 340.1594994403422, 0, 419),
        (585.0453888624907, 275.9065549756824, 470.02239679545164, 0, 418),
        (1785.7275726459925, 287.9496855411322, 870.4915666137822, 23, 758),
    ),
}


def _tables():
    return ltc_ops.LTCTables(
        rows=torch.from_numpy(np.array(ltc_ops.load_tables_np())))


def _lanes(n, seed, mix):
    return scenes.bxdf_lanes(n, seed, types=scenes.BXDF_TYPES if mix
                             else scenes.BXDF_TYPES[:-1])


@pytest.mark.parametrize("mix,ltc", FLAGS)
def test_plain_version_is_pinned(mix, ltc):
    pack, mid, vi, vr, u2 = _lanes(4096, 17, mix)
    tb = _tables()
    f = bx.eval_bxdf_plain(None, pack, mid, vi, vr, None, tb, mix, ltc,
                           False)
    d, t, leak = bx.sample_bxdf_plain(None, pack, mid, vi, None, u2, tb,
                                      mix, ltc, False)
    typ = pack[mid.long(), 12].long()
    want = PINNED[f"mix={int(mix)} ltc={int(ltc)}"]
    assert len(want) == (9 if mix else 8)
    for k, (sf, sd, st, n_leak, n) in enumerate(want):
        sel = typ == k
        assert int(sel.sum()) == n and int(leak[sel].sum()) == n_leak, k
        for got, s in ((f, sf), (d, sd), (t, st)):
            assert float(got[sel].double().sum()) == pytest.approx(
                s, rel=1e-6, abs=1e-9), k
    # The public functions take the plain version on the CPU.
    assert torch.equal(bx.eval_bxdf(None, pack, mid, vi, vr, None, tb, mix,
                                    ltc, False), f)


def _host(field, n, comps):
    """The values a struct field points at: [n, comps] (or [n]) floats,
    lanes `stride` apart, a lane's components adjacent."""
    assert field.ptr and field.stride >= (comps if n > 1 else 0)
    count = (n - 1) * field.stride + max(comps, 1)
    buf = np.ctypeslib.as_array((ctypes.c_float * count).from_address(
        field.ptr))
    shape = (n, comps) if comps else (n,)
    strides = (field.stride * 4, 4) if comps else (field.stride * 4,)
    return torch.from_numpy(np.lib.stride_tricks.as_strided(
        buf, shape, strides).copy())


def _host_out(ptr, n, comps, dtype=ctypes.c_float):
    return torch.from_numpy(np.ctypeslib.as_array(
        (dtype * (n * max(comps, 1))).from_address(ptr)))


class _EmulatedLib:
    """csrc/bxdf.cu's C entry points over host memory, by the plain
    version: the slots, flags and gradient outputs as the kernel takes
    them."""

    def __init__(self):
        self.calls = []

    def _inputs(self, a, grad=False):
        n, slots = a.n, 3 if a.has_mix else 1
        for k in range(slots, 3):
            m = a.mat[k]
            assert not any(getattr(m, f).ptr for f in (
                "diffuse", "specular", "rough", "ior", "mix", "type"))
        assert bool(a.ltc_rows) == bool(a.has_ltc)
        tb = None
        if a.has_ltc:
            tb = ltc_ops.LTCTables(rows=_host_out(a.ltc_rows, 8192, 10)
                                   .reshape(8192, 10).clone())
        mats = []
        for k in range(slots):
            m = a.mat[k]
            assert bool(m.mix.ptr) == (k == 0)
            p = SimpleNamespace(
                diffuse=_host(m.diffuse, n, 3),
                specular=_host(m.specular, n, 3),
                roughness=_host(m.rough, n, 0), ior=_host(m.ior, n, 0),
                mix_amt=_host(m.mix, n, 0) if k == 0 else None,
                bxdf_type=_host(m.type, n, 0).to(torch.int32))
            if grad:
                for f in ("diffuse", "specular", "roughness"):
                    setattr(p, f, getattr(p, f).requires_grad_(True))
            p.ltc_kind = torch.where(
                (p.bxdf_type == 5) | (p.bxdf_type == 7), 1, 0)
            mats.append(p)
        return mats, tb

    def _eval(self, a, mats, tb, vi, vr):
        base = bx._eval_base(tb, mats[0], vi, vr, bool(a.has_ltc))
        if not a.has_mix:
            return base
        f1 = bx._eval_base(tb, mats[1], vi, vr, bool(a.has_ltc))
        f2 = bx._eval_base(tb, mats[2], vi, vr, bool(a.has_ltc))
        amt = mats[0].mix_amt[:, None]
        return torch.where((mats[0].bxdf_type == BSDF_MIX)[:, None],
                           f1 * amt + f2 * (1.0 - amt), base)

    def _sample(self, a, mats, tb, vi, u2):
        p0 = mats[0]
        if not a.has_mix:
            return bx._sample_base(tb, p0, vi, u2, bool(a.has_ltc))
        is_mix = p0.bxdf_type == BSDF_MIX
        take_m1, sx = warps.decide_and_rescale(u2[:, 0], p0.mix_amt)
        u2 = torch.where(is_mix[:, None], torch.stack([sx, u2[:, 1]], -1),
                         u2)
        pick = {}
        for f in ("diffuse", "specular", "roughness", "ior", "bxdf_type",
                  "ltc_kind"):
            sub = torch.where(
                (take_m1[:, None] if f in ("diffuse", "specular")
                 else take_m1), getattr(mats[1], f), getattr(mats[2], f))
            pick[f] = torch.where(
                is_mix[:, None] if f in ("diffuse", "specular") else is_mix,
                sub, getattr(p0, f))
        return bx._sample_base(tb, SimpleNamespace(**pick), vi, u2,
                               bool(a.has_ltc))

    def rgk_bxdf_eval(self, args, stream):
        assert stream is None
        a = bx._Args.from_address(args)
        self.calls.append(("eval", a.n, a.has_mix, a.has_ltc))
        mats, tb = self._inputs(a)
        f = self._eval(a, mats, tb, _host(a.vi, a.n, 3), _host(a.vr, a.n, 3))
        _host_out(a.f, a.n, 3)[:] = f.reshape(-1)
        return 0

    def rgk_bxdf_sample(self, args, stream):
        assert stream is None
        a = bx._Args.from_address(args)
        self.calls.append(("sample", a.n, a.has_mix, a.has_ltc))
        mats, tb = self._inputs(a)
        d, thr, leak = self._sample(a, mats, tb, _host(a.vi, a.n, 3),
                                    _host(a.u2, a.n, 2))
        _host_out(a.dir, a.n, 3)[:] = d.reshape(-1)
        _host_out(a.thr, a.n, 3)[:] = thr.reshape(-1)
        _host_out(a.leak, a.n, 0, ctypes.c_uint8)[:] = leak.to(torch.uint8)
        return 0

    def _backward(self, a, entry):
        with torch.enable_grad():  # a Function's backward runs without
            return self._backward_on(a, entry)

    def _backward_on(self, a, entry):
        mats, tb = self._inputs(a, grad=True)
        vi = _host(a.vi, a.n, 3).requires_grad_(True)
        leaves = [vi]
        if entry == "eval":
            vr = _host(a.vr, a.n, 3).requires_grad_(True)
            leaves.append(vr)
            loss = (self._eval(a, mats, tb, vi, vr)
                    * _host_out(a.g_f, a.n, 3).reshape(-1, 3)).sum()
        else:
            d, thr, _ = self._sample(a, mats, tb, vi, _host(a.u2, a.n, 2))
            loss = 0.0
            for ptr, out in ((a.g_dir, d), (a.g_thr, thr)):
                if ptr:
                    loss = loss + (out * _host_out(ptr, a.n, 3)
                                   .reshape(-1, 3)).sum()
        for p in mats:
            leaves += [p.diffuse, p.specular, p.roughness]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        outs = [a.g_vi] + ([a.g_vr] if entry == "eval" else [])
        for k in range(len(mats)):
            outs += [a.g_diffuse[k], a.g_specular[k], a.g_rough[k]]
        for ptr, x, g in zip(outs, leaves, grads):
            if ptr:
                g = torch.zeros_like(x) if g is None else g
                _host_out(ptr, a.n, 1 if g.dim() == 1 else 3)[:] = \
                    g.reshape(-1)
        self.calls.append((f"{entry}_bwd", a.n, tuple(bool(p) for p in outs)))
        return 0

    def rgk_bxdf_eval_bwd(self, args, stream):
        return self._backward(bx._Args.from_address(args), "eval")

    def rgk_bxdf_sample_bwd(self, args, stream):
        return self._backward(bx._Args.from_address(args), "sample")


@pytest.fixture
def emulated(monkeypatch):
    """The wrapper's launches on CPU tensors, into `_EmulatedLib`; the
    launch counters zeroed."""
    lib = _EmulatedLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(bx, "_on_card",
                        lambda dev, entry, *args: entry(*args, None))
    monkeypatch.setattr(bx, "launches", dict.fromkeys(bx.launches, 0))
    return lib


def _kernel(entry, pack, mid, vi, second, tb, mix, ltc, p0=None):
    """`entry` ("eval" or "sample") through the kernel's wrapper on CPU
    tensors."""
    p = p0 or bx.MatParams(None, pack, mid, None, has_textures=False)
    mats = bx._slots(None, pack, p, None, mix, False)
    fn = bx._EvalFn if entry == "eval" else bx._SampleFn
    return bx._call(fn, bx._Static(mats, tb, mix, ltc), vi, second)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("mix,ltc", FLAGS)
def test_kernel_arguments_reproduce_the_plain_version(emulated, mix, ltc):
    pack, mid, vi, vr, u2 = _lanes(3001, 4, mix)
    tb = _tables()
    got = _kernel("eval", pack, mid, vi, vr, tb, mix, ltc)
    want = bx.eval_bxdf_plain(None, pack, mid, vi, vr, None, tb, mix, ltc,
                              False)
    assert torch.equal(_bits(got), _bits(want))
    got = _kernel("sample", pack, mid, vi, u2, tb, mix, ltc)
    want = bx.sample_bxdf_plain(None, pack, mid, vi, None, u2, tb, mix, ltc,
                                False)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert torch.equal(got[2], want[2]) and got[2].dtype == torch.bool
    assert emulated.calls == [("eval", 3001, mix, ltc),
                              ("sample", 3001, mix, ltc)]
    assert bx.launches == {"eval": 1, "sample": 1, "eval_bwd": 0,
                           "sample_bwd": 0}


def test_kernel_arguments_of_views_and_shapes(emulated):
    """Strided pack columns are read in place (the lane stride is the
    row's); a textured diffuse, a lead of two dimensions, a field that
    broadcasts and a view whose components are not adjacent are handed
    over as the kernel reads them; no lane, no launch."""
    pack, mid, vi, vr, u2 = _lanes(64, 9, True)
    tb = _tables()
    p = bx.MatParams(None, pack, mid, None, has_textures=False)
    mats = bx._slots(None, pack, p, None, True, False)
    st = bx._Static(mats, tb, True, True)
    a, keep = bx._args(st, vi.shape[:-1], 64, st.diff, vi=vi, vr=vr)
    assert a.mat[0].diffuse.ptr == p.row[:, 3:6].data_ptr()
    assert a.mat[0].diffuse.stride == 20 == a.mat[0].type.stride
    assert a.mat[0].type.ptr == p.row[:, 12].data_ptr()
    assert (a.vi.ptr, a.vi.stride) == (vi.data_ptr(), 3)
    assert a.n == 64 and a.has_mix == 1 and a.has_ltc == 1
    assert a.ltc_rows == tb.rows.data_ptr() and not a.mat[1].mix.ptr
    want = bx.eval_bxdf_plain(None, pack, mid, vi, vr, None, tb, True, True,
                              False)
    # A textured diffuse: its own contiguous tensor.
    p.diffuse = p.diffuse.clone()
    got = _kernel("eval", pack, mid, vi, vr, tb, True, True, p0=p)
    assert torch.equal(_bits(got), _bits(want))
    # Lanes of two dimensions; components not adjacent (copied).
    buf = torch.zeros(64, 6)
    buf[:, ::2] = vi
    wide = buf[:, ::2].reshape(8, 8, 3)
    assert wide.stride(-1) == 2
    p2 = bx.MatParams(None, pack, mid.reshape(8, 8), None,
                      has_textures=False)
    got = _kernel("eval", pack, mid.reshape(8, 8), wide, vr.reshape(8, 8, 3),
                  tb, True, True, p0=p2)
    assert got.shape == (8, 8, 3)
    assert torch.equal(_bits(got.reshape(64, 3)), _bits(want))
    # A roughness that broadcasts across lanes (one value).
    p.roughness = p.roughness[:1].expand(64)
    ref = bx.eval_bxdf_plain(None, pack, mid, vi, vr, None, tb, True, True,
                             False, p0=p)
    assert torch.equal(_bits(_kernel("eval", pack, mid, vi, vr, tb, True,
                                     True, p0=p)), _bits(ref))
    n_calls = len(emulated.calls)
    e = torch.zeros(0, 3)
    assert _kernel("eval", pack, mid[:0], e, e, tb, True, True).shape == (
        0, 3)
    assert len(emulated.calls) == n_calls
    with pytest.raises(TypeError, match="float32"):
        _kernel("eval", pack, mid, vi.double(), vr, tb, True, True)


@pytest.mark.parametrize("mix,ltc", FLAGS)
def test_kernel_backward_arguments(emulated, mix, ltc):
    """Under autograd each call is one backward launch more, asking for
    the gradients that need one: the directions, then diffuse, specular
    and roughness a slot; its gradients are the plain version's."""
    pack0, mid, vi0, vr0, u2 = _lanes(2001, 6, mix)
    tb = _tables()
    g = torch.randn(2001, 3, generator=torch.Generator().manual_seed(1))
    for entry in ("eval", "sample"):
        res = []
        for route in ("kernel", "plain"):
            d = pack0[:, 3:6].clone().requires_grad_(True)
            r = pack0[:, 9].clone().requires_grad_(True)
            vi = vi0.clone().requires_grad_(True)
            pack = torch.cat([pack0[:, :3], d, pack0[:, 6:9], r[:, None],
                              pack0[:, 10:]], 1)
            if route == "kernel":
                out = _kernel(entry, pack, mid, vi,
                              vr0 if entry == "eval" else u2, tb, mix, ltc)
            elif entry == "eval":
                out = bx.eval_bxdf_plain(None, pack, mid, vi, vr0, None, tb,
                                         mix, ltc, False)
            else:
                out = bx.sample_bxdf_plain(None, pack, mid, vi, None, u2, tb,
                                           mix, ltc, False)
            if entry == "sample":
                out = out[0] + out[1]
            res.append(torch.autograd.grad((out * g).sum(), [d, r, vi],
                                           allow_unused=True))
        for a, b in zip(*res):
            b = torch.zeros_like(a) if b is None else b
            scale = float(b[torch.isfinite(b)].abs().max())
            torch.testing.assert_close(a, b, rtol=1e-6,
                                       atol=1e-6 * scale + 1e-9,
                                       equal_nan=True)
        call = emulated.calls[-1]
        slots = 3 if mix else 1
        # vi (and vr, which needs none), then diffuse, specular and
        # roughness of every slot (columns of a pack under autograd).
        want = (True,) + ((False,) if entry == "eval" else ()) + (
            True, True, True) * slots
        assert call == (f"{entry}_bwd", 2001, want), call
    assert bx.launches == {"eval": 1, "sample": 1, "eval_bwd": 1,
                           "sample_bwd": 1}


def test_argument_struct_matches_the_kernel():
    """`_Args` lays out as csrc/bxdf.cu's RgkBxdfArgs (static_assert 504
    bytes there)."""
    assert ctypes.sizeof(bx._Field) == 16
    assert ctypes.sizeof(bx._Mat) == 96
    offsets = [getattr(bx._Args, f).offset for f in (
        "mat", "vi", "vr", "u2", "ltc_rows", "n", "has_mix", "has_ltc", "f",
        "dir", "thr", "leak", "g_f", "g_dir", "g_thr", "g_diffuse",
        "g_specular", "g_rough", "g_vi", "g_vr")]
    assert offsets == [0, 288, 304, 320, 336, 344, 352, 356, 360, 368, 376,
                       384, 392, 400, 408, 416, 440, 464, 488, 496]
    assert ctypes.sizeof(bx._Args) == 504


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(bx, "launches", dict.fromkeys(bx.launches, 0))
    pack, mid, vi, vr, u2 = _lanes(500, 2, True)
    tb = _tables()
    got = bx.sample_bxdf(None, pack, mid, vi, None, u2, tb, True, True,
                         False)
    want = bx.sample_bxdf_plain(None, pack, mid, vi, None, u2, tb, True,
                                True, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(bx.launches.values()) == 0
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(RuntimeError, match="no BxDF kernel"):
        bx.eval_bxdf(None, pack, mid[:4], meta, meta, None, tb, True, True,
                     False)


def test_a_card_call_without_the_library_raises(monkeypatch):
    """A launch on a card builds the library first; where it cannot be
    built or loaded (no nvcc here), the call raises and counts nothing."""
    def no_library():
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")

    monkeypatch.setattr(kernels, "load", no_library)
    monkeypatch.setattr(bx, "launches", dict.fromkeys(bx.launches, 0))
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        bx._launch("eval", bx._Args(n=1), 1, torch.device("cuda"), [])
    assert sum(bx.launches.values()) == 0


@pytest.mark.timeout(300)
def test_cpu_render_launches_no_bxdf(tmp_path):
    arrays, meta, c = scenes.port_build(scenes.write_config(
        tmp_path, scenes.box_config(res=8, ms=2), "box.json"))
    before = graph.read_stats()["bxdf_launches"]
    pix = torch.arange(64)
    runner = graph.QueuedGraph(arrays, meta, c.settings, c.get_camera(), 64,
                               2)
    radiance, rays = runner.trace((pix % 8).to(torch.int32),
                                  (pix // 8).to(torch.int32), 0, 42,
                                  c.get_camera())
    st = graph.read_stats()
    assert int(rays) > 0 and st["iterations"] > 0
    assert st["bxdf_launches"] == before
    assert st["bxdf_launches"] == sum(st[f"bxdf_{k}"] for k in bx.launches)
