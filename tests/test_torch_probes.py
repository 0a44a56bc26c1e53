"""The probes P1 (rgk_tpu_torch/tools/prof_smem_probe.py) and P2
(rgk_tpu_torch/tools/prof_sync.py) on the CPU: their plain versions give
the reference's closed-form outputs (5.0 for the unpack, 4n - 1 for the
row copy) and each variant's carry `s` as computed here in numpy, loop
by loop; both entry points parse their arguments and refuse to measure
without a card.  The kernels are held to the plain versions on the card
by chip_smoke.py and tests/test_torch_cuda.py.

Tolerance: exact, except the sweeps' least t (rtol 1e-6: the same
float32 operations in numpy and PyTorch).
"""

import numpy as np
import pytest
import torch

from rgk_tpu_torch.tools import prof_smem_probe as p1
from rgk_tpu_torch.tools import prof_sync as p2

ITERS = 203


def test_p1_plain_outputs():
    w, x = p1.unpack_inputs("cpu")
    assert bool((p1.unpack(w, x) == 5.0).all())
    for n in p1.ROW_SIZES:
        out = p1.row_copy(p1.row_table(n, "cpu"), p1.ROW)
        assert out.shape == (1024,) and bool((out == 4 * n - 1).all())
    x = torch.linspace(-3.5, 7.25, 1024)
    np.testing.assert_array_equal(p1.smem(x, 4096).numpy(),
                                  x.numpy() + np.float32(-3.0))
    assert p1.launches == {"smem": 0, "unpack": 0, "row_copy": 0}


def _slab(v, tab, n):
    t = [(tab[n + k] - v) * v for k in range(6)]
    tn = np.maximum(np.maximum(np.minimum(t[0], t[1]),
                               np.minimum(t[2], t[3])), np.minimum(t[4], t[5]))
    tf = np.minimum(np.minimum(np.maximum(t[0], t[1]),
                               np.maximum(t[2], t[3])), np.maximum(t[4], t[5]))
    return (tf >= tn) & (tf >= 0)


def _numpy_s(variant, x, tab, iters, thr):
    """The kernel's loop, one iteration at a time, in float32 numpy."""
    thr = np.float32(thr)
    s = np.zeros(1024, np.int64)
    pending = 0
    if variant == "nested":
        ks = [k for i in range(iters // 4) for k in range(4 * i, 4 * i + 3)]
    else:
        ks = range(iters)
    for i in ks:
        if variant == "a":
            continue
        if variant in ("b", "c"):
            pred = x + np.float32(i) > thr
        elif variant == "d":
            pred = x + tab[i % 64] > thr
        elif variant == "e":
            w = x.copy()
            for k in range(8):
                w = w + tab[(i + k) % 64]
            pred = w > thr
        else:
            pred = _slab(x, tab, i % 64)
        if variant == "c":
            s += pending
            pending = int(pred.any())
        elif variant == "f_warp":
            s += np.repeat(pred.reshape(32, 32).any(axis=1), 32)
        elif variant == "g":
            rows = pred.reshape(8, 128).any(axis=1)
            s += int(sum(int(r) << k for k, r in enumerate(rows)))
        else:
            s += int(pred.any())
    return s


@pytest.mark.parametrize("variant", [v for v in p2.VARIANTS
                                     if not v.startswith("sweep")])
def test_p2_plain_carry(variant):
    x, tab, _, _ = p2.inputs("cpu")
    thr = p2.thresh(variant, ITERS)
    s, st = p2.sync(variant, x, tab, ITERS, thr)  # CPU: the plain version
    want = _numpy_s(variant, x.numpy(), tab.numpy(), ITERS, thr)
    np.testing.assert_array_equal(s.numpy(), want)
    assert bool((st == p2.SWEEP_T_MAX).all())
    if variant != "a":
        assert want.max() > 0


def test_p2_plain_sweeps():
    """Lane l's ray (column l of rows 0-5) against the tile's 128
    triangles, in numpy: the least t in (0, 1e30) of a hit whose
    barycentrics are inside; rows of threads that sweep get it."""
    _, _, tile, _ = p2.inputs("cpu")
    m = tile.numpy().reshape(16, 128)
    o, d = m[0:3].T[:, None, :], m[3:6].T[:, None, :]         # [lane, 1, 3]
    n, c = m[0:3].T[None], m[3][None]                          # [1, tri, 3]
    rddn = d[..., 0] * n[..., 0] + d[..., 1] * n[..., 1] + d[..., 2] * n[..., 2]
    rodn = (o[..., 0] * n[..., 0] + o[..., 1] * n[..., 1]
            + o[..., 2] * n[..., 2] + c)
    t = -rodn / rddn
    p = o + t[..., None] * d
    beta = m[4][None] + p[..., 0] * m[5] + p[..., 1] * m[6] + p[..., 2] * m[7]
    gamma = m[8][None] + p[..., 0] * m[9] + p[..., 1] * m[10] + p[..., 2] * m[11]
    ok = (t > 0) & (t < 1e30) & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1)
    best = np.where(ok, t, np.float32(1e30)).min(axis=1).astype(np.float32)
    assert 0.05 < ok.any(axis=1).mean() < 1.0

    for variant, rows in (("sweep", [0]), ("sweep8", range(8))):
        s, st = p2.sync(variant, tile, torch.zeros(128), 100, 0.0)
        assert bool((s == 0).all())
        st = st.numpy().reshape(8, 128)
        for r in range(8):
            if r in rows:
                np.testing.assert_allclose(st[r], best, rtol=1e-6)
            else:
                assert (st[r] == np.float32(1e30)).all()
    # Fewer than 8 iterations reach only the rows whose branch came up.
    _, st = p2.sync("sweep8", tile, torch.zeros(128), 30, 0.0)
    swept = (st.numpy().reshape(8, 128) < 1e30).any(axis=1)
    assert swept.tolist() == [True, False, False, False, False, False, True,
                              True]


@pytest.mark.parametrize("depth", p2.DEPTHS)
def test_p2_plain_fetch(depth):
    _, _, _, tiles = p2.inputs("cpu")
    first = tiles.numpy().reshape(p2.N_TILES, -1)[:, 0]
    want = sum(int(first[(i - depth) % p2.N_TILES] > 0.0)
               for i in range(depth, ITERS))
    s = p2.fetch(tiles, depth, ITERS, 0.0)
    assert 0 < want < ITERS and bool((s == want).all())
    assert p2.launches == {"sync": 0, "fetch": 0}


def test_probe_entry_points_parse_and_need_a_card(monkeypatch, capsys):
    a = p2.parse_args([])
    assert (a.iters, a.reps) == (20000, 5)
    a = p2.parse_args(["--iters", "100", "--reps", "2"])
    assert (a.iters, a.reps) == (100, 2)
    assert vars(p1.parse_args([])) == {}
    with pytest.raises(SystemExit):
        p1.parse_args(["--step-kb", "32"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert p1.main([]) == 2 and p2.main(["--iters", "10"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
