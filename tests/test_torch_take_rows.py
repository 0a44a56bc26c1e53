"""vecmath.take_rows of rgk_tpu_torch (K5's plain route on the CPU)
against rgk_tpu's, on inputs made with numpy from a seed.

Tolerances: the rows bit for bit (the reference's one-hot product is
exact on the CPU: one product by 1 and zeros; an int table's `rint` of
it too), the 1025-row fallback gather likewise; the table's gradient
within 1e-5 x max|reference gradient| (both are float32 sums of the
same terms, added in another order); gradcheck at its float64 defaults.
The slice: the renderer's radiance bit for bit against the same render
with every `take_rows` replaced by plain indexing (the route before
K5), its gradient within 1e-5 x the leaf's largest.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.ops import lights as jlights
from rgk_tpu.ops import vecmath as jvm
from rgk_tpu.scene.arrays import LightTable as JLightTable
from rgk_tpu_torch.diff.params import extract_params, make_loss_fn
from rgk_tpu_torch.integrator import path as tpath
from rgk_tpu_torch.ops import lights as tlights
from rgk_tpu_torch.ops import vecmath as tvm
from rgk_tpu_torch.scene.arrays import LightTable as TLightTable
from rgk_tpu_torch.scene.config import build_scene, load_config

R = 4096


def _table(rng, m, k, dtype):
    if dtype == "i32":
        return rng.integers(-1_000_000, 1_000_000, (m, k)).astype(np.int32)
    return rng.normal(size=(m, k)).astype(np.float32)


def _ref_rows(table, idx):
    return np.asarray(jvm.take_rows(jnp.asarray(table), jnp.asarray(idx)))


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("k", [8, 15, 20])
@pytest.mark.parametrize("m", [1, 7, 1024])
def test_rows_bit_equal(m, k, dtype):
    rng = np.random.default_rng(m * 100 + k)
    table = _table(rng, m, k, dtype)
    idx = rng.integers(0, m, R).astype(np.int32)
    got = tvm.take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got.numpy(), _ref_rows(table, idx))
    np.testing.assert_array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("shape", [(R,), (64, 64), (16, 8, 32)])
def test_any_rank_of_ids(shape):
    rng = np.random.default_rng(5)
    table = _table(rng, 20, 15, "f32")
    idx = rng.integers(0, 20, shape).astype(np.int32)
    got = tvm.take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert tuple(got.shape) == shape + (15,)
    np.testing.assert_array_equal(got.numpy(), _ref_rows(table, idx))


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_large_table_falls_back_to_the_gather(dtype):
    rng = np.random.default_rng(9)
    m = tvm.MATMUL_GATHER_MAX_ROWS + 1
    table = _table(rng, m, 24, dtype)
    idx = rng.integers(0, m, R).astype(np.int32)
    t = torch.from_numpy(table).requires_grad_(dtype == "f32")
    got = tvm.take_rows(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  _ref_rows(table, idx))
    if dtype == "f32":
        assert got.grad_fn.name() == "IndexBackward0"


def test_out_of_range_ids_give_a_zero_row():
    rng = np.random.default_rng(11)
    m = 7
    table = _table(rng, m, 20, "f32")
    idx = rng.integers(0, m, 256).astype(np.int32)
    idx[::5] = -1
    idx[1::7] = m
    idx[2::11] = m + 40
    out = ~((idx >= 0) & (idx < m))
    ref = _ref_rows(table, idx)
    assert not ref[out].any()  # the reference's one-hot route
    got = tvm.take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)
    itab = _table(rng, m, 4, "i32")
    np.testing.assert_array_equal(
        tvm.take_rows(torch.from_numpy(itab), torch.from_numpy(idx)).numpy(),
        _ref_rows(itab, idx))
    # ... and such a lane adds nothing to the table's gradient.
    g = rng.normal(size=(256, 20)).astype(np.float32)
    got_g = tvm.take_rows_backward_plain(torch.from_numpy(g),
                                         torch.from_numpy(idx), m)
    want = np.zeros((m, 20), np.float64)
    np.add.at(want, idx[~out], g[~out].astype(np.float64))
    np.testing.assert_allclose(got_g.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,k", [(1, 8), (7, 20), (40, 15), (1024, 20)])
def test_table_gradient_matches_jax_vjp(m, k):
    rng = np.random.default_rng(17 + m)
    table = _table(rng, m, k, "f32")
    idx = rng.integers(0, m, R).astype(np.int32)
    g = rng.normal(size=(R, k)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jvm.take_rows(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    t = torch.from_numpy(table).requires_grad_(True)
    rows = tvm.take_rows(t, torch.from_numpy(idx))
    assert rows.grad_fn.name() == "_TakeRowsBackward"
    (got,) = torch.autograd.grad(rows, [t], torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# K5's dispatch on the card: the backward takes its small-table route up
# to SMALL_ROWS rows (16-byte loads when the row width allows, else a
# word stream), the grouped route above; the forward fixes the widths the
# renderer passes at compile time and reads others at run time.
SMALL_ROWS = 8


@pytest.mark.parametrize("k", [8, 15, 20, 45])
@pytest.mark.parametrize("m", [SMALL_ROWS - 1, SMALL_ROWS, SMALL_ROWS + 1])
def test_rows_and_gradient_at_the_dispatch_shapes(m, k):
    """Tables either side of the small-table bound, widths of 16-byte
    rows (8, 20) and of others (15, 45), 4099 ids (no multiple of a warp
    or a tile), one in 13 outside [0, M): the rows against the
    reference's bit for bit, and the table's gradient within 1e-5 x its
    largest entry of a float64 index_add_."""
    rng = np.random.default_rng(1000 * m + k)
    r = 4099
    table = _table(rng, m, k, "f32")
    idx = rng.integers(0, m, r).astype(np.int32)
    idx[::13] = np.where(np.arange(idx[::13].size) % 2 == 0, -1, m + 3)
    t = torch.from_numpy(table).requires_grad_(True)
    rows = tvm.take_rows(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(rows.detach().numpy(),
                                  _ref_rows(table, idx))
    g = rng.normal(size=(r, k)).astype(np.float32)
    (got,) = torch.autograd.grad(rows, [t], torch.from_numpy(g))
    ok = (idx >= 0) & (idx < m)
    want = torch.zeros((m, k), dtype=torch.float64).index_add_(
        0, torch.from_numpy(idx[ok]).long(),
        torch.from_numpy(g[ok]).double()).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_gradcheck_on_the_plain_route():
    rng = np.random.default_rng(23)
    table = torch.from_numpy(rng.normal(size=(6, 5))).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(-1, 7, (4, 9)).astype(np.int32))
    assert torch.autograd.gradcheck(lambda t: tvm.take_rows(t, idx),
                                    (table,))


def test_no_gradient_for_ids_or_without_a_table_gradient():
    idx = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
    t = torch.ones((3, 2), dtype=torch.float32)
    assert tvm.take_rows(t, idx).grad_fn is None
    t.requires_grad_(True)
    with torch.no_grad():
        assert tvm.take_rows(t, idx).grad_fn is None
    rows = tvm.take_rows(t, idx)
    (g,) = torch.autograd.grad(rows.sum(), [t])
    np.testing.assert_array_equal(g.numpy(), [[1, 1], [1, 1], [2, 2]])


def test_take_is_the_plain_gather():
    rng = np.random.default_rng(29)
    table = rng.normal(size=(50, 3)).astype(np.float32)
    idx = rng.integers(0, 50, (8, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        tvm.take(torch.from_numpy(table), torch.from_numpy(idx)).numpy(),
        np.asarray(jvm.take(jnp.asarray(table), jnp.asarray(idx))))


def test_point_light_row_fetch_matches_reference():
    """sample_light with five point lights and three emissive triangles
    (random tables, both classes drawn): every field as the reference's
    `take_rows` of its point pack gives it, bit for bit."""
    rng = np.random.default_rng(31)
    p, a = 5, 3
    power = rng.uniform(0.5, 2.0, p).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, a).astype(np.float32)
    tables = dict(
        point_pos=rng.normal(size=(p, 3)).astype(np.float32),
        point_color=rng.uniform(size=(p, 3)).astype(np.float32),
        point_intensity=power,
        point_size=rng.uniform(0, 0.2, p).astype(np.float32),
        point_cum=np.cumsum(power).astype(np.float32),
        areal_tri=np.arange(a, dtype=np.int32),
        areal_cum=np.cumsum(weight).astype(np.float32),
        areal_rows=rng.normal(size=(a, 15)).astype(np.float32),
        total_point_power=np.float32(power.sum()),
        total_areal_power=np.float32(weight.sum()))

    class Scene:
        pass

    js, ts = Scene(), Scene()
    js.lights = JLightTable(**{k: jnp.asarray(v) for k, v in tables.items()})
    ts.lights = TLightTable(**{k: torch.from_numpy(np.asarray(v))
                               for k, v in tables.items()})
    choice = rng.random((R, 2), dtype=np.float32)
    tri2 = rng.random((R, 2), dtype=np.float32)
    jl = jlights.sample_light(js, jnp.asarray(choice),
                              jnp.zeros(R, jnp.float32), jnp.asarray(tri2))
    tl = tlights.sample_light(ts, torch.from_numpy(choice),
                              torch.from_numpy(tri2))
    assert set(np.unique(tl.kind.numpy())) == {0, 1}
    for f in ("kind", "color", "intensity", "size", "valid"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)))
    point = tl.kind.numpy() == 0
    for f in ("pos", "normal"):
        np.testing.assert_array_equal(getattr(tl, f).numpy()[point],
                                      np.asarray(getattr(jl, f))[point])


def _plain_indexing(table2d, idx):
    return table2d[idx.long()]


@pytest.fixture(scope="module")
def grad_box(tmp_path_factory):
    """The box plus a point light at 8x8, 2 spp: the gradient cell of
    the card's smoke test, cut to size."""
    d = tmp_path_factory.mktemp("grad_box")
    cfg = scenes.box_config(res=8, ms=2)
    cfg["lights"] = [{"position": [0.8, 2.2, 1.0], "color": [1.0, 0.95, 0.9],
                      "intensity": 3.0}]
    c = load_config(scenes.write_config(d, cfg))
    arrays, meta, _ = build_scene(c, "cpu")
    pix = torch.arange(64)
    px = (pix % 8).to(torch.int32).repeat(2)
    py = (pix // 8).to(torch.int32).repeat(2)
    si = torch.arange(2).repeat_interleave(64)
    return arrays, meta, c, px, py, si


def _loss_and_grads(grad_box):
    arrays, meta, c, px, py, si = grad_box
    target = torch.zeros(px.shape[0], 3)
    loss_fn = make_loss_fn(arrays, meta, c.settings, c.get_camera(), px, py,
                           si, 42, target)
    params = extract_params(arrays)
    loss = loss_fn(params)
    return loss, dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True)))


def test_slice_through_take_rows_equals_plain_indexing(grad_box,
                                                       monkeypatch):
    """The renderer through `take_rows` against the same renderer with
    plain indexing at every one of its sites: the radiance bit for bit
    (K5's route copies the same rows), the loss equal, the gradients
    within 1e-5 x the leaf's largest (another summation order)."""
    arrays, meta, c, px, py, si = grad_box
    cam = c.get_camera()
    rad = tpath.render_lanes(arrays, meta, c.settings, cam, px, py, si, 42,
                             differentiable=True).radiance
    loss, grads = _loss_and_grads(grad_box)
    monkeypatch.setattr(tvm, "take_rows", _plain_indexing)
    rad_plain = tpath.render_lanes(arrays, meta, c.settings, cam, px, py, si,
                                   42, differentiable=True).radiance
    loss_plain, grads_plain = _loss_and_grads(grad_box)
    assert torch.equal(rad, rad_plain)
    assert float(loss.detach()) == float(loss_plain.detach())
    for k, g in grads_plain.items():
        if g is None:
            assert grads[k] is None
            continue
        top = float(g.abs().max())
        assert float((grads[k] - g).abs().max()) <= 1e-5 * top + 1e-12, k


def test_every_reference_site_goes_through_take_rows(grad_box):
    """The gradient's graph: the material, point-light and areal-light
    row fetches are `take_rows` (K5) nodes; the one gather left to
    plain indexing is `apply_params`' emission of the areal rows, which
    the reference also indexes plainly."""
    arrays, meta, c, px, py, si = grad_box
    loss_fn = make_loss_fn(arrays, meta, c.settings, c.get_camera(), px, py,
                           si, 42, torch.zeros(px.shape[0], 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.autograd.detect_anomaly(check_nan=False):
            loss = loss_fn(extract_params(arrays))
    nodes, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or (fn.name(), fn._sequence_nr()) in seen:
            continue
        seen.add((fn.name(), fn._sequence_nr()))
        todo.extend(f for f, _ in fn.next_functions)
        if fn.name() in ("IndexBackward0", "_TakeRowsBackward"):
            tb = "".join(fn.metadata["traceback_"])
            nodes.append((fn.name(), tb))
    depth = int(c.settings.recursion_max)
    takes = [tb for name, tb in nodes if name == "_TakeRowsBackward"]
    plain = [tb for name, tb in nodes if name == "IndexBackward0"]
    assert sum("_shade_point" in tb for tb in takes) == depth
    assert sum("sample_light" in tb for tb in takes) == 2
    assert len(takes) == depth + 2
    assert len(plain) == 1 and "apply_params" in plain[0]
