"""Port parity: textures, lights, LTC and the BxDFs of rgk_tpu_torch
against rgk_tpu's, on random inputs made with numpy from a seed.

Scene data comes from the "zoo" scene (every BxDF type, textures, bump
map, envmap sky, sized point lights), committed by both builders.

Tolerance: rtol 1e-5 / atol 1e-6 (float32 transcendentals and sums in
another library); discrete outputs (light kind, leak flags) equal.
Sampled directions near the horizon (0 < |z| < 0.05, local frame)
are held to atol 1e-4 instead: there the cosine warp's
z = sqrt(1 - x^2 - y^2) amplifies a 1-ulp difference between the two
libraries' sin/cos by about 1/z^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes as scenes
from rgk_tpu.ops import bxdf as jbxdf
from rgk_tpu.ops import lights as jlights
from rgk_tpu.ops import ltc as jltc
from rgk_tpu.ops import textures as jtex
from rgk_tpu_torch.ops import bxdf as tbxdf
from rgk_tpu_torch.ops import lights as tlights
from rgk_tpu_torch.ops import ltc as tltc
from rgk_tpu_torch.ops import textures as ttex

RTOL, ATOL = 1e-5, 1e-6
N = 4096


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo")
    path = scenes.write_config(d, scenes.zoo_config(d))
    _, jarrays, jmeta, _ = scenes.jax_build(path)
    tarrays, tmeta, _ = scenes.port_build(path)
    return jarrays, tarrays, tmeta


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x)


def test_textures(zoo):
    jarr, tarr, _ = zoo
    rng = np.random.default_rng(1)
    n_tex = tarr.textures.desc.shape[0]
    tex_id = rng.integers(-1, n_tex, N).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    solid = rng.random((N, 3), dtype=np.float32)
    jt, tt = _both(tex_id)
    ju, tu = _both(uv)
    js, ts = _both(solid)
    _close(ttex.sample_bilinear(tarr.textures, tt.clamp(min=0), tu),
           jtex.sample_bilinear(jarr.textures, jnp.maximum(jt, 0), ju))
    _close(ttex.resolve_color(tarr.textures, tt, ts, tu),
           jtex.resolve_color(jarr.textures, jt, js, ju))
    for got, ref in zip(ttex.bump_slopes(tarr.textures, tt.clamp(min=0), tu),
                        jtex.bump_slopes(jarr.textures, jnp.maximum(jt, 0),
                                         ju)):
        _close(got, ref)


@pytest.mark.parametrize("has_envmap", [True, False])
def test_sky_radiance(zoo, has_envmap):
    jarr, tarr, _ = zoo
    jd, td = _both(_unit(np.random.default_rng(2), N))
    _close(ttex.sky_radiance(tarr, td, has_envmap=has_envmap),
           jtex.sky_radiance(jarr, jd, has_envmap=has_envmap))


def test_lights(zoo):
    jarr, tarr, _ = zoo
    rng = np.random.default_rng(3)
    choice = rng.random((N, 2), dtype=np.float32)
    tri2 = rng.random((N, 2), dtype=np.float32)
    areal = rng.random((N, 2), dtype=np.float32)
    jl = jlights.sample_light(jarr, jnp.asarray(choice),
                              jnp.zeros(N, jnp.float32), jnp.asarray(tri2))
    tl = tlights.sample_light(tarr, torch.from_numpy(choice),
                              torch.from_numpy(tri2))
    kinds = tl.kind.numpy()
    assert set(np.unique(kinds)) == {0, 1}  # both classes are drawn
    np.testing.assert_array_equal(kinds, np.asarray(jl.kind))
    np.testing.assert_array_equal(tl.valid.numpy(), np.asarray(jl.valid))
    jl2 = jlights.offset_sphere_light(jl, jnp.asarray(areal))
    tl2 = tlights.offset_sphere_light(tl, torch.from_numpy(areal))
    for f in ("pos", "color", "intensity", "size", "normal"):
        _close(getattr(tl, f), getattr(jl, f))
        _close(getattr(tl2, f), getattr(jl2, f))
    v = _unit(rng, N)
    _close(tl2.directional_factor(torch.from_numpy(v)),
           jl2.directional_factor(jnp.asarray(v)))


def test_ltc(zoo):
    jarr, tarr, _ = zoo
    jt = jltc.LTCTables(rows=jarr.ltc_rows)
    tt = tltc.LTCTables(rows=tarr.ltc_rows)
    rng = np.random.default_rng(4)
    kind = rng.integers(0, 2, N).astype(np.int32)
    theta = rng.uniform(0.0, 1.6, N).astype(np.float32)
    alpha = rng.uniform(0.0, 1.2, N).astype(np.float32)
    v_frame = _unit(rng, N)
    v_frame[:, 2] = np.abs(v_frame[:, 2])
    v_eval = _unit(rng, N)
    hscos = _unit(rng, N)
    hscos[:, 2] = np.abs(hscos[:, 2])
    J = [jnp.asarray(x) for x in (kind, theta, alpha, v_frame, v_eval,
                                  hscos)]
    T = [torch.from_numpy(x) for x in (kind, theta, alpha, v_frame, v_eval,
                                       hscos)]
    for got, ref in zip(tltc.fetch_bilinear(tt, T[0], T[1], T[2]),
                        jltc.fetch_bilinear(jt, J[0], J[1], J[2])):
        _close(got, ref)
    _close(tltc.pdf(tt, T[0], T[3], T[4], T[2]),
           jltc.pdf(jt, J[0], J[3], J[4], J[2]))
    _close(tltc.sample(tt, T[0], T[3], T[2], T[5]),
           jltc.sample(jt, J[0], J[3], J[2], J[5]))


def _bxdf_inputs(tmeta, seed):
    """Random lanes over every material; vr is a random direction, the
    mirror direction or the inverse direction in turn, so the delta
    lobes' eval branches are taken too."""
    rng = np.random.default_rng(seed)
    mat_id = np.arange(N, dtype=np.int32) % tmeta.n_materials
    rng.shuffle(mat_id)
    vi = _unit(rng, N)
    vr = _unit(rng, N)
    vr[1::3] = vi[1::3] * np.array([-1, -1, 1], np.float32)
    vr[2::3] = -vi[2::3]
    uv = rng.uniform(-1.0, 2.0, (N, 2)).astype(np.float32)
    u2 = rng.random((N, 2), dtype=np.float32)
    return mat_id, vi, vr, uv, u2


def test_material_pack(zoo):
    jarr, tarr, _ = zoo
    np.testing.assert_array_equal(
        tbxdf.build_mat_pack(tarr.materials).numpy(),
        np.asarray(jbxdf.build_mat_pack(jarr.materials)))


def test_eval_bxdf_every_type(zoo):
    jarr, tarr, tmeta = zoo
    assert set(tarr.materials.bxdf_type.tolist()) == set(range(9))
    mat_id, vi, vr, uv, _ = _bxdf_inputs(tmeta, 5)
    jpack = jbxdf.build_mat_pack(jarr.materials)
    tpack = tbxdf.build_mat_pack(tarr.materials)
    ref = jbxdf.eval_bxdf(jarr, jpack, jnp.asarray(mat_id), jnp.asarray(vi),
                          jnp.asarray(vr), jnp.asarray(uv),
                          jltc.LTCTables(rows=jarr.ltc_rows))
    got = tbxdf.eval_bxdf(tarr, tpack, torch.from_numpy(mat_id),
                          torch.from_numpy(vi), torch.from_numpy(vr),
                          torch.from_numpy(uv),
                          tltc.LTCTables(rows=tarr.ltc_rows))
    _close(got, ref)
    assert (got.abs().sum(-1) > 0).float().mean() > 0.2


def test_sample_bxdf_every_type(zoo):
    jarr, tarr, tmeta = zoo
    mat_id, vi, _, uv, u2 = _bxdf_inputs(tmeta, 6)
    jpack = jbxdf.build_mat_pack(jarr.materials)
    tpack = tbxdf.build_mat_pack(tarr.materials)
    jd, jthr, jleak = jbxdf.sample_bxdf(
        jarr, jpack, jnp.asarray(mat_id), jnp.asarray(vi), jnp.asarray(uv),
        jnp.asarray(u2), jltc.LTCTables(rows=jarr.ltc_rows))
    td, tthr, tleak = tbxdf.sample_bxdf(
        tarr, tpack, torch.from_numpy(mat_id), torch.from_numpy(vi),
        torch.from_numpy(uv), torch.from_numpy(u2),
        tltc.LTCTables(rows=tarr.ltc_rows))
    td, jd = td.numpy(), np.asarray(jd)
    grazing = (np.abs(jd[:, 2]) < 0.05) & (jd[:, 2] != 0.0)
    assert grazing.mean() < 0.05
    _close(td[~grazing], jd[~grazing])
    np.testing.assert_allclose(td[grazing], jd[grazing], atol=1e-4)
    _close(tthr, jthr)
    np.testing.assert_array_equal(tleak.numpy(), np.asarray(jleak))
    assert tleak.any() and not tleak.all()
