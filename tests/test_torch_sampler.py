"""Port parity: the counter-based sampler of rgk_tpu_torch against
rgk_tpu's, on the same random (seed, pixel, sample) and dims 0-20.

Tolerance: none.  Values must be bitwise equal (compared as uint32
bit patterns), in all five modes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgk_tpu.ops import sampler as jsmp
from rgk_tpu_torch.ops import sampler as tsmp

N_LANES = 4096
DIMS = range(21)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    root = int(rng.integers(0, 2**32, dtype=np.uint64))
    pixel = rng.integers(0, 2**32, N_LANES, dtype=np.uint64).astype(np.uint32)
    sample = rng.integers(0, 2**24, N_LANES, dtype=np.uint64).astype(np.uint32)
    return root, pixel, sample


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_hash_u32_bitwise():
    root, pixel, sample = _inputs(1)
    ref = np.asarray(jsmp.hash_u32(jnp.asarray(pixel), jnp.asarray(sample),
                                   jnp.uint32(7), jnp.uint32(root)))
    got = tsmp.hash_u32(_t(pixel), _t(sample), 7, root).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    # Negative int32 parts wrap to u32 as in the reference.
    neg = -np.arange(1, N_LANES + 1, dtype=np.int32)
    ref = np.asarray(jsmp.hash_u32(jnp.asarray(neg), jnp.uint32(root)))
    got = tsmp.hash_u32(torch.from_numpy(neg), root).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("mode", sorted(set(jsmp.MODE_NAMES.values())))
def test_sample_bitwise(mode):
    root, pixel, sample = _inputs(2 + mode)
    for n_set in (1, 16):
        jctx = jsmp.SampleCtx(seed=jnp.uint32(root), pixel=jnp.asarray(pixel),
                              sample=jnp.asarray(sample), mode=mode,
                              n_set=n_set)
        tctx = tsmp.SampleCtx(seed=root, pixel=_t(pixel), sample=_t(sample),
                              mode=mode, n_set=n_set)
        for dim in DIMS:
            ref1 = np.asarray(jsmp.sample_1d(jctx, dim))
            got1 = tsmp.sample_1d(tctx, dim).numpy()
            np.testing.assert_array_equal(
                got1.view(np.uint32), ref1.view(np.uint32),
                err_msg=f"sample_1d mode={mode} n_set={n_set} dim={dim}")
            ref2 = np.asarray(jsmp.sample_2d(jctx, dim))
            got2 = tsmp.sample_2d(tctx, dim).numpy()
            np.testing.assert_array_equal(
                got2.view(np.uint32), ref2.view(np.uint32),
                err_msg=f"sample_2d mode={mode} n_set={n_set} dim={dim}")


def test_per_lane_seed_bitwise():
    """The integrator's per-bounce context: a per-lane seed from
    hash_u32(seed, tag, bounce + 1), mode independent."""
    root, pixel, sample = _inputs(9)
    bounce = (sample % 7).astype(np.uint32)
    jseed = jsmp.hash_u32(jnp.uint32(root), jnp.uint32(1),
                          jnp.asarray(bounce) + jnp.uint32(1))
    tseed = tsmp.hash_u32(root, 1, _t(bounce) + 1)
    jctx = jsmp.SampleCtx(seed=jseed, pixel=jnp.asarray(pixel),
                          sample=jnp.asarray(sample), mode=0, n_set=4)
    tctx = tsmp.SampleCtx(seed=tseed, pixel=_t(pixel), sample=_t(sample),
                          mode=0, n_set=4)
    for dim in (11, 13):
        ref = np.asarray(jsmp.sample_2d(jctx, dim))
        got = tsmp.sample_2d(tctx, dim).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
