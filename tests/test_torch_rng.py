"""The port's counter-based RNG (luisarender_tpu_torch/core/rng.py) against
the reference's (luisarender_tpu/core/rng.py): bit-exact.

PyTorch keeps uint32 words as int64 values in [0, 2^32); the reference uses
jnp.uint32. Inputs include 0, 0xFFFFFFFF and random words from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisarender_tpu.core import rng as jrng
from luisarender_tpu_torch.core import rng as trng


def _words(n, seed):
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 1, 0x80000000]
    return w


def _t(w):
    return torch.as_tensor(w.astype(np.int64))


def _bits_u32(x):
    return np.asarray(x).astype(np.uint32)


def _bits_f32(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n_words", [1, 2, 3, 4])
def test_xxhash32_bit_exact(n_words):
    words = [_words(4096, seed=10 + k) for k in range(n_words)]
    ref = jrng.xxhash32(*[jnp.asarray(w) for w in words])
    got = trng.xxhash32(*[_t(w) for w in words])
    np.testing.assert_array_equal(_bits_u32(got.numpy()), _bits_u32(ref))


def test_xxhash32_mixed_scalar_and_tensor_words():
    w = _words(1024, seed=3)
    ref = jrng.xxhash32(jnp.int32(7), jnp.asarray(w), 19980810)
    got = trng.xxhash32(7, _t(w), 19980810)
    np.testing.assert_array_equal(_bits_u32(got.numpy()), _bits_u32(ref))


def test_lcg_step_bit_exact_over_a_chain():
    state_j = jnp.asarray(_words(4096, seed=4))
    state_t = _t(np.asarray(state_j))
    for _ in range(16):
        state_j, u_j = jrng.lcg_step(state_j)
        state_t, u_t = trng.lcg_step(state_t)
        np.testing.assert_array_equal(_bits_u32(state_t.numpy()), _bits_u32(state_j))
        np.testing.assert_array_equal(_bits_f32(u_t.numpy()), _bits_f32(u_j))
        assert u_t.dtype == torch.float32 and float(u_t.max()) < 1.0


def test_seed_pixels_bit_exact():
    rs = np.random.RandomState(5)
    px = rs.randint(0, 4096, 2048).astype(np.int32)
    py = rs.randint(0, 4096, 2048).astype(np.int32)
    for sample_index in (0, 1, 255, 2**31 - 1):
        ref = jrng.seed_pixels(jnp.asarray(px), jnp.asarray(py),
                               jnp.int32(sample_index), 19980810)
        got = trng.seed_pixels(torch.as_tensor(px), torch.as_tensor(py),
                               sample_index, 19980810)
        np.testing.assert_array_equal(_bits_u32(got.numpy()), _bits_u32(ref))


def test_uniform_u32_to_float_bit_exact():
    w = _words(8192, seed=6)
    # words next to the float32 rounding boundaries of the top of the range
    w[4:8] = [0xFFFFFF7F, 0xFFFFFF80, 0xFFFFFF81, 0xFFFFFFFE]
    ref = jrng.uniform_u32_to_float(jnp.asarray(w))
    got = trng.uniform_u32_to_float(_t(w))
    np.testing.assert_array_equal(_bits_f32(got.numpy()), _bits_f32(ref))
    assert float(got.max()) == trng.ONE_MINUS_EPSILON


@pytest.mark.parametrize("fn", ["pcg", "pcg2d", "pcg3d", "pcg3d_counter"])
def test_pcg_hashes_bit_exact(fn):
    """pcg, pcg2d and pcg3d on random words; `pcg3d_counter` is the layered
    walk's draw, pcg3d(seed, k + 1, seed ^ 0x9E3779B9) with an int counter."""
    words = [_words(4096, seed=20 + k) for k in range(3)]
    if fn == "pcg3d_counter":
        ref = jrng.pcg3d(jnp.asarray(words[0]), jnp.uint32(3),
                         jnp.asarray(words[0]) ^ np.uint32(0x9E3779B9))
        got = trng.pcg3d(_t(words[0]), 3, _t(words[0]) ^ 0x9E3779B9)
    else:
        k = {"pcg": 1, "pcg2d": 2, "pcg3d": 3}[fn]
        ref = getattr(jrng, fn)(*[jnp.asarray(w) for w in words[:k]])
        got = getattr(trng, fn)(*[_t(w) for w in words[:k]])
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits_u32(g.numpy()), _bits_u32(r))
