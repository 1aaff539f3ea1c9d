"""Stateless, counter-based random number generation, bit-exact with
luisarender_tpu/core/rng.py.

PyTorch has no usable uint32 arithmetic on the CPU, so a uint32 word is an
int64 tensor holding a value in [0, 2^32). Products with a 32-bit constant
are taken in 16-bit halves so that no partial product reaches 2^49 and
nothing relies on signed wraparound.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

PRIME32_2 = 2246822519
PRIME32_3 = 3266489917
PRIME32_4 = 668265263
PRIME32_5 = 374761393

LCG_A = 0x0019660D
LCG_C = 0x3C6EF35F

# 1/2^32; multiplying a uint32 (as float32) by it gives a float in [0, 1]
_INV_U32 = 2.3283064365386963e-10
# largest float32 strictly below 1.0
ONE_MINUS_EPSILON = 1.0 - 2.0 ** -24


def u32(x):
    """The uint32 value of x, read as two's complement like
    `astype(uint32)`: an int64 tensor for an integer tensor, an int for an
    int (so that a constant word never becomes a tensor copied to the
    device, which would wait for the card)."""
    if not torch.is_tensor(x):
        return int(x) & MASK32
    return x.to(torch.int64) & MASK32


def mul32(a, m):
    """(a * m) mod 2^32 for a uint32 word tensor a and m an int or a
    uint32 word tensor that broadcasts against a."""
    lo = m & 0xFFFF
    hi = (m >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def reverse_bits32(x):
    """The 32 bits of each uint32 word in reverse order (the reference's
    samplers/lds.py `_reverse_bits32`): swap halves, bytes, nibbles,
    pairs, bits."""
    x = u32(x)
    x = ((x << 16) | (x >> 16)) & MASK32
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    return ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)


def xxhash32(*words):
    """xxhash32 over 1..4 uint32 words (tensors broadcast together)."""
    words = [u32(w) for w in words]
    h = u32(PRIME32_5 + 4 * len(words))
    for w in words:
        h = (h + mul32(w, PRIME32_3)) & MASK32
        h = mul32(_rotl(h, 17), PRIME32_4)
    h = mul32(h ^ (h >> 15), PRIME32_2)
    h = mul32(h ^ (h >> 13), PRIME32_3)
    return h ^ (h >> 16)


def pcg(v):
    """The PCG output function of a uint32 state."""
    state = (mul32(u32(v), 747796405) + 2891336453) & MASK32
    word = mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def _lcg16(v):
    return (mul32(v, 1664525) + 1013904223) & MASK32


def pcg2d(v0, v1):
    """The 2D PCG hash: two decorrelated uint32 streams."""
    v0, v1 = _lcg16(u32(v0)), _lcg16(u32(v1))
    for _ in range(2):
        v0 = (v0 + mul32(v1, 1664525)) & MASK32
        v1 = (v1 + mul32(v0, 1664525)) & MASK32
        v0, v1 = v0 ^ (v0 >> 16), v1 ^ (v1 >> 16)
    return v0, v1


def pcg3d(v0, v1, v2):
    """The 3D PCG hash of three uint32 words (tensors or ints that
    broadcast together)."""
    v0, v1, v2 = u32(v0), u32(v1), u32(v2)
    for i in range(2):
        v0, v1, v2 = _lcg16(v0), _lcg16(v1), _lcg16(v2)
        v0 = (v0 + mul32(v1, v2)) & MASK32
        v1 = (v1 + mul32(v2, v0)) & MASK32
        v2 = (v2 + mul32(v0, v1)) & MASK32
        if i == 0:
            v0, v1, v2 = v0 ^ (v0 >> 16), v1 ^ (v1 >> 16), v2 ^ (v2 >> 16)
    return v0, v1, v2


def uniform_u32_to_float(bits):
    """uint32 word -> float32 in [0, 1), rounded like the reference."""
    f = u32(bits).to(torch.float32) * _INV_U32
    return torch.clamp(f, max=ONE_MINUS_EPSILON)


def lcg_step(state):
    """One LCG step: (state * A + C) mod 2^32. Returns (new_state, u)."""
    new_state = (mul32(u32(state), LCG_A) + LCG_C) & MASK32
    return new_state, uniform_u32_to_float(new_state)


def lcg_jump(k: int):
    """(A_k, C_k): k LCG steps as one, state_k = (A_k * state + C_k) mod
    2^32 (exact modular arithmetic, so the states are the ones k single
    steps give)."""
    a, c = 1, 0
    for _ in range(k):
        a, c = (a * LCG_A) & MASK32, (c * LCG_A + LCG_C) & MASK32
    return a, c


_JUMPS: dict = {}  # (device, ks) -> the jumps' (A, C) columns, copied there once


def lcg_states(state, ks):
    """The states k steps after `state` (N,) for each k of ks: (len(ks), N),
    in one batched jump."""
    key = (state.device, tuple(ks))
    if key not in _JUMPS:
        jumps = torch.tensor([lcg_jump(k) for k in ks], dtype=torch.int64)
        _JUMPS[key] = jumps.to(state.device)[:, :, None]
    a, c = _JUMPS[key].unbind(1)
    return (mul32(u32(state)[None, :], a) + c) & MASK32


def seed_pixels(pixel_x, pixel_y, sample_index, seed):
    """Per-(pixel, sample) state: xxhash32(sample_index, x, y, seed)."""
    return xxhash32(sample_index, pixel_x, pixel_y, seed)
