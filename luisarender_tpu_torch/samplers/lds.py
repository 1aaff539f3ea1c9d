"""Low-discrepancy samplers: padded sobol, sobol, zsobol, pmj02bn, tileshared.

Counterpart of luisarender_tpu/samplers/lds.py, draw for draw: every draw
is an integer hash of (pixel, sample index, dimension) turned into a
float, bit-equal with the reference's on every lane.

- the first two Sobol dimensions (van der Corput bit reversal and the
  Pascal-matrix dimension) give a (0,2)-sequence pair; higher dimensions
  are padded: each dimension pair takes its own Owen-scrambled and
  index-shuffled copy (paddedsobol, zsobol);
- sobol walks the generated direction numbers of core/sobolgen.py;
- zsobol derives the sample index from base-4 digit permutations of the
  Morton code of (pixel, sample);
- pmj02bn reads progressive multi-jittered (0,2) tables generated at first
  use (`_generate_pmj02`), picked and rotated per pixel by blue-noise
  textures (core/bluenoise.py); tileshared shares the pick over 8x8 tiles.

A state is a dict of int64 tensors holding uint32 words (core/rng.py),
one entry a lane: `pixel` (the pixel's hash), `pixel_x`, `pixel_y`,
`sample`, `dim` (the next dimension), and for pmj02bn `bn` (..., 3), the
pixel's three blue-noise values. Bit loops that the reference unrolls run
as a tensor axis here: a word's 32 bits as a (..., 32) product with the
direction words, XOR-reduced in five halving steps, and zsobol's 16
digit prefixes hashed in one (..., 16) call. A 2D draw computes both
dimensions in one batched call.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core import cache, rng
from ..core.rng import MASK32, mul32, reverse_bits32
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import Sampler

# direction words of Sobol dimension 1 (the Pascal matrix)
_SOBOL_DIM1 = np.zeros(32, np.uint32)
_v = np.uint32(1 << 31)
for _j in range(32):
    _SOBOL_DIM1[_j] = _v
    _v = np.uint32(_v ^ (_v >> np.uint32(1)))

# zsobol's base-4 digit positions, most significant first
_DIGIT_SHIFTS = tuple(2 * (15 - i) for i in range(16))
# the 24 permutations of 4 digits, flattened: entry 4 p + d
_PERMS = tuple(d for p in itertools.permutations(range(4)) for d in p)

_CONSTS: dict = {}  # device -> the constant tensors above, copied there once


def _consts(device):
    c = _CONSTS.get(device)
    if c is None:
        def t(x):
            return torch.tensor(np.asarray(x, np.int64), device=device)

        c = _CONSTS[device] = {"bits": t(np.arange(32)), "dim1": t(_SOBOL_DIM1),
                               "digits": t(_DIGIT_SHIFTS), "perms": t(_PERMS)}
    return c


def _xor_reduce32(words):
    """XOR over the last axis of 32 words, in five halving steps."""
    for half in (16, 8, 4, 2, 1):
        words = words[..., :half] ^ words[..., half:]
    return words[..., 0]


def _bit_product(index, rows):
    """XOR of rows[..., j] over the set bits j of each uint32 index:
    index (...), rows (..., 32) or (32,)."""
    bits = (index[..., None] >> _consts(index.device)["bits"]) & 1
    return _xor_reduce32(bits * rows)


def sobol_2d(index):
    """The first two Sobol dimensions of uint32 indices: (d0, d1) words."""
    index = rng.u32(index)
    return reverse_bits32(index), _bit_product(index, _consts(index.device)["dim1"])


def owen_scramble(x, seed):
    """Laine-Karras hash-based nested uniform (Owen) scramble of uint32
    words."""
    x = reverse_bits32(x)
    x = (x + rng.u32(seed)) & MASK32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ mul32(x, c)
    return reverse_bits32(x)


class _LDSBase(Sampler):
    """The shared state (module docstring) and draws: a subclass gives
    `_sample_u32(state, dim)`, the word of dimension(s) dim, a tensor that
    broadcasts against the state's lanes."""

    def start(self, pixel_xy, sample_index):
        px = pixel_xy[..., 0].to(torch.int64)
        py = pixel_xy[..., 1].to(torch.int64)
        return {
            "pixel": rng.xxhash32(px, py, self.seed),
            "pixel_x": px,
            "pixel_y": py,
            "sample": torch.zeros_like(px) + rng.u32(sample_index),
            "dim": torch.zeros_like(px),
        }

    def _sample_u32(self, state, dim):
        raise NotImplementedError

    def generate_1d(self, state):
        u = rng.uniform_u32_to_float(self._sample_u32(state, state["dim"]))
        return {**state, "dim": state["dim"] + 1}, u

    def generate_2d(self, state):
        dim = state["dim"]
        u = rng.uniform_u32_to_float(self._sample_u32(state, torch.stack([dim, dim + 1])))
        return {**state, "dim": dim + 2}, torch.stack([u[0], u[1]], dim=-1)


@register(SceneNodeTag.SAMPLER, "paddedsobol", "PaddedSobol", "padded_sobol")
class PaddedSobolSampler(_LDSBase):
    """Per-dimension-pair Owen-scrambled Sobol (0,2) points with a hashed
    index shuffle."""

    def _sample_u32(self, state, dim):
        pair = dim >> 1
        comp = dim & 1
        shuffle_seed = rng.xxhash32(state["pixel"], pair, self.seed)
        d0, d1 = sobol_2d(owen_scramble(state["sample"], shuffle_seed))
        v = torch.where(comp == 0, d0, d1)
        return owen_scramble(v, rng.xxhash32(state["pixel"], pair, comp, self.seed + 1))


@register(SceneNodeTag.SAMPLER, "sobol", "Sobol")
class SobolMatrixSampler(_LDSBase):
    """The high-dimensional Sobol sequence of core/sobolgen.py's generated
    direction numbers, each pixel at its own sample index under a
    per-(pixel, dimension) Owen scramble; dimensions wrap at N_DIMS."""

    N_DIMS = 1024

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        from ..core.sobolgen import sobol_matrices

        self.matrices = sobol_matrices(self.N_DIMS).astype(np.int64)  # (D, 32)
        self._on = {}  # device -> the table there

    def _sample_u32(self, state, dim):
        dev = dim.device
        if dev not in self._on:
            self._on[dev] = torch.as_tensor(self.matrices, device=dev)
        rows = self._on[dev][dim % self.N_DIMS]  # (..., 32)
        x = _bit_product(state["sample"], rows)
        return owen_scramble(x, rng.xxhash32(state["pixel"], dim, self.seed))


def _spread(v):
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


@register(SceneNodeTag.SAMPLER, "zsobol", "ZSobol")
class ZSobolSampler(_LDSBase):
    """Morton-scrambled Owen Sobol: the sample index is the Morton code of
    (pixel, sample) under a hashed base-4 digit permutation a prefix."""

    def _scrambled_index(self, state, pair):
        c = _consts(pair.device)
        morton = ((((_spread(rng.u32(state["pixel_x"])) << 1)
                    | _spread(rng.u32(state["pixel_y"]))) << 8) & MASK32) \
            | (state["sample"] & 0xFF)
        digits = c["digits"]
        # the prefix above each digit; at the top digit a shift by 32: 0
        prefixes = morton[..., None] >> (digits + 2)
        p = rng.xxhash32(prefixes, pair[..., None], self.seed) % 24
        digit = (morton[..., None] >> digits) & 3
        # the permuted digits occupy disjoint bits: their sum is their OR
        return (c["perms"][p * 4 + digit] << digits).sum(dim=-1)

    def _sample_u32(self, state, dim):
        pair = dim >> 1
        comp = dim & 1
        d0, d1 = sobol_2d(self._scrambled_index(state, pair))
        v = torch.where(comp == 0, d0, d1)
        return owen_scramble(v, rng.xxhash32(pair, comp, self.seed + 1))


_PMJ02_CANDIDATES = 12  # free-bit assignments drawn a point


def _generate_pmj02(n: int, seed: int) -> np.ndarray:
    """Progressive multi-jittered (0,2) table with blue noise — the real
    pmj02bn construction (Christensen et al. 2018; pbrt-v4 ships the result
    as util/pmj02tables.h, we generate it).

    Realization: an Owen scramble is a pair of random binary trees (one flip
    bit per node); a scrambled Sobol (0,2) pair is a pmj02 sequence for ANY
    choice of flip bits. Building the trees *incrementally* — point i only
    ever visits tree nodes whose prefix is determined by its Sobol d-values —
    means every node first visited by point i is a free coin whose setting
    moves point i but no earlier point, and any setting preserves the (0,2)
    property. Blue noise drops out of best-candidate selection over those
    free bits: draw _PMJ02_CANDIDATES assignments, keep the one maximizing the
    toroidal min-distance to all previous points."""
    d0, d1 = (t.numpy().astype(np.uint32) for t in sobol_2d(torch.arange(n, dtype=torch.int64)))

    rs = np.random.RandomState(seed)
    # Tree bookkeeping is only needed down to level k = log2(n): distinct
    # Sobol d-values of an n-point prefix differ within their top-k bits
    # (both generator matrices are nonsingular on k-bit inputs), so below
    # level k every node is visited by exactly one point — those bits are
    # private free coins needing no dict.
    k_lvl = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    low_mask = np.uint64((1 << (32 - k_lvl)) - 1)
    trees = ({}, {})  # (level, prefix) -> flip bit
    pts = np.zeros((n, 2), np.float64)

    def base_and_mask(d, tree):
        """Scramble through fixed tree bits; free (new) bits are left 0 and
        returned as a mask. Candidates are base ^ (random & mask)."""
        d = int(d)
        x = 0
        mask = int(low_mask)
        new = []
        for lvl in range(k_lvl):
            key = (lvl, d >> (32 - lvl))
            flip = tree.get(key)
            pos = 31 - lvl
            if flip is None:
                new.append((key, pos))
                mask |= 1 << pos
                bit = (d >> pos) & 1
            else:
                bit = ((d >> pos) & 1) ^ flip
            x |= bit << pos
        x |= d & int(low_mask)  # low bits pass through; randomized via mask
        return np.uint64(x), np.uint64(mask), new

    for i in range(n):
        x0, mx, new0 = base_and_mask(d0[i], trees[0])
        y0, my, new1 = base_and_mask(d1[i], trees[1])
        nc = 1 if i == 0 else _PMJ02_CANDIDATES
        rx = rs.randint(0, 2**32, size=nc).astype(np.uint64) & mx
        ry = rs.randint(0, 2**32, size=nc).astype(np.uint64) & my
        xs = (x0 ^ rx).astype(np.float64) / 2.0**32
        ys = (y0 ^ ry).astype(np.float64) / 2.0**32
        if i == 0:
            best = 0
        else:
            dx = np.abs(pts[:i, 0][None, :] - xs[:, None])
            dy = np.abs(pts[:i, 1][None, :] - ys[:, None])
            dx = np.minimum(dx, 1.0 - dx)
            dy = np.minimum(dy, 1.0 - dy)
            best = int(np.argmax((dx * dx + dy * dy).min(axis=1)))
        # record the chosen free bits (the XOR flips the ORIGINAL d bit, so
        # the tree flip bit is exactly the chosen random bit)
        for key, pos in new0:
            trees[0][key] = (int(rx[best]) >> pos) & 1
        for key, pos in new1:
            trees[1][key] = (int(ry[best]) >> pos) & 1
        pts[i] = (xs[best], ys[best])
    return pts.astype(np.float32)


@register(SceneNodeTag.SAMPLER, "pmj02bn", "PMJ02BN", "pmj02", "PMJ02")
class PMJ02Sampler(_LDSBase):
    """PMJ02BN table sampler: per-pixel table pick and Cranley-Patterson
    rotations driven by blue-noise textures, the tables and textures
    generated at first use and cached (core/cache.py)."""

    N_TABLES = 5
    TABLE_SIZE = 1024
    BN_SIZE = 64

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        from ..core.bluenoise import bluenoise_texture

        path = cache.table_path(f"pmj02bn_{self.N_TABLES}x{self.TABLE_SIZE}",
                                ("../samplers/lds.py",))
        self.tables = cache.load_or_build(path, lambda: np.stack(
            [_generate_pmj02(self.TABLE_SIZE, 7919 + i) for i in range(self.N_TABLES)]))
        # (BN, BN, 3): table pick, rotation x, rotation y a texel
        self.bn = np.stack([bluenoise_texture(self.BN_SIZE, s) for s in range(3)], axis=-1)
        self._on = {}  # device -> (tables, bn) there

    def _device_tables(self, device):
        if device not in self._on:
            self._on[device] = (torch.as_tensor(self.tables, device=device),
                                torch.as_tensor(self.bn, device=device))
        return self._on[device]

    def start(self, pixel_xy, sample_index):
        state = super().start(pixel_xy, sample_index)
        return self._with_bn(state, state["pixel_x"], state["pixel_y"])

    def _with_bn(self, state, x, y):
        """The blue-noise values of texel (x, y) mod BN_SIZE, (..., 3)."""
        _, bn = self._device_tables(x.device)
        return {**state, "bn": bn[y % self.BN_SIZE, x % self.BN_SIZE]}

    def _sample_2d_table(self, state, pair):
        tables, _ = self._device_tables(pair.device)
        bn = state["bn"]

        def u(*words):
            return rng.uniform_u32_to_float(rng.xxhash32(*words))

        # a toroidal shift of the blue-noise value per dimension pair
        shift = u(pair, 0x9E3779B9, self.seed)
        t = (torch.fmod(bn[..., 0] + shift, 1.0) * self.N_TABLES).to(torch.int64)
        pt = tables[t, state["sample"] % self.TABLE_SIZE]
        rx = torch.fmod(bn[..., 1] + u(pair, 1, self.seed + 1), 1.0)
        ry = torch.fmod(bn[..., 2] + u(pair, 2, self.seed + 2), 1.0)
        return torch.fmod(pt[..., 0] + rx, 1.0), torch.fmod(pt[..., 1] + ry, 1.0)

    def _sample_u32(self, state, dim):
        x, y = self._sample_2d_table(state, dim >> 1)
        v = torch.where((dim & 1) == 0, x, y)
        return (v * 4294967296.0).to(torch.int64)


@register(SceneNodeTag.SAMPLER, "tileshared", "TileShared", "tile_shared")
class TileSharedSampler(PMJ02Sampler):
    """pmj02bn with the pixel hash and the blue-noise values shared by the
    pixels of a TILE x TILE tile."""

    TILE = 8

    def start(self, pixel_xy, sample_index):
        state = _LDSBase.start(self, pixel_xy, sample_index)
        tx = state["pixel_x"] // self.TILE
        ty = state["pixel_y"] // self.TILE
        state["pixel"] = rng.xxhash32(tx, ty, self.seed)
        return self._with_bn(state, tx, ty)
