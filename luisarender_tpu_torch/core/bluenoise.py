"""Blue-noise rank textures by void-and-cluster (Ulichney 1993).

Counterpart of luisarender_tpu/core/bluenoise.py, a copy of its host numpy
arithmetic: on a toroidal grid with a Gaussian energy kernel, a random
minority pattern is relaxed (tightest cluster into largest void), then
ranked downward by removing tightest clusters and upward by filling
largest voids. rank / n^2 is a uniform [0, 1) value a pixel whose spectrum
holds only high frequencies. The pmj02bn sampler reads three such textures
for its table pick and rotations; each is built at first use and cached
(core/cache.py).
"""

from __future__ import annotations

import numpy as np

from . import cache

SIGMA = 1.5


def _energy_kernel(n: int) -> np.ndarray:
    """Toroidal Gaussian filter as a (n, n) kernel centered at (0, 0)."""
    ax = np.arange(n, dtype=np.float64)
    d = np.minimum(ax, n - ax)  # toroidal distance per axis
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * SIGMA * SIGMA))


class _Field:
    """Binary pattern + incrementally-maintained filtered energy."""

    def __init__(self, n: int):
        self.n = n
        self.kernel = _energy_kernel(n)
        self.energy = np.zeros((n, n), np.float64)
        self.pattern = np.zeros((n, n), bool)

    def set(self, y: int, x: int, value: bool):
        if self.pattern[y, x] == value:
            return
        self.pattern[y, x] = value
        sign = 1.0 if value else -1.0
        self.energy += sign * np.roll(
            np.roll(self.kernel, y, axis=0), x, axis=1
        )

    def tightest_cluster(self):
        e = np.where(self.pattern, self.energy, -np.inf)
        return np.unravel_index(np.argmax(e), e.shape)

    def largest_void(self):
        e = np.where(self.pattern, np.inf, self.energy)
        return np.unravel_index(np.argmin(e), e.shape)


def _prototype(n: int, rng: np.random.RandomState) -> _Field:
    f = _Field(n)
    count = max(n * n // 10, 1)
    flat = rng.choice(n * n, count, replace=False)
    for i in flat:
        f.set(i // n, i % n, True)
    # relax: move tightest cluster into largest void until stable
    for _ in range(n * n):
        cy, cx = f.tightest_cluster()
        f.set(cy, cx, False)
        vy, vx = f.largest_void()
        f.set(vy, vx, True)
        if (vy, vx) == (cy, cx):
            break
    return f


def generate_bluenoise_ranks(n: int = 64, seed: int = 0) -> np.ndarray:
    """(n, n) int32 rank matrix; rank order is blue-noise distributed."""
    rng = np.random.RandomState(seed)
    proto = _prototype(n, rng)
    ones = int(proto.pattern.sum())
    ranks = np.zeros((n, n), np.int32)

    # phase I: unrank the initial minority pixels (remove tightest first)
    f = _Field(n)
    f.pattern = proto.pattern.copy()
    f.energy = proto.energy.copy()
    for rank in range(ones - 1, -1, -1):
        y, x = f.tightest_cluster()
        f.set(y, x, False)
        ranks[y, x] = rank

    # phase II+III: grow from the prototype, filling the largest void
    f = _Field(n)
    f.pattern = proto.pattern.copy()
    f.energy = proto.energy.copy()
    for rank in range(ones, n * n):
        y, x = f.largest_void()
        f.set(y, x, True)
        ranks[y, x] = rank
    return ranks


def bluenoise_texture(n: int = 64, seed: int = 0) -> np.ndarray:
    """(n, n) float32 in [0, 1): blue-noise-ordered uniform values."""

    def build():
        ranks = generate_bluenoise_ranks(n, seed)
        return ((ranks.astype(np.float64) + 0.5) / (n * n)).astype(np.float32)

    return cache.load_or_build(cache.table_path(f"bluenoise_{n}_{seed}", ("bluenoise.py",)),
                               build)
