"""Sobol direction numbers generated from first principles.

Counterpart of luisarender_tpu/core/sobolgen.py, a copy of its host numpy
arithmetic: dimension j of the sequence takes the j-th primitive
polynomial over GF(2) (enumerated by degree; p of degree d is primitive
iff x has multiplicative order 2^d - 1 modulo p) and odd initial
direction numbers m_i < 2^i. The m_i come from a Joe-Kuo-style search:
per dimension, seeded candidate draws are scored by the dyadic
stratification error of the 2D projections against the two preceding
dimensions over the first 256 points, and the best wins. The search runs
dimension after dimension on one random stream, so the first D rows of a
larger table are the D-dimension table.

The (D, 32) table is built at first use and cached (core/cache.py): the
1,024-dimension search takes tens of seconds on one CPU core.
"""

from __future__ import annotations

import numpy as np

from . import cache as table_cache


def _poly_mulmod(a: int, b: int, p: int, d: int) -> int:
    """(a * b) mod p over GF(2); p has degree d."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> d & 1:
            a ^= p
    return r


def _poly_powmod(a: int, e: int, p: int, d: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _poly_mulmod(r, a, p, d)
        a = _poly_mulmod(a, a, p, d)
        e >>= 1
    return r


def _prime_factors(n: int) -> list:
    out = []
    f = 2
    while f * f <= n:
        if n % f == 0:
            out.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        out.append(n)
    return out


def _is_primitive(p: int, d: int) -> bool:
    """p: polynomial bits (degree d, bit d set). Primitive iff ord(x) = 2^d-1."""
    m = (1 << d) - 1
    if _poly_powmod(2, m, p, d) != 1:  # x^m must be 1
        return False
    for q in _prime_factors(m):
        if _poly_powmod(2, m // q, p, d) == 1:
            return False
    return True


def primitive_polynomials(count: int) -> list:
    """First `count` primitive polynomials over GF(2) ordered by degree.
    Returned as (degree, coefficient bits a_1..a_{d-1}) pairs — the Sobol
    recurrence form (constant and leading terms are implicitly 1)."""
    out = []
    d = 1
    while len(out) < count:
        # candidates: x^d + (middle bits) + 1 -> bits = 2^d | mid<<1 | 1
        for mid in range(1 << max(d - 1, 0)):
            p = (1 << d) | (mid << 1) | 1
            if d == 1:
                p = 0b11  # x + 1
                if mid > 0:
                    break
            if _is_primitive(p, d):
                out.append((d, mid))
                if len(out) >= count:
                    break
        d += 1
    return out


def _direction_vectors(d: int, a: int, m: np.ndarray) -> np.ndarray:
    """Expand initial direction numbers m[1..d] with the Sobol recurrence
    for polynomial (degree d, middle bits a) into 32 MSB-aligned v's."""
    vs = np.zeros(33, np.uint64)
    for i in range(1, min(d, 32) + 1):
        vs[i] = np.uint64(m[i]) << np.uint64(32 - i)
    for i in range(d + 1, 33):
        val = vs[i - d] ^ (vs[i - d] >> np.uint64(d))
        for k in range(1, d):
            if (a >> (d - 1 - k)) & 1:
                val ^= vs[i - k]
        vs[i] = val
    return vs[1:33]


def _sobol_points(v: np.ndarray, n: int) -> np.ndarray:
    """First n Sobol values (uint32) of one dimension from its 32 v's."""
    idx = np.arange(n, dtype=np.uint32)
    bits = (idx[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    masked = np.where(bits.astype(bool), v[None, :].astype(np.uint32), 0)
    return np.bitwise_xor.reduce(masked, axis=1)


def pair_strat_error(u: np.ndarray, w: np.ndarray, log2n: int) -> float:
    """Dyadic 2D stratification error of the projection (u, w) over the
    first 2^log2n points: for every split r1+r2 = log2n, the 2^log2n
    elementary cells should hold exactly one point ((0,2)-net in base 2);
    returns the summed squared excess. 0 = perfect (e.g. dims 0,1)."""
    n = 1 << log2n
    u = u[:n]
    w = w[:n]
    err = 0.0
    for r1 in range(log2n + 1):
        r2 = log2n - r1
        cu = (u >> np.uint32(32 - r1)) if r1 else np.zeros_like(u)
        cw = (w >> np.uint32(32 - r2)) if r2 else np.zeros_like(w)
        cells = cu.astype(np.int64) << r2 | cw.astype(np.int64)
        counts = np.bincount(cells, minlength=n)
        err += float(((counts - 1) ** 2).sum())
    return err


def _random_m(rs, d: int) -> np.ndarray:
    m = np.zeros(d + 1, np.uint64)
    m[1] = 1  # the only odd value < 2
    for i in range(2, d + 1):
        m[i] = 2 * rs.randint(0, 1 << (i - 1)) + 1
    return m


_CANDIDATES = 64  # seeded draws scored a dimension


def sobol_matrices(n_dims: int = 1024, seed: int = 20180813, cache: bool = True) -> np.ndarray:
    """(n_dims, 32) uint32 direction vectors v_{j,i} (MSB-aligned), from
    the Joe-Kuo-style search. Dimension 0 is the van der Corput sequence
    (identity matrix). cache=False builds without reading or writing the
    cache."""
    if not cache:
        return _build(n_dims, seed)
    path = table_cache.table_path(f"sobol_matrices_{n_dims}_{seed}_jk{_CANDIDATES}",
                                  ("sobolgen.py",))
    table = table_cache.load_or_build(path, lambda: _build(n_dims, seed))
    if table.shape != (n_dims, 32) or table.dtype != np.uint32:
        raise RuntimeError(f"{path}: a table of shape {table.shape}, {table.dtype}, "
                           f"not ({n_dims}, 32) uint32")
    return table


def _build(n_dims, seed):
    rs = np.random.RandomState(seed)
    v = np.zeros((n_dims, 32), np.uint64)
    v[0] = 1 << (31 - np.arange(32))  # van der Corput
    polys = primitive_polynomials(n_dims - 1)
    log2n = 8  # score the first 256 points — the low-spp regime that matters
    pts_prev1 = _sobol_points(v[0], 1 << log2n)
    pts_prev2 = None
    for j, (d, a) in enumerate(polys, start=1):
        best = None
        best_err = np.inf
        # d=1 has no free initial bits (m_1 = 1 always): single candidate
        n_cand = _CANDIDATES if d > 1 else 1
        for _ in range(n_cand):
            m = _random_m(rs, d)
            cand = _direction_vectors(d, a, m)
            pts = _sobol_points(cand, 1 << log2n)
            err = pair_strat_error(pts_prev1, pts, log2n)
            if pts_prev2 is not None:
                err += 0.5 * pair_strat_error(pts_prev2, pts, log2n)
            if err < best_err:
                best_err = err
                best = (cand, pts)
        v[j] = best[0]
        pts_prev2 = pts_prev1
        pts_prev1 = best[1]
    return v.astype(np.uint32)
