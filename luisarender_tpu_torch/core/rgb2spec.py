"""RGB -> reflectance spectrum upsampling (the sigmoid-polynomial model).

Counterpart of luisarender_tpu/core/rgb2spec.py (Jakob & Hanika 2019, "A
Low-Dimensional Function Space for Efficient Spectral Upsampling"):

    S(lambda) = s(c0 x^2 + c1 x + c2),  s(t) = 1/2 + t / (2 sqrt(1 + t^2)),
    x = (lambda - 360) / (830 - 360) in [0, 1]

The coefficients are fitted by damped Gauss-Newton so that S, integrated
against the CIE matching functions under D65, gives the target sRGB
triple:
- `fit_rgb`: the batched fit (numpy float64, the reference's arithmetic);
- `lut(res)`: the (3, res, res, res, 3) coefficient table in RGB2Spec's
  max-channel parameterization, built from this code at first use on the
  host and cached in `luisarender_tpu_torch/_build/` (git-ignored) under a
  name that carries a hash of the modules it is computed from; it is
  written through a temporary name and `os.replace`, so a process never
  loads half a file. A table that cannot be built or loaded raises.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import cache, cie
from .colorspace import SRGB_FROM_XYZ

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
_N_LAMBDA = 95  # 5 nm steps

_lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, _N_LAMBDA)
_x = (_lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)


def _cie_rgb_basis():
    """Rows: weights with rgb = W @ S(lambda grid) for a reflectance under
    D65, normalized so that S == 1 gives rgb == (1, 1, 1)."""
    xyz_bar = np.stack([cie.cie_x(_lam), cie.cie_y(_lam), cie.cie_z(_lam)])  # (3, L)
    w_xyz = xyz_bar * cie.d65(_lam)
    rgb_w = SRGB_FROM_XYZ.astype(np.float64) @ w_xyz  # (3, L)
    white = rgb_w.sum(axis=1)  # rgb of a perfect reflector
    return rgb_w / white[:, None]


_W = _cie_rgb_basis()  # (3, L)


def _sigmoid(t):
    return 0.5 + t / (2.0 * np.sqrt(1.0 + t * t))


def _dsigmoid(t):
    return 0.5 * (1.0 + t * t) ** -1.5


def eval_spectrum(coeffs, lam):
    """coeffs (..., 3), lam (..., C) nm -> reflectance (..., C); numpy or
    torch."""
    x = (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)
    t = coeffs[..., 0:1] * x * x + coeffs[..., 1:2] * x + coeffs[..., 2:3]
    sqrt = np.sqrt if isinstance(lam, np.ndarray) else torch.sqrt
    return 0.5 + t / (2.0 * sqrt(1.0 + t * t))


def fit_rgb(rgb: np.ndarray, iters: int = 40) -> np.ndarray:
    """Batched Gauss-Newton fit: rgb (..., 3) in [0, 1] -> coeffs (..., 3)
    float32."""
    rgb = np.asarray(rgb, np.float64)
    shape = rgb.shape[:-1]
    target = rgb.reshape(-1, 3)
    n = target.shape[0]
    # start from the flat spectrum of the mean
    lum = np.clip(target.mean(axis=1), 1e-4, 1.0 - 1e-4)
    c = np.zeros((n, 3))
    c[:, 2] = np.arctanh(2.0 * lum - 1.0) * 2.0

    basis = np.stack([_x * _x, _x, np.ones_like(_x)], axis=0)  # (3, L)
    lam_damp = np.full(n, 1e-4)
    for _ in range(iters):
        t = c @ basis  # (n, L)
        s = _sigmoid(t)
        resid = s @ _W.T - target  # (n, 3)
        ds = _dsigmoid(t)
        # J[n, rgb, coef] = sum_l W[rgb, l] ds[n, l] basis[coef, l]
        j = np.einsum("rl,nl,kl->nrk", _W, ds, basis)
        jtj = np.einsum("nrk,nrm->nkm", j, j)
        jtr = np.einsum("nrk,nr->nk", j, resid)
        a = jtj + lam_damp[:, None, None] * np.eye(3)
        try:
            delta = np.linalg.solve(a, jtr[..., None])[..., 0]
        except np.linalg.LinAlgError:
            delta = np.zeros_like(jtr)
        c = c - delta
    return c.reshape(shape + (3,)).astype(np.float32)


def fit_rgb_unbounded(rgb: np.ndarray):
    """For values that may exceed 1 (illuminants, unbounded parameters):
    (coeffs, scale) with rgb = scale * decode(coeffs), decode in [0, 1]."""
    rgb = np.asarray(rgb, np.float64)
    m = np.maximum(rgb.max(axis=-1), 1e-8)
    scale = np.where(m > 1.0, m * 2.0, 1.0)
    normalized = rgb / scale[..., None]
    return fit_rgb(np.clip(normalized, 0.0, 1.0)), scale.astype(np.float32)


LUT_RES = 24
_LUT_CACHE: dict = {}


def _lut_path(res: int) -> Path:
    return cache.table_path(f"rgb2spec_{res}", ("rgb2spec.py", "cie.py", "colorspace.py"))


def build_lut(res: int) -> np.ndarray:
    """The (3, res, res, res, 3) table: axis 0 is the argmax channel k; the
    grid is (z, y, x), z the value of channel k and x, y the other two
    channels over z. Inclusive end points, so pure primaries and white lie
    on the grid."""
    grid = np.arange(res) / (res - 1)
    table = np.zeros((3, res, res, res, 3), np.float32)
    for k in range(3):
        z, y, x = np.meshgrid(grid, grid, grid, indexing="ij")
        rgb = np.zeros((res, res, res, 3))
        rgb[..., k] = z
        others = [i for i in range(3) if i != k]
        rgb[..., others[0]] = x * z
        rgb[..., others[1]] = y * z
        table[k] = fit_rgb(rgb, iters=30)
    return table


def lut(res: int = LUT_RES) -> np.ndarray:
    """The coefficient table at `res`, from this process's memory, the
    cache file, or built and cached now."""
    if res in _LUT_CACHE:
        return _LUT_CACHE[res]
    path = _lut_path(res)
    table = cache.load_or_build(path, lambda: build_lut(res))
    if table.shape != (3, res, res, res, 3) or table.dtype != np.float32:
        raise RuntimeError(f"{path}: a coefficient table of shape {table.shape}, "
                           f"{table.dtype}, not (3, {res}, {res}, {res}, 3) float32")
    _LUT_CACHE[res] = table
    return table


def lut_lookup_np(table: np.ndarray, rgb: np.ndarray) -> np.ndarray:
    """Host nearest-cell lookup (for baking image-texture atlases)."""
    res = table.shape[1]
    rgb = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0)
    k = rgb.argmax(axis=-1)
    z = np.take_along_axis(rgb, k[..., None], -1)[..., 0]
    safe_z = np.maximum(z, 1e-8)
    others = np.stack(
        [np.where(k == 0, rgb[..., 1], rgb[..., 0]),
         np.where(k == 2, rgb[..., 1], rgb[..., 2])], -1
    )
    x = others[..., 0] / safe_z
    y = others[..., 1] / safe_z

    def qi(v):
        return np.clip(np.round(v * (res - 1)).astype(np.int32), 0, res - 1)

    return table[k, qi(z), qi(y), qi(x)]
