"""Nishita-model physical sky precomputation.

Counterpart of luisarender_tpu/utils/sky_precompute.py, a numpy copy (the
port imports nothing of the reference). Single scattering in a spherical
shell atmosphere, Rayleigh + Mie along the view ray, with the optical
depth towards the sun at each sample, vectorized over the lat-long grid.
"""

from __future__ import annotations

import numpy as np

EARTH_R = 6360e3
ATMOS_R = 6420e3
H_RAYLEIGH = 7994.0
H_MIE = 1200.0
# scattering coefficients at sea level (m^-1), standard published values
BETA_R = np.asarray([5.8e-6, 13.5e-6, 33.1e-6])
BETA_M = np.asarray([21e-6, 21e-6, 21e-6])
MIE_G = 0.76


def _sphere_exit(o_z, d, radius):
    """Distance to the sphere (centered at the planet center) along d from a
    point at height o_z above the surface. o shape (..., 1) z only."""
    # origin = (0, 0, EARTH_R + o_z)
    oz = EARTH_R + o_z
    b = d[..., 2] * oz
    c = oz * oz - radius * radius
    disc = np.maximum(b * b - c, 0.0)
    return np.maximum(-b + np.sqrt(disc), 0.0)


def precompute_sky(
    resolution=(128, 256),
    sun_direction=(0.0, 0.6, 0.8),
    sun_intensity=20.0,
    altitude=100.0,
    n_view=24,
    n_sun=8,
):
    """Returns an (H, W, 3) float32 lat-long radiance map (y-up convention
    matching environments/spherical.py)."""
    h, w = resolution
    sun = np.asarray(sun_direction, np.float64)
    sun = sun / np.linalg.norm(sun)
    # note: y-up world; compute in z-up locally then map (x, z, y)
    sun_z = np.asarray([sun[0], sun[2], sun[1]])

    theta = (np.arange(h) + 0.5) / h * np.pi  # from +y (up)
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    ct = np.cos(theta)[:, None]
    cp = np.cos(phi)[None, :]
    sp = np.sin(phi)[None, :]
    # direction in z-up local frame
    d = np.stack(
        [st * cp, st * sp, np.broadcast_to(ct, (h, w))], axis=-1
    )  # (h, w, 3), z = up

    t_max = _sphere_exit(altitude, d, ATMOS_R)  # (h, w)
    ground = _sphere_exit(altitude, d, EARTH_R)
    hit_ground = (d[..., 2] < 0) & (ground > 0) & (ground < t_max)
    t_max = np.where(hit_ground, ground, t_max)

    mu = np.einsum("hwc,c->hw", d, sun_z)
    phase_r = 3.0 / (16.0 * np.pi) * (1.0 + mu * mu)
    g = MIE_G
    phase_m = (
        3.0
        / (8.0 * np.pi)
        * ((1.0 - g * g) * (1.0 + mu * mu))
        / ((2.0 + g * g) * np.power(1.0 + g * g - 2.0 * g * mu, 1.5))
    )

    seg = t_max / n_view
    sum_r = np.zeros((h, w, 3))
    sum_m = np.zeros((h, w, 3))
    od_view_r = np.zeros((h, w))
    od_view_m = np.zeros((h, w))
    oz0 = EARTH_R + altitude
    for i in range(n_view):
        t = (i + 0.5) * seg
        # sample position height
        px = d[..., 0] * t
        py = d[..., 1] * t
        pz = oz0 + d[..., 2] * t
        height = np.sqrt(px * px + py * py + pz * pz) - EARTH_R
        height = np.maximum(height, 0.0)
        dens_r = np.exp(-height / H_RAYLEIGH) * seg
        dens_m = np.exp(-height / H_MIE) * seg
        od_view_r += dens_r
        od_view_m += dens_m
        # optical depth toward the sun from the sample point
        oz_h = height  # treat sample as at (0,0,R+height) (spherical sym.)
        t_sun = _sphere_exit(oz_h, np.broadcast_to(sun_z, (h, w, 3)), ATMOS_R)
        seg_s = t_sun / n_sun
        od_sun_r = np.zeros((h, w))
        od_sun_m = np.zeros((h, w))
        for j in range(n_sun):
            ts = (j + 0.5) * seg_s
            hz = np.sqrt(
                (sun_z[0] * ts) ** 2
                + (sun_z[1] * ts) ** 2
                + (EARTH_R + oz_h + sun_z[2] * ts) ** 2
            ) - EARTH_R
            hz = np.maximum(hz, 0.0)
            od_sun_r += np.exp(-hz / H_RAYLEIGH) * seg_s
            od_sun_m += np.exp(-hz / H_MIE) * seg_s
        tau = (
            BETA_R[None, None] * (od_view_r + od_sun_r)[..., None]
            + BETA_M[None, None] * 1.1 * (od_view_m + od_sun_m)[..., None]
        )
        attn = np.exp(-tau)
        sum_r += attn * dens_r[..., None]
        sum_m += attn * dens_m[..., None]

    radiance = sun_intensity * (
        sum_r * BETA_R[None, None] * phase_r[..., None]
        + sum_m * BETA_M[None, None] * phase_m[..., None]
    )
    radiance = np.where(hit_ground[..., None], radiance * 0.3, radiance)
    return radiance.astype(np.float32)
