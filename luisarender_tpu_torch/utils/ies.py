"""IES photometric profile parser (IESNA LM-63).

Counterpart of luisarender_tpu/utils/ies.py (LuisaRender's src/util/ies.cpp,
a standalone parser that no other component uses), host numpy. Parses the
candela grid of an LM-63 file and exposes interpolated intensity lookup plus
rasterization to a lat-long map usable as a light/projection texture.
"""

from __future__ import annotations

import numpy as np


class IESProfile:
    def __init__(self, v_angles, h_angles, candela):
        self.v_angles = np.asarray(v_angles, np.float64)  # (V,) degrees
        self.h_angles = np.asarray(h_angles, np.float64)  # (H,) degrees
        self.candela = np.asarray(candela, np.float64)  # (H, V)

    @classmethod
    def parse(cls, path) -> "IESProfile":
        with open(path, "r", errors="replace") as f:
            text = f.read()
        lines = text.splitlines()
        # skip keyword block until TILT line
        i = 0
        while i < len(lines) and not lines[i].upper().startswith("TILT"):
            i += 1
        if i == len(lines):
            raise ValueError(f"{path}: missing TILT line (not an LM-63 file)")
        tilt = lines[i].split("=", 1)[-1].strip().upper()
        i += 1
        if tilt == "INCLUDE":
            # skip tilt data: lamp-to-luminaire, #pairs, angles, factors
            nums = []
            while len(nums) < 2:
                nums += lines[i].split()
                i += 1
            n_pairs = int(float(nums[1]))
            need = 2 + 2 * n_pairs
            while len(nums) < need:
                nums += lines[i].split()
                i += 1
        # the rest is one whitespace-separated number stream
        stream = " ".join(lines[i:]).split()
        vals = [float(x) for x in stream]
        (
            n_lamps, lumens, multiplier, n_v, n_h,
            photometric_type, units, width, length, height,
        ) = vals[:10]
        ballast, future, watts = vals[10:13]
        n_v, n_h = int(n_v), int(n_h)
        pos = 13
        v_angles = vals[pos : pos + n_v]
        pos += n_v
        h_angles = vals[pos : pos + n_h]
        pos += n_h
        candela = np.asarray(vals[pos : pos + n_v * n_h]).reshape(n_h, n_v)
        candela = candela * multiplier
        return cls(v_angles, h_angles, candela)

    def intensity(self, theta_deg, phi_deg):
        """Bilinear lookup; theta from nadir (0) to zenith (180), phi
        azimuthal, with standard LM-63 symmetry handling."""
        theta = np.clip(np.asarray(theta_deg, np.float64), 0.0, 180.0)
        phi = np.asarray(phi_deg, np.float64) % 360.0
        h_max = self.h_angles[-1] if len(self.h_angles) > 1 else 0.0
        if h_max == 0.0:
            phi_w = np.zeros_like(phi)
        elif h_max <= 90.0:  # quadrant symmetry
            phi_w = np.abs(((phi + 90.0) % 180.0) - 90.0)
        elif h_max <= 180.0:  # bilateral symmetry
            phi_w = np.abs(((phi + 180.0) % 360.0) - 180.0)
        else:
            phi_w = phi

        vi = np.interp(theta, self.v_angles, np.arange(len(self.v_angles)))
        hi = (
            np.interp(phi_w, self.h_angles, np.arange(len(self.h_angles)))
            if len(self.h_angles) > 1
            else np.zeros_like(phi_w)
        )
        v0 = np.clip(np.floor(vi).astype(int), 0, len(self.v_angles) - 1)
        v1 = np.clip(v0 + 1, 0, len(self.v_angles) - 1)
        h0 = np.clip(np.floor(hi).astype(int), 0, len(self.h_angles) - 1)
        h1 = np.clip(h0 + 1, 0, len(self.h_angles) - 1)
        fv = vi - v0
        fh = hi - h0
        c = self.candela
        return (
            c[h0, v0] * (1 - fh) * (1 - fv)
            + c[h1, v0] * fh * (1 - fv)
            + c[h0, v1] * (1 - fh) * fv
            + c[h1, v1] * fh * fv
        )

    def rasterize(self, resolution=(64, 128)) -> np.ndarray:
        """(H, W) lat-long intensity map (theta from +y up, matching
        environments/spherical.py) normalized to peak 1."""
        h, w = resolution
        theta = (np.arange(h) + 0.5) / h * 180.0
        phi = (np.arange(w) + 0.5) / w * 360.0
        img = self.intensity(
            180.0 - theta[:, None], np.broadcast_to(phi[None, :], (h, w))
        )
        peak = img.max()
        return (img / peak if peak > 0 else img).astype(np.float32)
