"""Directional, combined and null environments.

Counterpart of luisarender_tpu/environments/impls.py: directional is
emission in a cone around a direction (normalized by default, scale =
2 scale / (1 - cos(half angle))); combined is a weighted mixture of child
environments; null is no environment (the compiler marks the scene as
having none).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..core import frame as fr
from ..core import sampling
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from .base import Environment


@register(SceneNodeTag.ENVIRONMENT, "null", "Null")
class NullEnvironment(Environment):
    @property
    def is_null(self):
        return True

    def compile(self, compiler):
        pass


@register(SceneNodeTag.ENVIRONMENT, "directional", "Directional")
class DirectionalEnvironment(Environment):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        emission = desc.node("emission")
        if emission is None:
            raise ValueError("directional environment requires 'emission'")
        self.emission = scene.load_texture(emission)
        angle = min(max(desc.float("angle", 1.0), 1e-3), 360.0)
        self.cos_half_angle = float(np.cos(np.deg2rad(angle * 0.5)))
        self.direction = np.asarray(desc.float3("direction", (0.0, 1.0, 0.0)), np.float64)
        self.direction /= max(np.linalg.norm(self.direction), 1e-12)
        if desc.bool("normalize", True):
            self.scale = float(2.0 * self.scale / max(1.0 - self.cos_half_angle, 1e-6))
        self.visible = desc.bool("visible", True)

    def compile(self, compiler):
        v = self.emission.evaluate_static()
        self._rgb = np.asarray(v[:3], np.float32) if v is not None else np.ones(3, np.float32)
        d = self.rotation() @ np.asarray(self.direction, np.float32)
        self._dir_world = d / max(np.linalg.norm(d), 1e-12)

    def device_arrays(self):
        return {
            "direction": np.asarray(self._dir_world, np.float32),
            "rgb": np.asarray(self._rgb * self.scale, np.float32),
            "cos_half_angle": np.float32(self.cos_half_angle),
        }

    def evaluate(self, ctx, wi_world, swl):
        env = ctx.arrays["environment"]
        cos_t = fr.dot(wi_world, env["direction"])
        inside = cos_t >= env["cos_half_angle"]
        pdf_cone = sampling.uniform_cone_pdf(env["cos_half_angle"])
        mask = inside & self.visible
        rgb = torch.where(mask[..., None], env["rgb"], 0.0)
        L = ctx.spectrum.decode_illuminant(rgb, swl)
        return {"L": L, "pdf": torch.where(inside, pdf_cone, 0.0)}

    def sample(self, ctx, p, u, swl):
        env = ctx.arrays["environment"]
        n = p.shape[0]
        local = sampling.sample_uniform_cone(u, env["cos_half_angle"])
        frame = fr.make_frame(env["direction"].expand(n, 3))
        wi = fr.to_world(frame, local)
        pdf = sampling.uniform_cone_pdf(env["cos_half_angle"]).expand(n)
        rgb = env["rgb"].expand(n, 3)
        return {"wi": wi, "L": ctx.spectrum.decode_illuminant(rgb, swl), "pdf": pdf}


@register(SceneNodeTag.ENVIRONMENT, "combined", "Combined")
class CombinedEnvironment(Environment):
    """Weighted mixture of child environments."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.children = [scene.load_environment(e) for e in desc.node_list("environments")]
        if not self.children:
            raise ValueError("combined environment needs children")
        weights = desc.float_list("weights", [1.0] * len(self.children))
        w = np.asarray(weights[: len(self.children)], np.float64)
        self.weights = (w / w.sum()).astype(np.float32)

    def compile(self, compiler):
        for c in self.children:
            c.compile(compiler)

    def device_arrays(self):
        return {f"child{i}": c.device_arrays() for i, c in enumerate(self.children)}

    def _child_ctx(self, ctx, i):
        sub = copy.copy(ctx)
        sub.arrays = dict(ctx.arrays)
        sub.arrays["environment"] = ctx.arrays["environment"][f"child{i}"]
        return sub

    def evaluate(self, ctx, wi_world, swl):
        L = pdf = None
        for i, (c, w) in enumerate(zip(self.children, self.weights)):
            e = c.evaluate(self._child_ctx(ctx, i), wi_world, swl)
            L = e["L"] * float(w) if L is None else L + e["L"] * float(w)
            pdf = e["pdf"] * float(w) if pdf is None else pdf + e["pdf"] * float(w)
        return {"L": L, "pdf": pdf}

    def sample(self, ctx, p, u, swl):
        # u[..., 0] stratified across the children by their fixed weights
        cum = np.cumsum(self.weights)
        result = None
        u0 = u[..., 0]
        lo = 0.0
        for i, c in enumerate(self.children):
            hi = float(cum[i])
            last = i == len(self.children) - 1
            pick = (u0 >= lo) & ((u0 <= hi) if last else (u0 < hi))
            u_remap = torch.stack(
                [torch.clamp((u0 - lo) / max(hi - lo, 1e-8), 0.0, 1.0 - 2.0 ** -24), u[..., 1]],
                dim=-1,
            )
            s = c.sample(self._child_ctx(ctx, i), p, u_remap, swl)
            if result is None:
                result = dict(s)
            else:
                for k in ("wi", "L"):
                    result[k] = torch.where(pick[..., None], s[k], result[k])
                result["pdf"] = torch.where(pick, s["pdf"], result["pdf"])
            lo = hi
        # the mixture's pdf at the chosen direction, for MIS
        result["pdf"] = self.evaluate(ctx, result["wi"], swl)["pdf"]
        return result
