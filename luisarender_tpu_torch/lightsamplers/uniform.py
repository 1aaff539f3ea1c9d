"""Uniform light sampler with the environment as a pseudo-light.

Counterpart of luisarender_tpu/lightsamplers/uniform.py: NEE picks the
environment with probability p_env (`environment_probability`, 0.5 by
default, 1 when the scene has no area light) and otherwise one light-list
entry uniformly; every pdf includes its selection probability, so MIS
against BSDF sampling sees the same densities.
"""

from __future__ import annotations

import torch

from ..core import frame as fr
from ..lights import base as light_base
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..scene.scene import SceneNode


@register(SceneNodeTag.LIGHT_SAMPLER, "uniform", "Uniform")
class UniformLightSampler(SceneNode):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.env_prob = desc.float("environment_probability", 0.5)

    def selection_probs(self, ctx):
        """(p_env, p_light): the environment's share, and one entry's."""
        n_lights = ctx.plan.num_lights
        has_env = ctx.plan.has_environment
        if has_env and n_lights > 0:
            p_env = min(max(self.env_prob, 0.0), 1.0)
        elif has_env:
            p_env = 1.0
        else:
            p_env = 0.0
        return p_env, (1.0 - p_env) / max(n_lights, 1)

    def sample(self, ctx, it, u_sel, u_surface, swl):
        """NEE sample towards a light or the environment: L, pdf (solid
        angle, including the selection probability), p (target point), ng
        (its normal), wi."""
        p_env, p_light = self.selection_probs(ctx)
        n_lights = ctx.plan.num_lights
        n = it.p.shape[0]
        result = {
            "L": it.p.new_zeros((n, ctx.plan.spectral_dim)),
            "pdf": it.p.new_zeros((n,)),
            "p": it.p,
            "ng": it.ng,
            "wi": it.ng,
        }
        if n_lights > 0:
            # u in [p_env, 1) maps uniformly onto the light entries
            u_rel = torch.clamp((u_sel - p_env) / max(1.0 - p_env, 1e-8), 0.0, 1.0 - 2.0 ** -24)
            entry = torch.clamp((u_rel * n_lights).to(torch.int32), 0, n_lights - 1)
            s = light_base.dispatch_sample(ctx, entry, it.p, u_surface, swl)
            pick = u_sel >= p_env
            wi = s["p"] - it.p
            wi = wi / torch.clamp(torch.sqrt(fr.dot(wi, wi)), min=1e-12)[..., None]
            m = pick[..., None]
            result = {
                "L": torch.where(m, s["L"], result["L"]),
                "pdf": torch.where(pick, s["pdf"] * p_light, result["pdf"]),
                "p": torch.where(m, s["p"], result["p"]),
                "ng": torch.where(m, s["ng"], result["ng"]),
                "wi": torch.where(m, wi, result["wi"]),
            }
        if ctx.plan.has_environment:
            env = ctx.scene.environment.sample(ctx, it.p, u_surface, swl)
            pick = u_sel < p_env
            m = pick[..., None]
            far = it.p + env["wi"] * ctx.plan.env_distance
            result = {
                "L": torch.where(m, env["L"], result["L"]),
                "pdf": torch.where(pick, env["pdf"] * p_env, result["pdf"]),
                "p": torch.where(m, far, result["p"]),
                "ng": torch.where(m, -env["wi"], result["ng"]),
                "wi": torch.where(m, env["wi"], result["wi"]),
            }
        return result

    def evaluate_hit(self, ctx, it_light, p_from, swl):
        """Radiance and MIS pdf when a path ray hits an emissive instance."""
        _, p_light = self.selection_probs(ctx)
        ev = light_base.dispatch_evaluate(ctx, it_light, p_from, swl)
        return {"L": ev["L"], "pdf": ev["pdf"] * p_light}

    def evaluate_miss(self, ctx, direction, swl):
        """The environment's radiance and MIS pdf for escaped rays."""
        p_env, _ = self.selection_probs(ctx)
        ev = ctx.scene.environment.evaluate(ctx, direction, swl)
        return {"L": ev["L"], "pdf": ev["pdf"] * p_env}
