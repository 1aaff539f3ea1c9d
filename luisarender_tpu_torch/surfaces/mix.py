"""Mix surface: two surfaces blended by a ratio texture.

Counterpart of luisarender_tpu/surfaces/mix.py. The host node compiles to a
generated surface type, one a pair of child classes (cached), whose rows
hold the children's rows inline under the prefixes `a_` and `b_`; mixes
nest. The generated class lists its children's texture and spectral
parameters under the same prefixes, so `dispatch` evaluates every texture
the children read before the closure runs (textures/base.py
evaluate_tex_params), and `ratio` besides.
"""

from __future__ import annotations

import torch

from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..textures.base import compile_tex_param
from .base import Surface

RATIO_PARAM = ("ratio", (0.5,) * 4, 1)

_MONO_CACHE: dict = {}


def type_token(cls) -> str:
    """A surface class as it appears inside a generated type's name: its
    full name for a generated class, its class name otherwise (the
    reference's `mix<MatteSurface,GlassSurface>`)."""
    return cls.impl_names[0] if getattr(cls, "generated", False) else cls.__name__


def prefixed(cls, prefix):
    """A child class's texture and spectral parameters under a prefix."""
    tex = tuple((prefix + name, default, ch) for name, default, ch in cls.texture_params)
    spec = tuple((prefix + name, kind) for name, kind in cls.spectral_params)
    return tex, spec


def split(params, prefix):
    """A child's rows out of its parent's: the prefixed columns, unprefixed."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def monomorphized(cls_a, cls_b):
    """The generated surface type of a mix of cls_a and cls_b."""
    key = (cls_a, cls_b)
    if key in _MONO_CACHE:
        return _MONO_CACHE[key]
    tex_a, spec_a = prefixed(cls_a, "a_")
    tex_b, spec_b = prefixed(cls_b, "b_")

    class MixMono(Surface):
        generated = True
        child_a = cls_a
        child_b = cls_b
        impl_names = (f"mix<{type_token(cls_a)},{type_token(cls_b)}>",)
        texture_params = (RATIO_PARAM,) + tex_a + tex_b
        spectral_params = spec_a + spec_b
        fixed_spectrum_only = cls_a.fixed_spectrum_only or cls_b.fixed_spectrum_only

        @staticmethod
        def _ratio(params):
            return torch.clamp(params["ratio"], 0.0, 1.0)

        @staticmethod
        def _blend(ra, va, vb):
            return ra[..., None] * va + (1.0 - ra)[..., None] * vb

        @staticmethod
        def evaluate(params, ctx, it, swl, wo, wi):
            ra = MixMono._ratio(params)
            ea = cls_a.evaluate(split(params, "a_"), ctx, it, swl, wo, wi)
            eb = cls_b.evaluate(split(params, "b_"), ctx, it, swl, wo, wi)
            return {"f": MixMono._blend(ra, ea["f"], eb["f"]),
                    "pdf": ra * ea["pdf"] + (1.0 - ra) * eb["pdf"]}

        @staticmethod
        def sample(params, ctx, it, swl, wo, u_lobe, u):
            pa, pb = split(params, "a_"), split(params, "b_")
            ra = MixMono._ratio(params)
            pick_a = u_lobe < ra
            u_remap = torch.where(
                pick_a,
                u_lobe / torch.clamp(ra, min=1e-8),
                (u_lobe - ra) / torch.clamp(1.0 - ra, min=1e-8),
            )
            sa = cls_a.sample(pa, ctx, it, swl, wo, u_remap, u)
            sb = cls_b.sample(pb, ctx, it, swl, wo, u_remap, u)
            wi = torch.where(pick_a[..., None], sa["wi"], sb["wi"])
            # both children evaluated at the picked direction, blended
            ea = cls_a.evaluate(pa, ctx, it, swl, wo, wi)
            eb = cls_b.evaluate(pb, ctx, it, swl, wo, wi)
            return {
                "f": MixMono._blend(ra, ea["f"], eb["f"]),
                "pdf": ra * ea["pdf"] + (1.0 - ra) * eb["pdf"],
                "wi": wi,
                "event": torch.where(pick_a, sa["event"], sb["event"]),
                "eta": torch.where(pick_a, sa["eta"], sb["eta"]),
            }

        @staticmethod
        def albedo(params, ctx, it, swl):
            return MixMono._blend(
                MixMono._ratio(params),
                cls_a.albedo(split(params, "a_"), ctx, it, swl),
                cls_b.albedo(split(params, "b_"), ctx, it, swl),
            )

        @staticmethod
        def roughness(params, ctx, it):
            return MixMono._blend(
                MixMono._ratio(params),
                cls_a.roughness(split(params, "a_"), ctx, it),
                cls_b.roughness(split(params, "b_"), ctx, it),
            )

    MixMono.__name__ = f"Mix_{cls_a.__name__}_{cls_b.__name__}"
    _MONO_CACHE[key] = MixMono
    return MixMono


def device_class(node):
    """The surface class a host node compiles to: its generated type where
    it has one (mix, layered), else its own class."""
    return getattr(node, "monomorphized", None) or type(node)


@register(SceneNodeTag.SURFACE, "mix", "Mix")
class MixSurface(Surface):
    """Host node; it compiles through the generated type of its children."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        a, b = desc.node("a"), desc.node("b")
        if a is None or b is None:
            raise ValueError("mix surface requires 'a' and 'b' child surfaces")
        self.a = scene.load_surface(a)
        self.b = scene.load_surface(b)
        self.ratio = scene.load_texture(desc.node("ratio"))

    @property
    def monomorphized(self):
        return monomorphized(device_class(self.a), device_class(self.b))

    def compile(self, compiler) -> dict:
        row_a = self.a.compile(compiler)
        row_b = self.b.compile(compiler)
        row = self.compile_common(compiler)
        row.update({f"a_{k}": v for k, v in row_a.items()})
        row.update({f"b_{k}": v for k, v in row_b.items()})
        compile_tex_param(compiler, self.ratio, RATIO_PARAM[1], row, "ratio", RATIO_PARAM[2])
        return row
