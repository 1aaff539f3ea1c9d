"""Texture interface, parameter hoisting and the batched texture evaluator.

Counterpart of luisarender_tpu/textures/base.py. A texture node compiles
to an integer handle (type tag in the high bits, row index in the low bits)
and a row in its type's parameter table (scene/compiler.py
register_texture_row). A texture-valued parameter of a surface, a light or
a texture keeps two entries in its owner's row:

  <name>      the hoisted value: a constant texture's value, or the
              parameter's default where it has no texture or a texture
              that varies (the reference hoists the same constants into
              its rows once per pass, `_hoist_constants`);
  <name>__h   the handle of a texture that is not a constant, else -1.

The compiler also takes the parameter's `<name>__src` entry (the constant
texture's row in `textures.constant.value`, else -1) out of the rows into
the scene's hoisting sources (scene/compiler.py split_sources), so that the
differentiable pass hoists the values anew from the constant table
(`hoist_constants`), as the reference does at every pass.

The compiler drops a type's `__h` column when no row has a varying texture,
so a scene of constants runs no texture evaluation at all. Where a handle
survives, `evaluate_param` evaluates it at the hit (`evaluate_handles`: every
texture type present runs on every lane and its tag selects, nested
textures up to MAX_NEST levels, as in the reference) and keeps the hoisted
value elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.scene import SceneNode

HANDLE_TYPE_SHIFT = 24
HANDLE_INDEX_MASK = (1 << HANDLE_TYPE_SHIFT) - 1
NULL_HANDLE = -1
# nesting levels the evaluator unrolls: combinators (checkerboard, scale,
# swizzle) recurse with depth + 1; past this depth their lanes read defaults
MAX_NEST = 3


def make_handle(type_id: int, index: int) -> int:
    return (type_id << HANDLE_TYPE_SHIFT) | index


class Texture(SceneNode):
    """Host-side texture node."""

    nests = False  # a combinator that evaluates child textures
    reads_footprint = False  # reads Interaction.footprint (image LOD)

    @property
    def channels(self) -> int:
        return 4

    def compile(self, compiler) -> int:
        """Register this texture's row with the compiler; returns its handle."""
        raise NotImplementedError

    def evaluate_static(self):
        """Constant-folded host value (4,), or None for a varying texture."""
        return None


def compile_tex_param(compiler, tex, default, row, name, channels=4):
    """Fill row[name] (the hoisted value, its first `channels` channels, a
    scalar for channels=1), row[name + '__h'] (the handle of a texture
    that is not a constant, else -1) and row[name + '__src'] (a constant
    texture's row in its table, else -1) for one texture-valued parameter.
    Every texture registers its row, constants included, so that handles
    number the texture types as the reference's do."""
    from .constant import ConstantTexture

    handle = NULL_HANDLE if tex is None else int(compiler.compile_texture(tex))
    const = isinstance(tex, ConstantTexture)
    value = tex.value if const else np.asarray(default, np.float32)
    value = np.asarray(value[:channels], np.float32)
    row[name] = value[0] if channels == 1 else value
    row[name + "__h"] = np.int32(NULL_HANDLE if const else handle)
    row[name + "__src"] = np.int32(handle & HANDLE_INDEX_MASK if const else -1)


def compile_tex_params(node, compiler) -> dict:
    """Row entries for every texture parameter a plugin class declares in
    `texture_params`: (name, default rgba, channels), the texture being the
    node's attribute of that name."""
    row = {}
    for name, default, channels in type(node).texture_params:
        compile_tex_param(compiler, getattr(node, name), default, row, name, channels)
    return row


def gather_rows(table, index):
    """Per-lane rows of a parameter table (a dict of columns), the index
    clamped into the table."""
    return {k: v[torch.clamp(index, 0, v.shape[0] - 1).long()] for k, v in table.items()}


def evaluate_handles(ctx, handles, it, default=(0.0, 0.0, 0.0, 0.0), depth=0):
    """Per-lane texture handles (N,) int32 -> rgba (N, 4) float32; lanes
    without a handle get `default`. ctx: the CompiledScene; it: the
    Interaction the textures are evaluated at."""
    n = handles.shape[0]
    result = torch.tensor(default, dtype=torch.float32, device=handles.device).expand(n, 4)
    type_tag = handles >> HANDLE_TYPE_SHIFT
    index = handles & HANDLE_INDEX_MASK
    for type_id, cls in enumerate(ctx.plan.texture_types):
        if not ctx.plan.texture_type_used[type_id]:
            continue
        if cls.nests:
            if depth >= MAX_NEST:
                continue
            value = cls.evaluate_rows(ctx, index, it, depth=depth)
        else:
            value = cls.evaluate_rows(ctx, index, it)
        mask = (handles >= 0) & (type_tag == type_id)
        result = torch.where(mask[..., None], value, result)
    return result


def evaluate_param(ctx, rows, name, it, default=(0.0, 0.0, 0.0, 0.0), depth=0):
    """A texture parameter of per-lane rows -> its value, in the hoisted
    column's shape: the hoisted value, or the texture evaluated at `it`
    where the lane's row has a handle."""
    value = rows[name]
    handles = rows.get(name + "__h")
    if handles is None:
        return value
    rgba = evaluate_handles(ctx, handles, it, default=default, depth=depth)
    dyn = rgba[..., 0] if value.dim() == 1 else rgba[..., : value.shape[-1]]
    mask = handles >= 0
    return torch.where(mask if value.dim() == 1 else mask[..., None], dyn, value)


def evaluate_tex_params(ctx, rows, it, texture_params):
    """rows with every texture parameter of a plugin class evaluated at
    `it` (rows without surviving handles come back unchanged). The handle
    columns stay: spectral_param reads them to tell evaluated lanes from
    hoisted ones."""
    if not any(name + "__h" in rows for name, _, _ in texture_params):
        return rows
    out = dict(rows)
    for name, default, _ in texture_params:
        if name + "__h" in rows:
            out[name] = evaluate_param(ctx, rows, name, it, default=default)
    return out


# a spectral parameter's kinds of decode, and its coefficient columns
COEFF_SUFFIX = {"albedo": "__ca", "unbounded": "__cu", "illuminant": "__ci"}


def spectral_param(ctx, rows, name, swl, kind="albedo"):
    """A colour parameter of per-lane rows (its textures evaluated,
    evaluate_tex_params) -> a spectral sample (N, C) at swl.

    kind: "albedo", "unbounded" or "illuminant", the decode that applies.
    Under a spectrum that is not fixed, a row's hoisted value carries its
    fitted coefficients (`<name>__ca`, `__cu` / `__cus`, `__ci` / `__cis`:
    scene/compiler.py hoist_spectral_coeffs), so such a lane only evaluates
    the sigmoid; a lane whose texture varies (its `<name>__h` >= 0)
    decodes its evaluated value through the per-ray table fetch. A fixed
    spectrum decodes the value."""
    spec = ctx.spectrum
    ck = COEFF_SUFFIX[kind]
    if spec.is_fixed or name + ck not in rows:
        return getattr(spec, "decode_" + kind)(rows[name], swl)
    if kind == "albedo":
        out = spec.decode_albedo_coeffs(rows[name + ck], swl)
    else:
        dec = getattr(spec, f"decode_{kind}_coeffs")
        out = dec(rows[name + ck], rows[name + ck + "s"], swl)
    handles = rows.get(name + "__h")
    if handles is None:
        return out
    out_dyn = getattr(spec, "decode_" + kind)(rows[name], swl)
    return torch.where((handles >= 0)[..., None], out_dyn, out)
