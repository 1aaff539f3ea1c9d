"""Carry a scene compiled by the JAX package across to the port.

The renderer's "weights" are its compiled scene tables. `convert_tables`
takes luisarender_tpu's `CompiledScene.arrays` as numpy (a nested dict, as
`jax.device_get` returns it) and produces the port's tables; `convert` puts
them on a device as a CompiledScene the port's integrators render. Only the
keys the port reads are used: trace.{tri_v0, tri_e1, tri_e2, prim_index,
tri_opaque, shade_table, sph, the binary SAH tree (aabb_min, aabb_max,
skip, node_first, node_count), cluster_nodes, cluster_tris and the 8-wide
tables (cluster_woop, cluster_slab8, cluster_meta8, cluster_cboxes)}, instances.*,
light_entries.*, the light alias tables and light-triangle rows, the
surface / light / texture rows with their textures, the image atlas
(texture_atlas, its rects and mip table), the environment's tables, and
the fused tables. A two-level scene's `trace2` comes across
whole (TLAS, BLASes, instance and shade rows, the per-mesh cluster tables
`cl_nodes_{m}` / `cl_tris_{m}`); the plan's statics that route its
composed trace are read back from its instance rows (`_two_level_plan`).

Both packages keep triangles in the order of the same SAH tree, and the
cluster tables carry each triangle's slot in it, so a converted scene's
tables are the port compiler's own and its hit slots the reference's.
The reference's per-instance constant-texture columns (`<name>__src`,
rows of textures.constant.value) are hoisted into values here, as the
port's own compiler does; a parameter whose texture varies keeps its
handle as `<name>__h` (textures/base.py). Handles index the texture types
in the reference's order, which the plan takes over. Under a spectrum that
is not fixed, the colour parameters get their fitted coefficients from the
function the compiler uses (scene/compiler.py hoist_spectral_coeffs).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.device import resolve_device
from .ops import subpacket
from .scene.compiler import (
    INT_INSTANCE_KEYS, CompiledScene, ScenePlan, hoist_spectral_coeffs, tables_to_device,
)
from .scene.node import SceneNodeTag
from .scene.registry import lookup

TRACE_KEYS = ("tri_v0", "tri_e1", "tri_e2", "prim_index", "tri_opaque", "shade_table",
              "sph", "aabb_min", "aabb_max", "skip", "node_first", "node_count",
              "cluster_nodes", "cluster_tris", "cluster_woop", "cluster_slab8",
              "cluster_meta8", "cluster_cboxes")
ATLAS_KEYS = ("texture_atlas", "texture_atlas_rects", "texture_atlas_mips")
# wrapper-feature textures the port does not support
_UNSUPPORTED_TEXTURES = ("normal_map", "alpha")


def _hoist(table, const, name, default, channels):
    """(hoisted values, handle column or None) of one texture parameter."""
    src = np.asarray(table[name + "__src"])
    handles = table.get(name)
    dflt = np.broadcast_to(np.asarray(default, np.float32), (src.shape[0], 4))
    if const is None:
        vals = dflt
    else:
        picked = const[np.clip(src, 0, const.shape[0] - 1)]
        vals = np.where((src >= 0)[:, None], picked, dflt)
    vals = np.ascontiguousarray(vals[:, :channels], np.float32)
    h = None
    if handles is not None:
        h = np.where(src >= 0, -1, np.asarray(handles)).astype(np.int32)
        if np.all(h < 0):
            h = None
    return (vals[:, 0] if channels == 1 else vals), h


def _convert_rows(table, cls, const):
    for name in _UNSUPPORTED_TEXTURES:
        if np.any(np.asarray(table.get(name + "__src", -1)) >= 0) or np.any(
            np.asarray(table.get(name, -1)) >= 0
        ):
            raise NotImplementedError(
                f"the '{name}' texture is not supported by luisarender_tpu_torch yet"
            )
    tex_names = {name for name, _, _ in cls.texture_params}
    tex_names.update(_UNSUPPORTED_TEXTURES)
    out = {
        k: np.asarray(v)
        for k, v in table.items()
        if not k.endswith("__src") and k not in tex_names
    }
    for name, default, channels in cls.texture_params:
        out[name], h = _hoist(table, const, name, default, channels)
        if h is not None:
            out[name + "__h"] = h
    return out


def _two_level_plan(t2):
    """The plan's two-level statics and the flattened triangle count of a
    reference `trace2`: an instance's mesh is the rank of its BLAS node
    offset (column 24) among the meshes', whose offsets ascend in mesh
    order; opacity and visibility are columns 26 and 27; a mesh's
    triangles are its cluster tables' valid rows."""
    rows = np.asarray(t2["inst_rows"], np.float32)
    offsets = sorted({int(r) for r in rows[:, 24]})
    inst_mesh = tuple(offsets.index(int(r)) for r in rows[:, 24])
    n_mesh = sum(1 for k in t2 if k.startswith("cl_nodes_"))
    if len(offsets) != n_mesh:
        raise ValueError(f"{len(offsets)} BLAS offsets for {n_mesh} cluster table sets")
    mesh_tris = [int((np.asarray(t2[f"cl_tris_{m}"])[:, 9, :] > 0.0).sum())
                 for m in range(n_mesh)]
    statics = {"two_level": True, "tl_inst_mesh": inst_mesh,
               "tl_inst_opaque": tuple(bool(v > 0.0) for v in rows[:, 26]),
               "tl_inst_visible": tuple(bool(v > 0.0) for v in rows[:, 27]),
               "tl_mesh_count": n_mesh}
    return statics, sum(mesh_tris[m] for m in inst_mesh)


def _numpy_tree(x):
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    return np.asarray(x)


def convert_tables(arrays, surface_types, light_types, bvh_leaf_size=4,
                   texture_types=None, env_distance=0.0):
    """numpy reference tables -> (the port's numpy tables, ScenePlan).

    surface_types / light_types / texture_types: impl names in the
    reference plan's tag order (`[c.impl_names[0] for c in
    plan.surface_types]`; the texture tables' own order, which is the
    plan's, when texture_types is None); bvh_leaf_size, env_distance: the
    reference plan's."""
    if texture_types is None:
        texture_types = list(arrays.get("textures", {}))
    surf_cls = tuple(lookup(SceneNodeTag.SURFACE, n) for n in surface_types)
    light_cls = tuple(lookup(SceneNodeTag.LIGHT, n) for n in light_types)
    tex_cls = tuple(lookup(SceneNodeTag.TEXTURE, n) for n in texture_types)
    ref_tex = arrays.get("textures", {})
    const = arrays.get("textures", {}).get("constant", {}).get("value")
    if const is not None:
        const = np.asarray(const, np.float32)
    tr = arrays["trace"]
    trace = {
        k: np.asarray(tr[k])
        for k in TRACE_KEYS if k in tr
    }
    out = {
        "instances": {
            k: np.asarray(arrays["instances"][k], np.int32) for k in INT_INSTANCE_KEYS
        },
        "light_entries": {
            k: np.asarray(v) for k, v in arrays["light_entries"].items()
        },
        "light_alias_prob": np.asarray(arrays["light_alias_prob"], np.float32),
        "light_alias_alias": np.asarray(arrays["light_alias_alias"], np.int32),
        "light_tri_rows": np.asarray(arrays["light_tri_rows"], np.float32),
        "surfaces": [
            _convert_rows(t, c, const) for t, c in zip(arrays["surfaces"], surf_cls)
        ],
        "lights": [_convert_rows(t, c, const) for t, c in zip(arrays["lights"], light_cls)],
        **{k: np.asarray(arrays[k]) for k in ATLAS_KEYS},
        "textures": {
            c.impl_names[0]: _convert_rows(ref_tex[c.impl_names[0]], c, const)
            for c in tex_cls if len(ref_tex.get(c.impl_names[0], {}))
        },
        "trace": trace,
    }
    if "environment" in arrays:
        out["environment"] = _numpy_tree(arrays["environment"])
    if "fused" in arrays:
        out["fused"] = {k: np.asarray(v, np.float32) for k, v in arrays["fused"].items()}
    statics, num_tris = {}, int(np.sum(trace["prim_index"] >= 0)) if trace else 0
    if "trace2" in arrays:
        out["trace2"] = {k: np.asarray(v) for k, v in arrays["trace2"].items()}
        statics, num_tris = _two_level_plan(out["trace2"])
    plan = ScenePlan(
        surface_types=surf_cls,
        light_types=light_cls,
        num_lights=int(out["light_entries"]["inst"].shape[0]),
        num_tris=num_tris,
        num_spheres=int(trace["sph"].shape[0]) if "sph" in trace else 0,
        fused_path="fused" in out,
        bvh_leaf_size=int(bvh_leaf_size),
        bvh8_stack=(subpacket.stack8_need(trace["cluster_meta8"])
                    if "cluster_meta8" in trace else 0),
        texture_types=tex_cls,
        texture_type_used=tuple(c.impl_names[0] in out["textures"] for c in tex_cls),
        has_environment="environment" in out,
        env_distance=float(env_distance) if "environment" in out else 0.0,
        needs_uv=any(c.impl_names[0] in out["textures"] and c.impl_names[0] != "constant"
                     for c in tex_cls),
        needs_footprint=any(c.impl_names[0] in out["textures"] and c.reads_footprint
                            for c in tex_cls),
        **statics,
    )
    return out, plan


def convert(arrays, surface_types, light_types, scene, device=None,
            bvh_leaf_size=4, texture_types=None, env_distance=0.0) -> CompiledScene:
    """The reference's compiled tables as a port CompiledScene on `device`
    (default: the first CUDA card); `scene` is the port's Scene of the same
    file, whose cameras, integrator and environment render it. The
    environment node compiles its host state (a spherical map's constant
    flag) and renders from the reference's tables."""
    dev = resolve_device(device)
    spectrum = scene.spectrum.model()
    tables, plan = convert_tables(arrays, surface_types, light_types, bvh_leaf_size,
                                  texture_types, env_distance)
    plan = dataclasses.replace(plan, spectral_dim=spectrum.dimension)
    if plan.has_environment:
        scene.environment.compile(None)
    return CompiledScene(
        arrays=hoist_spectral_coeffs(tables_to_device(tables, dev), plan, spectrum),
        plan=plan,
        scene=scene,
        spectrum=spectrum,
        device=dev,
    )
