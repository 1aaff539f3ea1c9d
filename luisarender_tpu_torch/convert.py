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
(texture_atlas, its rects and mip table), the environment's tables, the
media rows with the instances' medium columns and the density grids
(density_grids, density_grid_dims), the world bounds (world_min,
world_max) and the fused tables. A two-level
scene's `trace2` comes across whole (TLAS, BLASes, instance and shade
rows, the per-mesh cluster tables `cl_nodes_{m}` / `cl_tris_{m}`); the
plan's statics that route its composed trace are read back from its
instance rows (`_two_level_plan`).

Both packages keep triangles in the order of the same SAH tree, and the
cluster tables carry each triangle's slot in it, so a converted scene's
tables are the port compiler's own and its hit slots the reference's.
The reference's per-instance constant-texture columns (`<name>__src`,
rows of textures.constant.value) are hoisted into values here, as the
port's own compiler does; a parameter whose texture varies keeps its
handle as `<name>__h` (textures/base.py). Handles index the texture types
in the reference's order, which the plan takes over. Under a spectrum that
is not fixed, the colour parameters get their fitted coefficients from the
function the compiler uses (scene/compiler.py hoist_spectral_coeffs). The
`__src` columns also come across as the scene's hoisting sources
(`hoist_src`), from which the differentiable pass hoists anew. A params
dict of the reference's differentiable pass comes across with
`params_to_device`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.device import resolve_device
from .ops import subpacket
from .scene.compiler import (
    FLOAT_INSTANCE_KEYS, HOIST_GROUPS, INT_INSTANCE_KEYS, CompiledScene, ScenePlan, drop_unused,
    hoist_spectral_coeffs, tables_to_device, to_device,
)
from .scene.node import SceneNodeTag
from .scene.registry import lookup, registered
from .surfaces.base import ALPHA_PARAM, NORMAL_MAP_PARAM

TRACE_KEYS = ("tri_v0", "tri_e1", "tri_e2", "prim_index", "tri_opaque", "shade_table",
              "sph", "aabb_min", "aabb_max", "skip", "node_first", "node_count",
              "cluster_nodes", "cluster_tris", "cluster_woop", "cluster_slab8",
              "cluster_meta8", "cluster_cboxes")
ATLAS_KEYS = ("texture_atlas", "texture_atlas_rects", "texture_atlas_mips")
GRID_KEYS = ("density_grids", "density_grid_dims")


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


def _wrapper_param(name):
    """(default, channels) of a surface's wrapper texture, a child's under
    its prefix included (`a_alpha`, `i_normal_map`), else None."""
    for wname, default, channels in (NORMAL_MAP_PARAM, ALPHA_PARAM):
        if name == wname or name.endswith("_" + wname):
            return default, channels
    return None


def _convert_rows(table, cls, const):
    """A reference parameter table as the port's: the class's texture
    parameters and a surface's wrapper textures (normal map, alpha; their
    `<name>__src` columns) hoisted, the wrapper textures with their
    presence flags `<name>__p`."""
    params = {name: (default, ch) for name, default, ch in cls.texture_params}
    specs = {k[: -len("__src")]: None for k in table if k.endswith("__src")}
    specs = {name: params.get(name) or _wrapper_param(name) for name in specs}
    specs = {name: spec for name, spec in specs.items() if spec is not None}
    out = {k: np.asarray(v) for k, v in table.items()
           if not k.endswith("__src") and k not in specs}
    for name, spec in specs.items():
        out[name], h = _hoist(table, const, name, *spec)
        if h is not None:
            out[name + "__h"] = h
        if _wrapper_param(name) is not None:
            present = (np.asarray(table[name + "__src"]) >= 0) | (
                np.asarray(table.get(name, -1)) >= 0)
            out[name + "__p"] = present.astype(np.float32)
    return drop_unused(out)


def _hoist_sources(arrays, tables):
    """The reference's `<name>__src` columns of the parameters the port's
    tables hoist, in scene/compiler.py split_sources' layout."""

    def src(ref, port):
        return {k[: -len("__src")]: np.asarray(v, np.int32) for k, v in ref.items()
                if k.endswith("__src") and k[: -len("__src")] in port and np.any(np.asarray(v) >= 0)}

    out = {g: [src(r, p) for r, p in zip(arrays.get(g, []), tables.get(g, []))]
           for g in HOIST_GROUPS}
    out["textures"] = {k: src(arrays["textures"][k], t) for k, t in tables["textures"].items()}
    return out


def params_to_device(params, device=None):
    """A params dict of the reference's differentiable pass ({path: array},
    luisarender_tpu/diff/render.py) as the port's (diff/render.py): {path
    tuple: float32 tensor on `device`}, default the first CUDA card."""
    dev = resolve_device(device)
    return {tuple(path): torch.tensor(np.asarray(v, np.float32), device=dev)
            for path, v in params.items()}


def _any_wrapper(tables, name):
    return any(name + "__p" in t for t in tables)


def _generated_surface(name):
    """The port's class for a surface type name of the reference's plan:
    a registered plugin name, a class name (`MatteSurface`), or a generated
    type `mix<A,B>` / `layered<A,k=K>` whose parts are such names and
    nest; inside them the reference names a nested mix by its class name
    `Mix_A_B`, which resolves too. A nested layered type's class name
    `Layered_A` does not carry the walk's depth, so it is refused: give
    `layered<A,k=K>` in its place."""
    from .surfaces import layered, mix

    name = name.strip()
    for head in ("mix<", "layered<"):
        if name.startswith(head) and name.endswith(">"):
            # the two parts: split at the comma outside any nested <...>
            args, depth, start = [], 0, len(head)
            for i in range(len(head), len(name) - 1):
                depth += {"<": 1, ">": -1}.get(name[i], 0)
                if name[i] == "," and depth == 0:
                    args.append(name[start:i])
                    start = i + 1
            args.append(name[start:-1])
            if len(args) != 2:
                raise ValueError(f"surface type '{name}': expected 2 parts")
            if head == "mix<":
                return mix.monomorphized(*(_generated_surface(a) for a in args))
            if not args[1].startswith("k="):
                raise ValueError(f"surface type '{name}': no walk depth k=")
            return layered.monomorphized(_generated_surface(args[0]), int(args[1][2:]))
    by_class = {c.__name__: c for c in registered(SceneNodeTag.SURFACE)}
    if name in by_class:
        return by_class[name]
    if name.startswith("Mix_"):
        # Mix_<A>_<B>: the split where both parts resolve
        body = name[len("Mix_"):]
        for i in (i for i, c in enumerate(body) if c == "_"):
            try:
                return mix.monomorphized(_generated_surface(body[:i]),
                                         _generated_surface(body[i + 1:]))
            except (ValueError, NotImplementedError):
                continue
    if name.startswith(("Mix_", "Layered_")):
        raise ValueError(f"surface type '{name}': give the generated type's full name "
                         "(mix<A,B> or layered<A,k=K>)")
    return lookup(SceneNodeTag.SURFACE, name)


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
                   texture_types=None, env_distance=0.0, medium_types=(),
                   env_medium_ref=None):
    """numpy reference tables -> (the port's numpy tables, ScenePlan).

    surface_types / light_types / texture_types / medium_types: impl names
    in the reference plan's tag order (`[c.impl_names[0] for c in
    plan.surface_types]`, a generated mix / layered type by its full name,
    `_generated_surface`; the texture tables' own order, which is the
    plan's, when texture_types is None); bvh_leaf_size, env_distance,
    env_medium_ref: the reference plan's."""
    if texture_types is None:
        texture_types = list(arrays.get("textures", {}))
    surf_cls = tuple(_generated_surface(n) for n in surface_types)
    light_cls = tuple(lookup(SceneNodeTag.LIGHT, n) for n in light_types)
    medium_cls = tuple(lookup(SceneNodeTag.MEDIUM, n) for n in medium_types)
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
            **{k: np.asarray(arrays["instances"][k], np.int32) for k in INT_INSTANCE_KEYS},
            **{k: np.asarray(arrays["instances"][k], np.float32)
               for k in FLOAT_INSTANCE_KEYS},
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
        **{k: np.asarray(arrays[k]) for k in ATLAS_KEYS + GRID_KEYS},
        "media": [_numpy_tree(t) for t in arrays.get("media", [])],
        "textures": {
            c.impl_names[0]: _convert_rows(ref_tex[c.impl_names[0]], c, const)
            for c in tex_cls if len(ref_tex.get(c.impl_names[0], {}))
        },
        "trace": trace,
        "world_min": np.asarray(arrays["world_min"], np.float32),
        "world_max": np.asarray(arrays["world_max"], np.float32),
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
        num_instances=int(out["instances"]["surface_tag"].shape[0]),
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
        any_normal_maps=_any_wrapper(out["surfaces"], "normal_map"),
        any_alpha=_any_wrapper(out["surfaces"], "alpha"),
        medium_types=medium_cls,
        has_media=bool(medium_cls),
        env_medium_ref=None if env_medium_ref is None else tuple(env_medium_ref),
        **statics,
    )
    return out, plan


def convert(arrays, surface_types, light_types, scene, device=None,
            bvh_leaf_size=4, texture_types=None, env_distance=0.0, medium_types=(),
            env_medium_ref=None) -> CompiledScene:
    """The reference's compiled tables as a port CompiledScene on `device`
    (default: the first CUDA card); `scene` is the port's Scene of the same
    file, whose cameras, integrator and environment render it. The
    environment node compiles its host state (a spherical map's constant
    flag) and renders from the reference's tables."""
    dev = resolve_device(device)
    spectrum = scene.spectrum.model()
    tables, plan = convert_tables(arrays, surface_types, light_types, bvh_leaf_size,
                                  texture_types, env_distance, medium_types,
                                  env_medium_ref)
    plan = dataclasses.replace(plan, spectral_dim=spectrum.dimension)
    if plan.has_environment:
        scene.environment.compile(None)
    return CompiledScene(
        arrays=hoist_spectral_coeffs(tables_to_device(tables, dev), plan, spectrum),
        plan=plan,
        scene=scene,
        spectrum=spectrum,
        device=dev,
        hoist_src=to_device(_hoist_sources(arrays, tables), dev),
    )
