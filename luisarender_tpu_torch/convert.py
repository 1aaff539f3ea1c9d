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
surface / light rows with their constant textures, and the fused tables.

Both packages keep triangles in the order of the same SAH tree, and the
cluster tables carry each triangle's slot in it, so a converted scene's
tables are the port compiler's own and its hit slots the reference's.
The reference's per-instance constant-texture columns (`<name>__src`,
rows of textures.constant.value) are hoisted into values here, as the
port's own compiler does.
"""

from __future__ import annotations

import numpy as np

from .core.device import resolve_device
from .ops import subpacket
from .scene.compiler import (
    INT_INSTANCE_KEYS, CompiledScene, ScenePlan, tables_to_device,
)
from .scene.node import SceneNodeTag
from .scene.registry import lookup

TRACE_KEYS = ("tri_v0", "tri_e1", "tri_e2", "prim_index", "tri_opaque", "shade_table",
              "sph", "aabb_min", "aabb_max", "skip", "node_first", "node_count",
              "cluster_nodes", "cluster_tris", "cluster_woop", "cluster_slab8",
              "cluster_meta8", "cluster_cboxes")
# wrapper-feature textures the port does not support
_UNSUPPORTED_TEXTURES = ("normal_map", "alpha")


def _hoist(table, const, name, default, channels):
    src = np.asarray(table[name + "__src"])
    handles = table.get(name)
    if handles is not None and np.any((src < 0) & (np.asarray(handles) >= 0)):
        raise NotImplementedError(
            f"parameter '{name}' has a non-constant texture, which "
            "luisarender_tpu_torch does not support yet"
        )
    dflt = np.broadcast_to(np.asarray(default, np.float32), (src.shape[0], 4))
    if const is None:
        vals = dflt
    else:
        picked = const[np.clip(src, 0, const.shape[0] - 1)]
        vals = np.where((src >= 0)[:, None], picked, dflt)
    vals = np.ascontiguousarray(vals[:, :channels], np.float32)
    return vals[:, 0] if channels == 1 else vals


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
        out[name] = _hoist(table, const, name, default, channels)
    return out


def convert_tables(arrays, surface_types, light_types, bvh_leaf_size=4):
    """numpy reference tables -> (the port's numpy tables, ScenePlan).

    surface_types / light_types: impl names in the reference plan's tag order
    (`[c.impl_names[0] for c in plan.surface_types]`); bvh_leaf_size: the
    reference plan's."""
    surf_cls = tuple(lookup(SceneNodeTag.SURFACE, n) for n in surface_types)
    light_cls = tuple(lookup(SceneNodeTag.LIGHT, n) for n in light_types)
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
        "lights": [
            _convert_rows(t, c, const) for t, c in zip(arrays["lights"], light_cls)
        ],
        "trace": trace,
    }
    if "fused" in arrays:
        out["fused"] = {k: np.asarray(v, np.float32) for k, v in arrays["fused"].items()}
    plan = ScenePlan(
        surface_types=surf_cls,
        light_types=light_cls,
        num_lights=int(out["light_entries"]["inst"].shape[0]),
        num_tris=int(np.sum(trace["prim_index"] >= 0)),
        num_spheres=int(trace["sph"].shape[0]) if "sph" in trace else 0,
        fused_path="fused" in out,
        bvh_leaf_size=int(bvh_leaf_size),
        bvh8_stack=(subpacket.stack8_need(trace["cluster_meta8"])
                    if "cluster_meta8" in trace else 0),
    )
    return out, plan


def convert(arrays, surface_types, light_types, scene, device=None,
            bvh_leaf_size=4) -> CompiledScene:
    """The reference's compiled tables as a port CompiledScene on `device`
    (default: the first CUDA card); `scene` is the port's Scene of the same
    file, whose cameras and integrator render it."""
    dev = resolve_device(device)
    tables, plan = convert_tables(arrays, surface_types, light_types, bvh_leaf_size)
    return CompiledScene(
        arrays=tables_to_device(tables, dev),
        plan=plan,
        scene=scene,
        spectrum=scene.spectrum.model(),
        device=dev,
    )
