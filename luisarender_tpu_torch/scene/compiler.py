"""Scene compiler: scene graph -> device tables + static plan.

Counterpart of luisarender_tpu/scene/compiler.py. By default instances are
flattened into one world-space triangle soup with an instance table,
per-surface-type and per-light-type parameter tables, the light list with
its flat area alias tables, and the packed trace / shade tables. On
`accel: "twolevel"`, or on `auto` where flattening would pass 8M
triangles and 4x the unique ones (`choose_two_level`), the trace and shade
tables are two-level instead (`_build_two_level`, accel/twolevel.py):
one SAH BLAS, cluster tables and object-space shade rows a unique mesh,
a Morton TLAS over the instances' world boxes, and a row of transforms an
instance (`arrays["trace2"]`; `arrays["trace"]` is empty). The light
tables, the world bounds and `env_distance` keep the world-space
vertices either way, as in the reference.

Triangles are sorted into the order of a binned-SAH tree (accel/native.py,
leaf size 4), as in the reference: row r of the trace and shade tables is
original triangle `prim_index[r]`, and a hit's slot is its row. Scenes
above BRUTE_FORCE_MAX_TRIS triangles also get the cluster kernel's tables
(`cluster_nodes`, `cluster_tris`; ops/cluster.py build_cluster_tables),
whose blocks carry each triangle's slot, and when an opt-in route asks
for them (ops/subpacket.py and ops/wide8.py ENABLED) and the 8-wide tree
has at most MAX_SLAB8_NODES nodes, as in the reference, the 8-wide tables
(`cluster_slab8`, `cluster_meta8`, `cluster_woop`, `cluster_cboxes`).
Every scene keeps the binary SAH tree (`aabb_min`, `aabb_max`, `skip`,
`node_first`, `node_count`; `bvh_leaf_size` on the plan), the tree of
ops/trace.py. Spheres that qualify
(`analytic_sphere`) are exact quadrics in their own table instead of
triangles. Textures compile to handles and rows of per-type tables
(`arrays["textures"]`, textures/base.py; a parameter that names a constant
texture holds its value, and the scene's `hoist_src` where it came from,
so that the differentiable pass can hoist it anew: `hoist_constants`),
and the image textures' levels
to one atlas (`texture_atlas`, `texture_atlas_rects`, `texture_atlas_mips`;
`_pack_atlas`); the environment, when the scene
has one, to its own tables (`arrays["environment"]`) and the plan's
`env_distance`, twice the diagonal of the real geometry's bounds plus one.
Media (media/base.py, media/grid.py) compile to a parameter table a type
(`arrays["media"]`, the plan's `medium_types`), an instance's to its
`medium_tag`, `medium_index` and `medium_priority` columns (-1, 0, 0 for
none, a vacuum or a null medium), the camera's `environment_medium` to the
plan's `env_medium_ref` (tag, index, priority), and the grids' densities,
padded, to `density_grids` (G, D, H, W) with their `density_grid_dims`;
a sphere that carries a medium stays a mesh, as enter / exit parity needs
it. A scene the fused kernel covers also gets its per-instance tables
(`arrays["fused"]`, see ops/fused_path.py build_fused_pack); a two-level
scene or one with media never does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..accel.bvh import build_bvh_boxes
from ..accel.native import build_bvh_sah
from ..accel.traverse import TraceGeometry
from ..accel.twolevel import INST_COLS, TraceGeometry2L
from ..core.device import resolve_device
from ..core.sampling import build_alias_table
from ..ops import brute, subpacket, wide8
from ..ops.cluster import build_cluster_tables
from ..ops.subpacket import build_bvh8, build_slab_meta, build_woop_table
from ..ops.wide8 import build_cluster_boxes
from ..ops.fused_path import build_fused_pack
from ..shapes.base import compute_vertex_normals
from ..surfaces.mix import device_class
from .geometry import build_shade_table, build_shade_table_object

# above this many triangles a scene traces with the cluster kernel, as in
# the reference; up to it, with the brute-force kernels
BRUTE_FORCE_MAX_TRIS = brute.MAX_TRIS
# `auto` takes the two-level path where flattening would pass this many
# triangles (the reference's estimate: ~150 B of tables a triangle, 1.2 GB)
AUTO_TWO_LEVEL_TRIS = 8_000_000


def choose_two_level(accel: str, flat_tris: int, uniq_tris: int) -> bool:
    """The reference's choice of acceleration: "twolevel" always, "flat"
    never, any other mode ("auto") where the flattened scene would pass
    AUTO_TWO_LEVEL_TRIS triangles and 4x its unique meshes' triangles."""
    if accel == "twolevel":
        return True
    if accel == "flat":
        return False
    return flat_tris > 4 * uniq_tris and flat_tris > AUTO_TWO_LEVEL_TRIS


@dataclass(frozen=True)
class ScenePlan:
    surface_types: tuple  # Surface classes; index == surface tag
    light_types: tuple  # Light classes; index == light tag
    num_lights: int  # light-list entries (emissive instances)
    num_tris: int
    num_instances: int  # shape instances (the command line prints it)
    spectral_dim: int = 3
    num_spheres: int = 0
    fused_path: bool = False  # the fused kernel covers the scene
    bvh_leaf_size: int = 4  # triangles a leaf of the binary SAH tree at most
    bvh8_stack: int = 0  # the 8-wide walk's stack bound; 0 without its tables
    texture_types: tuple = ()  # Texture classes; index == handle type tag
    texture_type_used: tuple = ()  # bool per texture type
    has_environment: bool = False
    env_distance: float = 0.0  # NEE towards the environment ends this far away
    needs_uv: bool = False  # a texture that reads the hit's uv is present
    # a texture that reads the ray cone's footprint (an image) is present,
    # so the general fork carries the cone (integrators/common.py)
    needs_footprint: bool = False
    two_level: bool = False  # TLAS + shared per-mesh BLAS (accel/twolevel.py)
    # a surface row names a normal map (surfaces/base.py shading_frame reads
    # it only then) / an alpha texture (read by nothing on the device)
    any_normal_maps: bool = False
    any_alpha: bool = False
    # the two-level composition's static routing, an entry an instance
    tl_inst_mesh: tuple = ()  # the instance's unique mesh
    tl_inst_opaque: tuple = ()  # it blocks shadow rays
    tl_inst_visible: tuple = ()
    tl_mesh_count: int = 0
    medium_types: tuple = ()  # Medium classes; index == medium tag
    has_media: bool = False
    env_medium_ref: Optional[tuple] = None  # (tag, index, priority) or None


@dataclass
class CompiledScene:
    """Device tables + static plan + spectrum model. It is also the `ctx`
    the device closures (surfaces, lights, light sampler) read."""

    arrays: dict  # nested dict of tensors on `device`
    plan: ScenePlan
    scene: Any  # host node graph
    spectrum: Any  # SpectrumModel
    device: torch.device
    # where each parameter hoisted from a constant texture reads it
    # (split_sources, on `device`); the differentiable pass hoists anew
    # from it (hoist_constants)
    hoist_src: Optional[dict] = None

    def trace_geometry(self):
        """The flat tables as a TraceGeometry, or a two-level scene's as a
        TraceGeometry2L."""
        if self.plan.two_level:
            t2 = self.arrays["trace2"]
            return TraceGeometry2L(
                **{k: t2[k] for k in TraceGeometry2L._fields if k in t2},
                leaf_size=self.plan.bvh_leaf_size,
                cluster_sets=tuple((t2[f"cl_nodes_{m}"], t2[f"cl_tris_{m}"])
                                   for m in range(self.plan.tl_mesh_count)),
                inst_mesh=self.plan.tl_inst_mesh, inst_opaque=self.plan.tl_inst_opaque,
                inst_visible=self.plan.tl_inst_visible,
            )
        tr = self.arrays["trace"]
        return TraceGeometry(
            num_rows=tr["shade_table"].shape[0],
            tri_table=tr.get("tri_table"), cluster_nodes=tr.get("cluster_nodes"),
            cluster_tris=tr.get("cluster_tris"), cluster_woop=tr.get("cluster_woop"),
            cluster_slab8=tr.get("cluster_slab8"), cluster_meta8=tr.get("cluster_meta8"),
            cluster_cboxes=tr.get("cluster_cboxes"), stack8=self.plan.bvh8_stack or None,
            sph=tr.get("sph"), tri_v0=tr.get("tri_v0"), tri_e1=tr.get("tri_e1"),
            tri_e2=tr.get("tri_e2"), prim_index=tr.get("prim_index"), aabb_min=tr.get("aabb_min"), aabb_max=tr.get("aabb_max"), skip=tr.get("skip"),
            node_first=tr.get("node_first"), node_count=tr.get("node_count"),
            leaf_size=self.plan.bvh_leaf_size,
        )


INT_INSTANCE_KEYS = (
    "surface_tag", "surface_index", "light_tag", "light_index", "light_entry",
    "medium_tag", "medium_index",
)
# the float columns of the instance table
FLOAT_INSTANCE_KEYS = ("medium_priority",)


def to_device(x, device):
    """A nested dict / list of numpy arrays as tensors on `device` (copies)."""
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [to_device(v, device) for v in x]
    return torch.tensor(np.asarray(x), device=device)


def tables_to_device(arrays_np: dict, device) -> dict:
    """numpy tables -> tensors on `device`, adding the brute-force kernel
    table (ops/brute.py layout) built from the trace arrays to a scene
    without cluster tables."""
    out = to_device(arrays_np, device)
    tr = out["trace"]
    if "tri_v0" in tr and "cluster_nodes" not in tr:
        tr["tri_table"] = brute.make_tri_table(
            tr["tri_v0"], tr["tri_e1"], tr["tri_e2"], tr["prim_index"], tr["tri_opaque"]
        )
    return out


def hoist_spectral_coeffs(arrays, plan, spectrum):
    """Under a spectrum that is not fixed, give each colour parameter's
    column its fitted coefficients (textures/base.py spectral_param): the
    surface and light classes name theirs in `spectral_params` as (name,
    kind). The coefficients of each row's hoisted value are fitted once
    here, on the tables' device with the table the render decodes
    through: `<name>__ca` (albedo), `__cu` / `__cus` (unbounded, with its
    scale), `__ci` / `__cis` (illuminant). A fixed spectrum's tables come
    back as they are."""
    if spectrum.is_fixed:
        return arrays
    for cls in plan.surface_types:
        if cls.fixed_spectrum_only:
            raise NotImplementedError(
                f"surface '{cls.impl_names[0]}' under a spectrum that is not fixed: "
                f"{cls.fixed_spectrum_only}")

    from ..textures.base import COEFF_SUFFIX

    def aug(table, cls):
        out = dict(table)
        for name, kind in cls.spectral_params:
            ck = COEFF_SUFFIX[kind]
            fit = getattr(spectrum, "coeffs_" + kind)(table[name])
            if kind == "albedo":
                out[name + ck] = fit
            else:
                out[name + ck], out[name + ck + "s"] = fit
        return out

    out = dict(arrays)
    out["surfaces"] = [aug(t, c) for t, c in zip(arrays["surfaces"], plan.surface_types)]
    out["lights"] = [aug(t, c) for t, c in zip(arrays["lights"], plan.light_types)]
    return out


# the parameter tables a type a group; "textures" is a dict by type name
HOIST_GROUPS = ("surfaces", "lights", "media")


def split_sources(arrays):
    """Take the `<name>__src` columns (textures/base.py compile_tex_param)
    out of the parameter tables, in place, and return them: {group: [{name:
    rows' constant-table rows} a type]} for HOIST_GROUPS, and {"textures":
    {type: {name: ...}}}; a column where no row hoists a constant is
    dropped."""

    def split(table):
        src = {k[: -len("__src")]: table.pop(k) for k in [k for k in table if k.endswith("__src")]}
        return {k: v for k, v in src.items() if np.any(np.asarray(v) >= 0)}

    out = {g: [split(t) for t in arrays.get(g, [])] for g in HOIST_GROUPS}
    out["textures"] = {k: split(t) for k, t in arrays.get("textures", {}).items()}
    return out


def hoist_constants(arrays, sources):
    """The parameter tables with each column hoisted from a constant texture
    read anew from `textures.constant.value` at its rows (sources:
    split_sources' on the tables' device), as the reference's
    `_hoist_constants` does at every pass, so that an override of the
    constant table reaches every parameter that names it. The rows that
    hoist nothing keep their values; new dicts and lists, no tensor copied
    but the hoisted columns."""
    const = arrays.get("textures", {}).get("constant", {}).get("value")
    if const is None or not sources:
        return arrays

    def hoist(table, src):
        if not src:
            return table
        out = dict(table)
        for name, rows in src.items():
            cur = table[name]
            vals = const[torch.clamp(rows, 0, const.shape[0] - 1).long()]
            vals = vals[:, 0] if cur.dim() == 1 else vals[:, : cur.shape[-1]]
            mask = (rows >= 0).reshape(-1, *([1] * (cur.dim() - 1)))
            out[name] = torch.where(mask, vals, cur)
        return out

    out = dict(arrays)
    for g in HOIST_GROUPS:
        if g in arrays:
            out[g] = [hoist(t, src) for t, src in zip(arrays[g], sources[g])]
    out["textures"] = {k: hoist(t, sources["textures"].get(k)) for k, t in arrays["textures"].items()}
    return out


def drop_unused(table):
    """A parameter table without the columns no row uses: a texture
    parameter's handle column (`<name>__h`, textures/base.py) where no row
    has a varying texture, so such a type never evaluates textures, and a
    wrapper texture's presence flag (`<name>__p`, surfaces/base.py) where
    no row names one, so its closures never map a normal."""
    for k in [k for k in table if k.endswith("__h")]:
        if np.all(np.asarray(table[k]) < 0):
            del table[k]
    for k in [k for k in table if k.endswith("__p")]:
        if not np.any(np.asarray(table[k]) > 0.5):
            del table[k]
    return table


def stack_rows(rows_list):
    """Per-type lists of row dicts -> per-type dicts of stacked columns,
    the unused ones dropped (drop_unused)."""
    return [drop_unused({k: np.stack([r[k] for r in rows]) for k in rows[0]})
            for rows in rows_list]


class SceneCompiler:
    def __init__(self, scene, time=0.0):
        self.scene = scene
        self.time = float(time)  # the shutter time world transforms are baked at
        self.spectrum = scene.spectrum.model()
        self._surface_types: list = []
        self._surface_rows: list = []
        self._surface_cache: dict = {}  # id(node) -> (tag, index)
        self._light_types: list = []
        self._light_rows: list = []
        self._light_cache: dict = {}
        self._texture_types: list = []
        self._texture_rows: list = []
        self._texture_cache: dict = {}  # id(node) -> handle
        # the image atlas (textures/image.py): (H, W, 4) images, keyed by
        # the identity of the array
        self._atlas_images: list = []
        self._atlas_image_ids: dict = {}
        self._medium_types: list = []
        self._medium_rows: list = []
        self._medium_cache: dict = {}
        self._density_grids: list = []  # (D, H, W) float32 volumes

    def register_texture_row(self, cls, row: dict) -> int:
        from ..textures.base import make_handle

        if cls not in self._texture_types:
            self._texture_types.append(cls)
            self._texture_rows.append([])
        type_id = self._texture_types.index(cls)
        rows = self._texture_rows[type_id]
        rows.append(row)
        return make_handle(type_id, len(rows) - 1)

    def register_atlas_image(self, image: np.ndarray) -> int:
        """The atlas id of an (H, W, 4) image; one array registered twice
        keeps one id."""
        key = id(image)
        if key not in self._atlas_image_ids:
            self._atlas_image_ids[key] = len(self._atlas_images)
            self._atlas_images.append(image)
        return self._atlas_image_ids[key]

    @staticmethod
    def _mip_chain(img: np.ndarray) -> list:
        """The 2x2 box-filtered mip chain of an image down to 1x1, in
        float32; an odd side is edge-padded before it halves."""
        levels = [img]
        cur = img
        while cur.shape[0] > 1 or cur.shape[1] > 1:
            h, w = cur.shape[:2]
            if h % 2 or w % 2:
                cur = np.pad(cur, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
            cur = (cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]) * 0.25
            levels.append(np.ascontiguousarray(cur, np.float32))
        return levels

    def _pack_atlas(self):
        """Shelf-pack every registered image and its mip levels into one
        (H, W, 4) array, as the reference does: levels sorted by descending
        height (a stable sort), shelves of width max(2048, the widest
        level). Returns (atlas, rects (levels, 4) int32 x, y, w, h,
        mip table (images, 2) int32 first rect, level count); an empty
        atlas is 1 x 1."""
        if not self._atlas_images:
            return (np.zeros((1, 1, 4), np.float32), np.zeros((1, 4), np.int32),
                    np.zeros((1, 2), np.int32))
        mip_table, flat = [], []
        for img in self._atlas_images:
            chain = self._mip_chain(img)
            mip_table.append((len(flat), len(chain)))
            flat.extend(chain)
        order = sorted(range(len(flat)), key=lambda i: -flat[i].shape[0])
        atlas_w = max(2048, max(img.shape[1] for img in flat))
        rects = [None] * len(flat)
        x = y = shelf_h = 0
        for i in order:
            h, w = flat[i].shape[:2]
            if x + w > atlas_w:
                y += shelf_h
                x = shelf_h = 0
            rects[i] = (x, y, w, h)
            x += w
            shelf_h = max(shelf_h, h)
        atlas = np.zeros((y + shelf_h, atlas_w, 4), np.float32)
        for (rx, ry, w, h), img in zip(rects, flat):
            atlas[ry : ry + h, rx : rx + w] = img
        return atlas, np.asarray(rects, np.int32), np.asarray(mip_table, np.int32)

    def register_density_grid(self, grid: np.ndarray) -> int:
        self._density_grids.append(np.asarray(grid, np.float32))
        return len(self._density_grids) - 1

    def _pack_density_grids(self):
        """Every grid zero-padded into one (G, D, H, W) block, and its own
        (D, H, W) a row; a 1^3 block without grids."""
        if not self._density_grids:
            return np.zeros((1, 1, 1, 1), np.float32), np.ones((1, 3), np.int32)
        shape = np.max([g.shape for g in self._density_grids], axis=0)
        out = np.zeros((len(self._density_grids), *shape), np.float32)
        dims = np.zeros((len(self._density_grids), 3), np.int32)
        for i, g in enumerate(self._density_grids):
            out[i, : g.shape[0], : g.shape[1], : g.shape[2]] = g
            dims[i] = g.shape
        return out, dims

    def compile_medium(self, node):
        return self._compile_row(node, type(node), self._medium_types, self._medium_rows,
                                 self._medium_cache)

    def _medium_columns(self, medium):
        """(tag, index, priority) of an instance's medium; (-1, 0, 0.0) for
        none, a vacuum or a null medium."""
        if medium is None or medium.is_null or medium.is_vacuum:
            return -1, 0, 0.0
        return (*self.compile_medium(medium), float(medium.priority))

    def compile_texture(self, node) -> int:
        key = id(node)
        if key not in self._texture_cache:
            self._texture_cache[key] = node.compile(self)
        return self._texture_cache[key]

    def _compile_row(self, node, cls, types, rows_list, cache):
        """(tag, index) of a node's row in the table of its class `cls`,
        compiled once a node."""
        key = id(node)
        if key not in cache:
            if cls not in types:
                types.append(cls)
                rows_list.append([])
            tag = types.index(cls)
            rows = rows_list[tag]
            rows.append(node.compile(self))
            cache[key] = (tag, len(rows) - 1)
        return cache[key]

    def compile_surface(self, node):
        # mix and layered compile to generated classes (surfaces/mix.py)
        return self._compile_row(node, device_class(node), self._surface_types,
                                 self._surface_rows, self._surface_cache)

    def compile_light(self, node):
        return self._compile_row(node, type(node), self._light_types, self._light_rows,
                                 self._light_cache)

    def _walk_shapes(self):
        """(shape, world_matrix, surface, light, medium, visible) for every
        mesh instance; a group's or instance's transform, surface, light,
        medium and visibility pass down to its children."""
        out = []

        def walk(shape, parent_m, surface, light, medium, visible):
            m = parent_m
            if shape.transform is not None and not shape.transform.is_identity:
                m = parent_m @ shape.transform.matrix(self.time)
            surface = shape.surface or surface
            light = shape.light or light
            medium = shape.medium or medium
            visible = visible and shape.visible
            if shape.is_mesh:
                out.append((shape, m, surface, light, medium, visible))
            else:
                for child in shape.children():
                    walk(child, m, surface, light, medium, visible)

        for s in self.scene.shapes:
            walk(s, np.eye(4), None, None, None, True)
        return out

    @staticmethod
    def analytic_sphere(shape, m, surface, light, medium=None):
        """(center (3,), radius, rotation (3, 3)) when this instance can be
        intersected as an exact quadric, else None: an analytic sphere with
        a surface, no light and no medium (a vacuum or null one aside: a
        medium boundary needs the mesh's enter / exit parity), under a
        similarity transform (uniform scale times rotation, plus
        translation)."""
        from ..shapes.impls import SphereShape

        if not isinstance(shape, SphereShape) or not shape.analytic:
            return None
        if light is not None or surface is None or getattr(surface, "is_null", False):
            return None
        if medium is not None and not medium.is_null and not medium.is_vacuum:
            return None
        a = np.asarray(m, np.float64)[:3, :3]
        det = np.linalg.det(a)
        if det <= 0.0:
            return None
        sc = det ** (1.0 / 3.0)
        if not np.allclose(a @ a.T, (sc * sc) * np.eye(3), rtol=1e-5, atol=1e-5 * sc * sc):
            return None
        return (
            np.asarray(m, np.float64)[:3, 3].astype(np.float32),
            np.float32(sc),
            (a / sc).astype(np.float32),
        )

    def _build_two_level(self, unique_meshes, inst_mesh_ids, inst_matrices, inst_blocks,
                         inst_visible):
        """The two-level tables (accel/twolevel.py layout; numpy) and the
        plan's statics, as the reference builds them: each unique mesh's
        SAH BLAS, object-space triangle and shade rows and cluster tables
        (every triangle opaque, the slot a hit returns the mesh's own SAH
        slot plus its prim offset, a row of the concatenated shade rows),
        an instance row each (world-to-object from np.linalg.inv in float64,
        stored float32), the instances' world boxes from the 8 corners of
        their BLAS root, and the Morton TLAS over them, one instance a
        leaf. Returns (trace2, BLAS leaf size, statics)."""
        blas_min, blas_max, blas_skip, blas_first, blas_count = [], [], [], [], []
        tri_v0, tri_e1, tri_e2, tri_valid, shade_rows = [], [], [], [], []
        cluster_sets = []
        mesh_info = []  # (node offset, prim offset, root box min, max)
        node_off = prim_off = 0
        leaf_size = None
        for mesh in unique_meshes.values():
            pos = mesh.positions.astype(np.float32)
            tris = mesh.triangles.astype(np.int32)
            bvh = build_bvh_sah(pos, tris)
            if leaf_size is None:
                leaf_size = int(bvh.leaf_size)
            if int(bvh.leaf_size) != leaf_size:
                raise RuntimeError("the BLASes of one scene must share a leaf size")
            pi = bvh.prim_index
            canon = np.full(tris.shape[0], -1, np.int64)
            vr = pi >= 0
            canon[pi[vr]] = np.nonzero(vr)[0]
            cluster_sets.append(build_cluster_tables(
                pos, tris, np.ones(tris.shape[0], bool), canon + prim_off))
            sorted_tris = tris[np.maximum(pi, 0)]
            v0 = pos[sorted_tris[:, 0]]
            blas_min.append(bvh.aabb_min)
            blas_max.append(bvh.aabb_max)
            blas_skip.append(bvh.skip)  # local; -1 leaves the BLAS
            blas_first.append(bvh.node_first)
            blas_count.append(bvh.node_count)
            tri_v0.append(v0)
            tri_e1.append(pos[sorted_tris[:, 1]] - v0)
            tri_e2.append(pos[sorted_tris[:, 2]] - v0)
            tri_valid.append(pi >= 0)
            nrm = (mesh.normals.astype(np.float32) if mesh.normals is not None
                   else compute_vertex_normals(pos, tris))
            uv = (mesh.uvs.astype(np.float32) if mesh.uvs is not None
                  else np.zeros((pos.shape[0], 2), np.float32))
            shade_rows.append(build_shade_table_object(pos, nrm, uv, tris, pi))
            mesh_info.append((node_off, prim_off, bvh.aabb_min[0], bvh.aabb_max[0]))
            node_off += bvh.aabb_min.shape[0]
            prim_off += pi.shape[0]

        n_inst = len(inst_mesh_ids)
        rows = np.zeros((n_inst, INST_COLS), np.float32)
        imin = np.zeros((n_inst, 3), np.float32)
        imax = np.zeros((n_inst, 3), np.float32)
        for i, (mesh_i, m) in enumerate(zip(inst_mesh_ids, inst_matrices)):
            rows[i, 0:12] = np.linalg.inv(m)[:3, :4].reshape(-1)
            rows[i, 12:24] = np.asarray(m, np.float64)[:3, :4].reshape(-1)
            n_off, p_off, bmin, bmax = mesh_info[mesh_i]
            rows[i, 24] = n_off
            rows[i, 25] = p_off
            rows[i, 26] = 1.0 if inst_blocks[i] else 0.0
            rows[i, 27] = 1.0 if inst_visible[i] else 0.0
            corners = np.array([[x, y, z] for x in (bmin[0], bmax[0])
                                for y in (bmin[1], bmax[1]) for z in (bmin[2], bmax[2])])
            cw = corners @ np.asarray(m)[:3, :3].T + np.asarray(m)[:3, 3]
            imin[i] = cw.min(axis=0)
            imax[i] = cw.max(axis=0)

        tlas = build_bvh_boxes(imin, imax, leaf_size=1)
        tlas_leaf = tlas.node_count > 0
        tlas_inst = np.full(tlas.node_first.shape[0], -1, np.int32)
        tlas_inst[tlas_leaf] = tlas.prim_index[np.maximum(tlas.node_first[tlas_leaf], 0)]
        trace2 = {
            "tlas_aabb_min": tlas.aabb_min, "tlas_aabb_max": tlas.aabb_max,
            "tlas_skip": tlas.skip, "tlas_inst": tlas_inst, "tlas_leaf": tlas_leaf,
            "blas_aabb_min": np.concatenate(blas_min), "blas_aabb_max": np.concatenate(blas_max),
            "blas_skip": np.concatenate(blas_skip), "blas_first": np.concatenate(blas_first),
            "blas_count": np.concatenate(blas_count),
            "tri_v0": np.concatenate(tri_v0), "tri_e1": np.concatenate(tri_e1),
            "tri_e2": np.concatenate(tri_e2), "tri_valid": np.concatenate(tri_valid),
            "inst_rows": rows, "shade_rows": np.concatenate(shade_rows),
        }
        for m, (nodes, blocks) in enumerate(cluster_sets):
            trace2[f"cl_nodes_{m}"] = nodes
            trace2[f"cl_tris_{m}"] = blocks
        statics = {
            "tl_inst_mesh": tuple(int(i) for i in inst_mesh_ids),
            "tl_inst_opaque": tuple(bool(b) for b in inst_blocks),
            "tl_inst_visible": tuple(bool(v) for v in inst_visible),
            "tl_mesh_count": len(cluster_sets),
        }
        return trace2, leaf_size, statics

    def compile_numpy(self):
        """Host tables (nested dict of numpy arrays) and the static plan."""
        scene = self.scene
        instances = self._walk_shapes()
        if not instances:
            raise ValueError("scene contains no mesh instances")

        # the two-level path has no sphere table: its spheres are meshes
        analytic = [
            self.analytic_sphere(shape, m, surface, light, medium)
            if scene.accel != "twolevel" else None
            for shape, m, surface, light, medium, _ in instances
        ]

        def count_meshes():
            unique, flat = {}, 0
            for (shape, *_), an in zip(instances, analytic):
                if an is None:
                    mesh = shape.mesh()
                    unique.setdefault(id(mesh), mesh)
                    flat += mesh.triangles.shape[0]
            return unique, flat

        unique_meshes, flat_tris = count_meshes()
        uniq_tris = sum(m.triangles.shape[0] for m in unique_meshes.values())
        two_level = choose_two_level(scene.accel, flat_tris, uniq_tris)
        if two_level and any(an is not None for an in analytic):
            analytic = [None] * len(instances)
            unique_meshes, flat_tris = count_meshes()
        mesh_index = {key: i for i, key in enumerate(unique_meshes)}

        all_p, all_n, all_uv, all_t, all_ti = [], [], [], [], []
        inst_rows = {k: [] for k in INT_INSTANCE_KEYS + FLOAT_INSTANCE_KEYS}
        inst_mesh_ids, inst_matrices = [], []  # the two-level instance rows
        light_entries = {
            "inst": [], "alias_offset": [], "tri_offset": [], "tri_count": [],
            "total_area": [],
        }
        alias_prob_flat: list = []
        alias_alias_flat: list = []
        # packed per-emissive-triangle rows, in the alias tables' flat order
        light_tri_rows: list = []

        sphere_rows: list = []  # (instance id, center, radius, rotation)
        v_off = 0
        t_off = 0
        for inst_id, (shape, m, surface, light, medium, _) in enumerate(instances):
            an = analytic[inst_id]
            if an is not None:
                sphere_rows.append((inst_id, *an))
                s_tag, s_idx = self.compile_surface(surface)
                for k, v in (("surface_tag", s_tag), ("surface_index", s_idx),
                             ("light_tag", -1), ("light_index", 0), ("light_entry", -1),
                             ("medium_tag", -1), ("medium_index", 0),
                             ("medium_priority", 0.0)):
                    inst_rows[k].append(v)
                continue
            mesh = shape.mesh()
            inst_mesh_ids.append(mesh_index[id(mesh)])
            inst_matrices.append(np.asarray(m, np.float64))
            p = mesh.positions.astype(np.float64)
            pw = (p @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
            tris = mesh.triangles.astype(np.int32)
            uv = (
                mesh.uvs.astype(np.float32)
                if mesh.uvs is not None
                else np.zeros((pw.shape[0], 2), np.float32)
            )
            # the world-space vertices give the bounds; the flat path's
            # tables also take their normals, uvs and triangles
            all_p.append(pw)
            if not two_level:
                if mesh.normals is not None:
                    nm = np.linalg.inv(m[:3, :3]).T
                    nw = mesh.normals.astype(np.float64) @ nm.T
                    nw = nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
                    nw = nw.astype(np.float32)
                else:
                    nw = compute_vertex_normals(pw, tris)
                all_n.append(nw)
                all_uv.append(uv)
                all_t.append(tris + v_off)
                all_ti.append(np.full(tris.shape[0], inst_id, np.int32))

            # a null surface (a light panel, a medium boundary) has no tag
            if surface is not None and not getattr(surface, "is_null", False):
                s_tag, s_idx = self.compile_surface(surface)
            else:
                s_tag, s_idx = -1, 0
            if light is not None:
                l_tag, l_idx = self.compile_light(light)
                # per-instance light entry with an area alias table
                e0 = pw[tris[:, 1]] - pw[tris[:, 0]]
                e1 = pw[tris[:, 2]] - pw[tris[:, 0]]
                areas = 0.5 * np.linalg.norm(np.cross(e0, e1), axis=-1)
                table = build_alias_table(areas)
                entry_id = len(light_entries["inst"])
                light_entries["inst"].append(inst_id)
                light_entries["alias_offset"].append(len(alias_prob_flat))
                light_entries["tri_offset"].append(t_off)
                light_entries["tri_count"].append(tris.shape[0])
                light_entries["total_area"].append(float(areas.sum()))
                alias_prob_flat.extend(table.prob.tolist())
                alias_alias_flat.extend(table.alias.tolist())
                lt = np.zeros((tris.shape[0], 24), np.float32)
                lt[:, 0:3] = pw[tris[:, 0]]
                lt[:, 3:6] = e0  # p1 - p0
                lt[:, 6:9] = e1  # p2 - p0
                ng_l = np.cross(e0, e1)
                lt[:, 9:12] = ng_l / np.maximum(
                    np.linalg.norm(ng_l, axis=-1, keepdims=True), 1e-20
                )
                lt[:, 12:14] = uv[tris[:, 0]]
                lt[:, 14:16] = uv[tris[:, 1]]
                lt[:, 16:18] = uv[tris[:, 2]]
                lt[:, 18] = table.prob
                lt[:, 19] = table.alias
                light_tri_rows.append(lt)
            else:
                l_tag, l_idx, entry_id = -1, 0, -1

            inst_rows["surface_tag"].append(s_tag)
            inst_rows["surface_index"].append(s_idx)
            inst_rows["light_tag"].append(l_tag)
            inst_rows["light_index"].append(l_idx)
            inst_rows["light_entry"].append(entry_id)
            for k, v in zip(("medium_tag", "medium_index", "medium_priority"),
                            self._medium_columns(medium)):
                inst_rows[k].append(v)
            v_off += pw.shape[0]
            t_off += tris.shape[0]

        if not all_p:
            # spheres only: one far-away degenerate triangle keeps the
            # triangle tables non-empty, as in the reference
            all_p.append(np.full((3, 3), 1e30, np.float32))
            all_n.append(np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (3, 1)))
            all_uv.append(np.zeros((3, 2), np.float32))
            all_t.append(np.asarray([[0, 1, 2]], np.int32))
            all_ti.append(np.zeros(1, np.int32))
        vertex_p = np.concatenate(all_p, axis=0)

        env = scene.environment
        has_env = env is not None and not env.is_null
        if has_env:
            env.compile(self)
        # the camera's medium: every path starts in it
        env_tag, env_idx, env_prio = self._medium_columns(scene.environment_medium)
        env_medium_ref = None if env_tag < 0 else (env_tag, env_idx, env_prio)

        # shadow blockers: anything with a surface or a light
        inst_blocks = (np.asarray(inst_rows["surface_tag"]) >= 0) | (
            np.asarray(inst_rows["light_tag"]) >= 0
        )

        # world bounds of the real geometry (not the far padding triangle of
        # a spheres-only scene, which would put env_distance out of float32's
        # squared range): the photon grid's box, and the environment's
        # distance
        real_p = vertex_p[np.abs(vertex_p).max(axis=-1) < 1e29]
        mins = [real_p.min(axis=0)] if real_p.size else []
        maxs = [real_p.max(axis=0)] if real_p.size else []
        for _, center, radius, _ in sphere_rows:
            mins.append(center - radius)
            maxs.append(center + radius)
        if not mins:
            mins, maxs = [vertex_p.min(axis=0)], [vertex_p.max(axis=0)]
        world_min, world_max = np.minimum.reduce(mins), np.maximum.reduce(maxs)
        env_distance = 0.0
        if has_env:
            env_distance = float(np.linalg.norm(world_max - world_min)) * 2.0 + 1.0

        atlas, atlas_rects, atlas_mips = self._pack_atlas()
        arrays = {
            "instances": {
                k: np.asarray(v, np.float32 if k in FLOAT_INSTANCE_KEYS else np.int32)
                for k, v in inst_rows.items()
            },
            "light_entries": {
                k: np.asarray(v, np.float32 if k == "total_area" else np.int32)
                for k, v in light_entries.items()
            },
            "light_alias_prob": np.asarray(alias_prob_flat or [0.0], np.float32),
            "light_alias_alias": np.asarray(alias_alias_flat or [0], np.int32),
            "light_tri_rows": (
                np.concatenate(light_tri_rows, axis=0)
                if light_tri_rows
                else np.zeros((1, 24), np.float32)
            ),
            "surfaces": stack_rows(self._surface_rows),
            "lights": stack_rows(self._light_rows),
            "texture_atlas": atlas,
            "texture_atlas_rects": atlas_rects,
            "texture_atlas_mips": atlas_mips,
            "textures": {
                cls.impl_names[0]: stack_rows([rows])[0]
                for cls, rows in zip(self._texture_types, self._texture_rows) if rows
            },
            "media": stack_rows(self._medium_rows),
            "trace": {},
            "world_min": np.asarray(world_min, np.float32),
            "world_max": np.asarray(world_max, np.float32),
        }
        arrays["density_grids"], arrays["density_grid_dims"] = self._pack_density_grids()
        self.hoist_src = split_sources(arrays)
        statics = {}
        bvh8_stack = 0
        if two_level:
            num_tris = flat_tris
            arrays["trace2"], leaf_size, statics = self._build_two_level(
                unique_meshes, inst_mesh_ids, inst_matrices, inst_blocks,
                [v for *_, v in instances])
        else:
            triangles = np.concatenate(all_t, axis=0)
            tri_inst = np.concatenate(all_ti, axis=0)
            num_tris = triangles.shape[0]
            # the SAH order of the reference (its builder's default leaf
            # size); the tree itself is kept for ops/trace.py, as the
            # reference keeps it
            bvh = build_bvh_sah(vertex_p, triangles)
            leaf_size = int(bvh.leaf_size)
            prim_index = bvh.prim_index
            sorted_tris = triangles[prim_index]
            tv0 = vertex_p[sorted_tris[:, 0]]
            tv1 = vertex_p[sorted_tris[:, 1]]
            tv2 = vertex_p[sorted_tris[:, 2]]
            arrays["trace"] = {
                "tri_v0": tv0,
                "tri_e1": tv1 - tv0,
                "tri_e2": tv2 - tv0,
                "prim_index": prim_index,
                "tri_opaque": inst_blocks[tri_inst[prim_index]],
                "aabb_min": bvh.aabb_min,
                "aabb_max": bvh.aabb_max,
                "skip": bvh.skip,
                "node_first": bvh.node_first,
                "node_count": bvh.node_count,
                "shade_table": build_shade_table(
                    vertex_p, np.concatenate(all_n, axis=0), np.concatenate(all_uv, axis=0),
                    triangles, tri_inst, prim_index,
                ),
            }
            if num_tris > BRUTE_FORCE_MAX_TRIS:
                canon_of_orig = np.empty(num_tris, np.int64)
                canon_of_orig[prim_index] = np.arange(num_tris)
                nodes, blocks = build_cluster_tables(
                    vertex_p, triangles, inst_blocks[tri_inst], canon_of_orig
                )
                arrays["trace"]["cluster_nodes"] = nodes
                arrays["trace"]["cluster_tris"] = blocks
                # the 8-wide tables feed only the opt-in routes, so other
                # renders skip their build (the Woop blocks are 4x the
                # triangle blocks)
                table8 = build_bvh8(nodes) if subpacket.ENABLED or wide8.ENABLED else None
                if table8 is not None and table8.shape[0] <= subpacket.MAX_SLAB8_NODES:
                    slab8, meta8 = build_slab_meta(table8)
                    # at most N8: the kernels' larger stack holds it
                    bvh8_stack = subpacket.stack8_need(meta8)
                    arrays["trace"]["cluster_woop"] = build_woop_table(blocks)
                    arrays["trace"]["cluster_slab8"] = slab8
                    arrays["trace"]["cluster_meta8"] = meta8
                    arrays["trace"]["cluster_cboxes"] = build_cluster_boxes(nodes)
        if sphere_rows:
            # accel/traverse.py sphere table layout
            sph = np.zeros((len(sphere_rows), 16), np.float32)
            for si, (iid, center, radius, rot) in enumerate(sphere_rows):
                sph[si, 0:3] = center
                sph[si, 3] = radius
                sph[si, 4:13] = rot.reshape(-1)
                sph[si, 13] = float(iid)
                sph[si, 14] = 1.0  # opaque: an analytic sphere has a surface
            arrays["trace"]["sph"] = sph
        if has_env:
            arrays["environment"] = env.device_arrays()
        fused = build_fused_pack(
            self._surface_types, self._surface_rows, self._light_types,
            self._light_rows, inst_rows, light_entries, self.spectrum,
            num_tris, bool(np.all(inst_blocks)), n_spheres=len(sphere_rows),
            environment=env if has_env else None, two_level=two_level,
            has_media=bool(self._medium_types),
        )
        if fused is not None:
            arrays["fused"] = fused
        plan = ScenePlan(
            surface_types=tuple(self._surface_types),
            light_types=tuple(self._light_types),
            num_lights=len(light_entries["inst"]),
            num_tris=num_tris,
            num_instances=len(instances),
            spectral_dim=self.spectrum.dimension,
            num_spheres=len(sphere_rows),
            fused_path=fused is not None,
            bvh_leaf_size=leaf_size,
            bvh8_stack=bvh8_stack,
            texture_types=tuple(self._texture_types),
            texture_type_used=tuple(bool(rows) for rows in self._texture_rows),
            has_environment=has_env,
            env_distance=env_distance,
            needs_uv=any(rows and cls.impl_names[0] != "constant"
                         for cls, rows in zip(self._texture_types, self._texture_rows)),
            needs_footprint=any(rows and cls.reads_footprint for cls, rows in
                                zip(self._texture_types, self._texture_rows)),
            two_level=two_level,
            any_normal_maps=self._any_wrapper("normal_map"),
            any_alpha=self._any_wrapper("alpha"),
            medium_types=tuple(self._medium_types),
            has_media=bool(self._medium_types),
            env_medium_ref=env_medium_ref,
            **statics,
        )
        return arrays, plan

    def _any_wrapper(self, name):
        """Whether a surface row names the wrapper texture `name` itself
        (a child's inside a mix or layered row does not count, as in the
        reference)."""
        return any(float(r.get(name + "__p", 0.0)) > 0.5
                   for rows in self._surface_rows for r in rows)

    def compile(self, device) -> CompiledScene:
        arrays, plan = self.compile_numpy()
        return CompiledScene(
            arrays=hoist_spectral_coeffs(tables_to_device(arrays, device), plan, self.spectrum),
            plan=plan,
            scene=self.scene,
            spectrum=self.spectrum,
            device=device,
            hoist_src=to_device(self.hoist_src, device),
        )


def compile_scene(scene, device=None, time=0.0) -> CompiledScene:
    """Compile `scene` onto `device` (default: the first CUDA card), its
    world transforms baked at shutter time `time`."""
    return SceneCompiler(scene, time).compile(resolve_device(device))
