"""glTF 2.0 (.gltf/.glb) -> JSON scene converter.

Counterpart of luisarender_tpu/tools/gltf2scene.py, kept as the port's own
copy (LuisaRender's src/apps/export.cpp:77-260 imports glTF through Assimp
with a Disney material mapping and texture extraction; this is a
pure-Python glTF parser): JSON + external/embedded buffers, binary GLB
container, accessor/bufferView decoding with strides, node-hierarchy
flattening, pbrMetallicRoughness -> Disney surface mapping, emissive
materials -> diffuse area lights, embedded/URI textures extracted to PNG.
Textures are decoded by the port's own PNG reader (utils/imageio.py
png_rgba8); a texture in another format (JPEG, ...) is reported and the
material keeps its factors.

    python -m luisarender_tpu_torch.tools.gltf2scene model.glb -o out/scene.json

Geometry is dumped as one OBJ per mesh primitive next to the scene JSON
(the same OBJ+JSON output shape as the reference exporter)."""

from __future__ import annotations

import argparse
import base64
import json
import struct
import sys
from pathlib import Path

import numpy as np

from ..utils import imageio

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


def _load_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<4sII", data, 0)
    if magic != b"glTF":
        raise ValueError("not a GLB container")
    offset = 12
    gltf = None
    bin_chunk = b""
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<I4s", data, offset)
        chunk = data[offset + 8 : offset + 8 + chunk_len]
        if chunk_type == b"JSON":
            gltf = json.loads(chunk.decode("utf-8"))
        elif chunk_type == b"BIN\x00":
            bin_chunk = chunk
        offset += 8 + chunk_len + (-chunk_len) % 4
    if gltf is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf, bin_chunk


class GltfFile:
    def __init__(self, path: Path):
        self.base_dir = path.parent
        raw = path.read_bytes()
        if path.suffix.lower() == ".glb" or raw[:4] == b"glTF":
            self.doc, self._bin = _load_glb(raw)
        else:
            self.doc = json.loads(raw.decode("utf-8"))
            self._bin = b""
        self._buffers = [self._load_buffer(b) for b in self.doc.get("buffers", [])]

    def _load_buffer(self, buf: dict) -> bytes:
        uri = buf.get("uri")
        if uri is None:
            return self._bin
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        return (self.base_dir / uri).read_bytes()

    def buffer_view_bytes(self, view_id: int) -> bytes:
        view = self.doc["bufferViews"][view_id]
        data = self._buffers[view["buffer"]]
        off = view.get("byteOffset", 0)
        return data[off : off + view["byteLength"]]

    def accessor(self, acc_id: int) -> np.ndarray:
        """Decode an accessor to (count, n) float64/int arrays (handles
        byteStride, sparse accessors are not supported)."""
        acc = self.doc["accessors"][acc_id]
        n = _TYPE_COUNTS[acc["type"]]
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        count = acc["count"]
        if "bufferView" not in acc:
            return np.zeros((count, n), dtype)
        view = self.doc["bufferViews"][acc["bufferView"]]
        data = self._buffers[view["buffer"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        row = dtype.itemsize * n
        stride = view.get("byteStride") or row
        end = start + (count - 1) * stride + row
        raw = np.frombuffer(data[start:end], np.uint8)
        if stride == row:
            elems = raw.view(dtype).reshape(count, n).copy()
        else:
            # interleaved vertex buffer: strided row view, then copy
            elems = np.lib.stride_tricks.as_strided(
                raw, shape=(count, row), strides=(stride, 1)
            ).copy().view(dtype).reshape(count, n)
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            elems = elems.astype(np.float32) / float(info.max)
        return elems


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def _write_obj(path: Path, pos, normals, uvs, indices):
    lines = []
    for p in pos:
        lines.append(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}")
    if uvs is not None:
        for t in uvs:
            lines.append(f"vt {t[0]:.9g} {1.0 - t[1]:.9g}")  # glTF v is top-down
    if normals is not None:
        for nrm in normals:
            lines.append(f"vn {nrm[0]:.9g} {nrm[1]:.9g} {nrm[2]:.9g}")
    for a, b, c in indices:
        if uvs is not None and normals is not None:
            lines.append(
                f"f {a+1}/{a+1}/{a+1} {b+1}/{b+1}/{b+1} {c+1}/{c+1}/{c+1}"
            )
        elif normals is not None:
            lines.append(f"f {a+1}//{a+1} {b+1}//{b+1} {c+1}//{c+1}")
        elif uvs is not None:
            lines.append(f"f {a+1}/{a+1} {b+1}/{b+1} {c+1}/{c+1}")
        else:
            lines.append(f"f {a+1} {b+1} {c+1}")
    path.write_text("\n".join(lines) + "\n")


def _extract_texture(gltf: GltfFile, tex_id: int, out_dir: Path, used: dict):
    """Write glTF texture tex_id to a PNG next to the scene; returns the
    relative filename or None."""
    if tex_id in used:
        return used[tex_id]
    tex = gltf.doc["textures"][tex_id]
    img = gltf.doc["images"][tex["source"]]
    name = f"texture_{tex['source']:03d}.png"
    out = out_dir / name
    try:
        if "uri" in img and not img["uri"].startswith("data:"):
            src = gltf.base_dir / img["uri"]
            data = src.read_bytes()
        elif "uri" in img:
            data = base64.b64decode(img["uri"].split(",", 1)[1])
        else:
            data = gltf.buffer_view_bytes(img["bufferView"])
        rgba = imageio.png_rgba8_bytes(data, f"texture {tex_id}")
        imageio.save_png(out, rgba.astype(np.float32) / 255.0)
    except Exception as e:  # noqa: BLE001 — report and fall back to factors
        print(f"warning: could not extract texture {tex_id}: {e}", file=sys.stderr)
        used[tex_id] = None
        return None
    used[tex_id] = name
    return name


def _material_to_surface(gltf: GltfFile, mat_id, out_dir: Path, tex_cache: dict):
    """pbrMetallicRoughness -> Disney surface (+ optional emission), the
    same mapping as export.cpp:141-239. Returns (surface, light_or_None)."""
    if mat_id is None:
        return {"impl": "matte", "prop": {"Kd": {"impl": "constant", "prop": {"v": [0.8, 0.8, 0.8]}}}}, None
    mat = gltf.doc["materials"][mat_id]
    pbr = mat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    prop: dict = {}
    tex_info = pbr.get("baseColorTexture")
    if tex_info is not None:
        fname = _extract_texture(gltf, tex_info["index"], out_dir, tex_cache)
        if fname is not None:
            prop["color"] = {"impl": "image", "prop": {"file": fname, "scale": base[:3]}}
    if "color" not in prop:
        prop["color"] = {"impl": "constant", "prop": {"v": base[:3]}}
    prop["metallic"] = {
        "impl": "constant", "prop": {"v": [float(pbr.get("metallicFactor", 1.0))]}
    }
    prop["roughness"] = {
        "impl": "constant", "prop": {"v": [float(pbr.get("roughnessFactor", 1.0))]}
    }
    nrm = mat.get("normalTexture")
    if nrm is not None:
        fname = _extract_texture(gltf, nrm["index"], out_dir, tex_cache)
        if fname is not None:
            prop["normal_map"] = {"impl": "image", "prop": {"file": fname, "encoding": "linear"}}
    if mat.get("alphaMode") == "BLEND" and base[3] < 1.0:
        prop["alpha"] = {"impl": "constant", "prop": {"v": [float(base[3])]}}
    surface = {"impl": "disney", "prop": prop}

    light = None
    emissive = mat.get("emissiveFactor", [0.0, 0.0, 0.0])
    strength = mat.get("extensions", {}).get(
        "KHR_materials_emissive_strength", {}
    ).get("emissiveStrength", 1.0)
    if max(emissive) > 0.0 or "emissiveTexture" in mat:
        e_prop: dict = {}
        tex_info = mat.get("emissiveTexture")
        if tex_info is not None:
            fname = _extract_texture(gltf, tex_info["index"], out_dir, tex_cache)
            if fname is not None:
                e_prop["emission"] = {
                    "impl": "image",
                    "prop": {"file": fname, "scale": [c * strength for c in (emissive if max(emissive) > 0 else [1, 1, 1])]},
                }
        if "emission" not in e_prop:
            e_prop["emission"] = {
                "impl": "constant",
                "prop": {"v": [c * strength for c in emissive]},
            }
        light = {"impl": "diffuse", "prop": e_prop}
    return surface, light


def convert(input_path: str, output_path: str, spp: int = 256) -> dict:
    src = Path(input_path)
    out_json = Path(output_path)
    out_dir = out_json.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    gltf = GltfFile(src)
    doc = gltf.doc

    # flatten node hierarchy to world transforms
    scene_id = doc.get("scene", 0)
    roots = doc.get("scenes", [{}])[scene_id].get("nodes", [])
    world: list = []  # (node_id, matrix)

    def walk(node_id, parent_m):
        node = doc["nodes"][node_id]
        m = parent_m @ _node_matrix(node)
        world.append((node_id, m))
        for child in node.get("children", []):
            walk(child, m)

    for r in roots:
        walk(r, np.eye(4))

    tex_cache: dict = {}
    surf_cache: dict = {}
    shapes = []
    cameras = []
    mesh_objs: dict = {}  # (mesh_id, prim_id) -> obj filename
    for node_id, m in world:
        node = doc["nodes"][node_id]
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            origin = m[:3, 3]
            front = -m[:3, 2]
            up = m[:3, 1]
            if cam["type"] == "perspective":
                yfov = float(np.rad2deg(cam["perspective"].get("yfov", 0.8)))
                cameras.append({
                    "impl": "pinhole",
                    "prop": {
                        "fov": yfov,
                        "spp": spp,
                        "file": "render.exr",
                        "film": {"impl": "color", "prop": {"resolution": [1280, 720]}},
                        "transform": {
                            "impl": "view",
                            "prop": {
                                "origin": [float(x) for x in origin],
                                "front": [float(x) for x in front],
                                "up": [float(x) for x in up],
                            },
                        },
                    },
                })
            continue
        if "mesh" not in node:
            continue
        mesh = doc["meshes"][node["mesh"]]
        for pi, prim in enumerate(mesh.get("primitives", [])):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            key = (node["mesh"], pi)
            if key not in mesh_objs:
                attrs = prim["attributes"]
                pos = gltf.accessor(attrs["POSITION"]).astype(np.float32)
                normals = (
                    gltf.accessor(attrs["NORMAL"]).astype(np.float32)
                    if "NORMAL" in attrs
                    else None
                )
                uvs = (
                    gltf.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                    if "TEXCOORD_0" in attrs
                    else None
                )
                if "indices" in prim:
                    idx = gltf.accessor(prim["indices"]).astype(np.int64).reshape(-1)
                else:
                    idx = np.arange(len(pos), dtype=np.int64)
                tri = idx.reshape(-1, 3)
                name = f"mesh_{node['mesh']:03d}_{pi}.obj"
                _write_obj(out_dir / name, pos, normals, uvs, tri)
                mesh_objs[key] = name

            mat_id = prim.get("material")
            if mat_id not in surf_cache:
                surf_cache[mat_id] = _material_to_surface(
                    gltf, mat_id, out_dir, tex_cache
                )
            surface, light = surf_cache[mat_id]
            shape_prop = {
                "file": mesh_objs[key],
                "surface": surface,
                "transform": {
                    "impl": "matrix",
                    "prop": {"m": [float(x) for x in m.reshape(-1)]},
                },
            }
            if light is not None:
                shape_prop["light"] = light
            shapes.append({"impl": "mesh", "prop": shape_prop})

    if not cameras:
        cameras.append({
            "impl": "pinhole",
            "prop": {
                "fov": 40.0,
                "spp": spp,
                "file": "render.exr",
                "film": {"impl": "color", "prop": {"resolution": [1280, 720]}},
                "transform": {
                    "impl": "view",
                    "prop": {"origin": [0, 1, 3], "front": [0, -0.25, -1]},
                },
            },
        })
    scene = {
        "render": {
            "cameras": cameras,
            "integrator": {"impl": "megapath", "prop": {"depth": 8}},
            "shapes": shapes,
        }
    }
    out_json.write_text(json.dumps(scene, indent=2))
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input", help=".gltf or .glb file")
    ap.add_argument("-o", "--output", default="scene.json")
    ap.add_argument("--spp", type=int, default=256)
    args = ap.parse_args(argv)
    scene = convert(args.input, args.output, args.spp)
    n = len(scene["render"]["shapes"])
    print(f"wrote {args.output} ({n} shape instances)")


if __name__ == "__main__":
    main()
