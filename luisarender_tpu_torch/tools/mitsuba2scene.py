"""Mitsuba XML scene -> luisarender_tpu_torch scene JSON.

Covers the subset the reference converts through its
tools/mitsuba2tungsten.py + tools/tungsten2luisa.py chain (shapes
obj/rectangle/cube/sphere, bsdfs diffuse/conductor/dielectric/plastic with
rough variants and twosided/bumpmap/mask wrappers, area/constant/envmap
emitters, perspective sensor, path integrator, $defaults and <ref id>s,
<include>s) — directly, without the Tungsten intermediate. Mitsuba 0.6 and
2.x documents both parse (the property grammar is shared).

Usage: python -m luisarender_tpu_torch.tools.mitsuba2scene scene.xml [out.json]
"""

from __future__ import annotations

import json
import math
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np


def _split_nums(s):
    return [float(v) for v in s.replace(",", " ").split()]


class Converter:
    def __init__(self, scene_dir):
        self.scene_dir = scene_dir
        self.defaults = {}
        self.named_bsdfs = {}
        self.shapes = []
        self.camera = None
        self.environment = None
        self.integrator = {"impl": "megapath", "prop": {"depth": 16}}
        self.spp = 64
        self.warnings = []

    def warn(self, msg):
        self.warnings.append(msg)
        print(f"[mitsuba2scene] warning: {msg}", file=sys.stderr)

    # ---- property helpers -------------------------------------------------
    def _subst(self, value: str) -> str:
        if value.startswith("$"):
            return str(self.defaults.get(value[1:], value))
        return value

    def props(self, elem) -> dict:
        """Collect child <float|integer|string|boolean|rgb|spectrum|texture|
        transform> properties into a dict."""
        out = {}
        for ch in elem:
            name = ch.attrib.get("name")
            if ch.tag == "float":
                out[name] = float(self._subst(ch.attrib["value"]))
            elif ch.tag == "integer":
                out[name] = int(float(self._subst(ch.attrib["value"])))
            elif ch.tag == "boolean":
                out[name] = self._subst(ch.attrib["value"]).lower() == "true"
            elif ch.tag == "string":
                out[name] = self._subst(ch.attrib["value"])
            elif ch.tag in ("rgb", "color"):
                v = _split_nums(self._subst(ch.attrib["value"]))
                out[name] = v * 3 if len(v) == 1 else v
            elif ch.tag == "spectrum":
                v = _split_nums(self._subst(ch.attrib["value"]))
                # uniform spectra only; sampled spectra average
                out[name] = [float(np.mean(v))] * 3
            elif ch.tag == "texture":
                out[name] = self.texture(ch)
            elif ch.tag == "transform":
                out[name] = self.transform_matrix(ch)
            elif ch.tag == "point":
                out[name] = [
                    float(self._subst(ch.attrib.get(a, "0")))
                    for a in ("x", "y", "z")
                ]
        return out

    # ---- transforms -------------------------------------------------------
    def transform_matrix(self, elem) -> np.ndarray:
        """Compose a <transform> element into a 4x4 row-major matrix
        (operations apply top-to-bottom, each LEFT-multiplying)."""
        m = np.eye(4)
        for op in elem:
            t = np.eye(4)
            if op.tag == "matrix":
                vals = _split_nums(self._subst(op.attrib["value"]))
                if len(vals) == 16:
                    t = np.asarray(vals).reshape(4, 4)
                elif len(vals) == 9:
                    t[:3, :3] = np.asarray(vals).reshape(3, 3)
            elif op.tag == "translate":
                t[:3, 3] = [
                    float(self._subst(op.attrib.get(a, "0")))
                    for a in ("x", "y", "z")
                ]
            elif op.tag == "scale":
                if "value" in op.attrib:
                    v = _split_nums(self._subst(op.attrib["value"]))
                    v = v * 3 if len(v) == 1 else v
                else:
                    v = [
                        float(self._subst(op.attrib.get(a, "1")))
                        for a in ("x", "y", "z")
                    ]
                t = np.diag([*v, 1.0])
            elif op.tag == "rotate":
                axis = np.asarray(
                    [
                        float(self._subst(op.attrib.get(a, "0")))
                        for a in ("x", "y", "z")
                    ]
                )
                ang = math.radians(float(self._subst(op.attrib["angle"])))
                axis = axis / max(np.linalg.norm(axis), 1e-12)
                c, s = math.cos(ang), math.sin(ang)
                x, y, z = axis
                k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
                t[:3, :3] = (
                    np.eye(3) * c + (1 - c) * np.outer(axis, axis) + s * k
                )
            elif op.tag in ("lookat", "look_at"):
                o = np.asarray(_split_nums(self._subst(op.attrib["origin"])))
                tgt = np.asarray(_split_nums(self._subst(op.attrib["target"])))
                up = np.asarray(
                    _split_nums(self._subst(op.attrib.get("up", "0,1,0")))
                )
                f = tgt - o
                f = f / max(np.linalg.norm(f), 1e-12)
                r = np.cross(up, f)  # mitsuba camera: +x left, +z forward
                r = r / max(np.linalg.norm(r), 1e-12)
                u = np.cross(f, r)
                t[:3, 0] = r
                t[:3, 1] = u
                t[:3, 2] = f
                t[:3, 3] = o
            m = t @ m
        return m

    def transform_node(self, m: np.ndarray) -> dict:
        return {
            "impl": "matrix",
            "prop": {"m": [float(v) for v in np.asarray(m).reshape(-1)]},
        }

    # ---- textures ---------------------------------------------------------
    def texture(self, elem) -> dict:
        t = elem.attrib.get("type")
        p = self.props(elem)
        if t == "bitmap":
            f = p.get("filename", "")
            return {
                "impl": "image",
                "prop": {
                    "file": os.path.join(self.scene_dir, f),
                    **(
                        {"uv_scale": [p["uscale"], p["vscale"]]}
                        if "uscale" in p
                        else {}
                    ),
                },
            }
        if t == "checkerboard":
            return {
                "impl": "checkerboard",
                "prop": {
                    "on": self.const_tex(p.get("color0", [0.4] * 3)),
                    "off": self.const_tex(p.get("color1", [0.2] * 3)),
                },
            }
        self.warn(f"texture type '{t}' unsupported; using constant 0.5")
        return self.const_tex([0.5, 0.5, 0.5])

    @staticmethod
    def const_tex(v):
        if isinstance(v, dict):
            return v
        if isinstance(v, (int, float)):
            v = [float(v)] * 3
        return {"impl": "constant", "prop": {"v": [float(x) for x in v]}}

    # ---- bsdfs ------------------------------------------------------------
    def bsdf(self, elem, two_sided=False) -> dict:
        t = elem.attrib.get("type")
        p = self.props(elem)
        inner = [c for c in elem if c.tag == "bsdf"]
        if t == "twosided":
            return self.bsdf(inner[0], two_sided=True)
        if t in ("bumpmap", "normalmap"):
            base = self.bsdf(inner[0], two_sided)
            tex = next((c for c in elem if c.tag == "texture"), None)
            if t == "normalmap" and tex is not None:
                base["prop"]["normal_map"] = self.texture(tex)
            else:
                self.warn("bumpmap height texture dropped (normal maps only)")
            return base
        if t == "mask":
            base = self.bsdf(inner[0], two_sided)
            if "opacity" in p:
                base["prop"]["alpha"] = self.const_tex(p["opacity"])
            return base

        def rough(default=0.0):
            a = p.get("alpha", default)
            # mitsuba alpha IS the GGX alpha; our surfaces remap roughness
            # by default, so pass sqrt(alpha) with remap enabled == alpha
            return self.const_tex([math.sqrt(max(float(a), 0.0))])

        prop = {}
        if two_sided:
            prop["two_sided"] = True
        if t == "diffuse":
            prop["Kd"] = self.const_tex(p.get("reflectance", [0.5] * 3))
            out = {"impl": "matte", "prop": prop}
        elif t in ("roughconductor", "conductor"):
            mat = p.get("material", "Cu")
            prop["material"] = mat if isinstance(mat, str) else "Cu"
            if "eta" in p and isinstance(p["eta"], list):
                prop.pop("material")
                prop["n"] = p["eta"]
                prop["k"] = p.get("k", [3.0] * 3)
            prop["roughness"] = rough(0.1 if t == "roughconductor" else 0.0)
            out = {"impl": "metal", "prop": prop}
        elif t in ("dielectric", "roughdielectric", "thindielectric"):
            prop["eta"] = self.const_tex([float(p.get("int_ior", 1.5046))])
            if t == "roughdielectric":
                prop["roughness"] = rough(0.1)
            out = {"impl": "glass", "prop": prop}
        elif t in ("plastic", "roughplastic"):
            prop["Kd"] = self.const_tex(
                p.get("diffuse_reflectance", [0.5] * 3)
            )
            prop["eta"] = self.const_tex([float(p.get("int_ior", 1.49))])
            if t == "roughplastic":
                prop["roughness"] = rough(0.1)
            out = {"impl": "plastic", "prop": prop}
        else:
            self.warn(f"bsdf type '{t}' unsupported; using matte 0.5")
            prop["Kd"] = self.const_tex([0.5] * 3)
            out = {"impl": "matte", "prop": prop}
        return out

    def resolve_bsdf(self, shape_elem) -> dict | None:
        for c in shape_elem:
            if c.tag == "ref":
                rid = c.attrib.get("id")
                if rid in self.named_bsdfs:
                    return self.named_bsdfs[rid]
                self.warn(f"unresolved bsdf ref '{rid}'")
            elif c.tag == "bsdf":
                return self.bsdf(c)
        return None

    # ---- shapes -----------------------------------------------------------
    def shape(self, elem):
        t = elem.attrib.get("type")
        p = self.props(elem)
        m = p.get("to_world")
        if m is None:
            m = np.eye(4)
        surface = self.resolve_bsdf(elem)
        light = None
        for c in elem:
            if c.tag == "emitter" and c.attrib.get("type") == "area":
                ep = self.props(c)
                light = {
                    "impl": "diffuse",
                    "prop": {
                        "emission": self.const_tex(
                            ep.get("radiance", [1.0] * 3)
                        )
                    },
                }
        prop = {}
        if surface is not None:
            prop["surface"] = surface
        elif light is not None:
            prop["surface"] = {"impl": "null", "prop": {}}
        if light is not None:
            prop["light"] = light

        if t == "obj":
            prop["file"] = os.path.join(self.scene_dir, p.get("filename", ""))
            prop["transform"] = self.transform_node(m)
            if p.get("face_normals"):
                prop["flat_normals"] = True
            self.shapes.append({"impl": "mesh", "prop": prop})
        elif t == "rectangle":
            # unit rectangle [-1,1]^2 in the xy-plane, +z normal
            quad = np.array(
                [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64
            )
            w = (m[:3, :3] @ quad.T).T + m[:3, 3]
            prop["positions"] = [float(v) for v in w.reshape(-1)]
            prop["indices"] = [0, 1, 2, 0, 2, 3]
            self.shapes.append({"impl": "inlinemesh", "prop": prop})
        elif t == "cube":
            v = np.array(
                [
                    [x, y, z]
                    for x in (-1, 1)
                    for y in (-1, 1)
                    for z in (-1, 1)
                ],
                np.float64,
            )
            w = (m[:3, :3] @ v.T).T + m[:3, 3]
            faces = [
                (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
            ]
            idx = []
            for a, b, c2, d in faces:
                idx += [a, b, c2, a, c2, d]
            prop["positions"] = [float(x) for x in w.reshape(-1)]
            prop["indices"] = idx
            self.shapes.append({"impl": "inlinemesh", "prop": prop})
        elif t == "sphere":
            center = p.get("center", [0.0, 0.0, 0.0])
            radius = float(p.get("radius", 1.0))
            sm = np.eye(4)
            sm[:3, :3] *= radius
            sm[:3, 3] = center
            prop["subdivision"] = 5
            prop["transform"] = self.transform_node(m @ sm)
            self.shapes.append({"impl": "sphere", "prop": prop})
        else:
            self.warn(f"shape type '{t}' unsupported; skipped")

    # ---- emitters (scene-level) ------------------------------------------
    def emitter(self, elem):
        t = elem.attrib.get("type")
        p = self.props(elem)
        if t == "constant":
            self.environment = {
                "impl": "spherical",
                "prop": {
                    "emission": self.const_tex(p.get("radiance", [1.0] * 3))
                },
            }
        elif t == "envmap":
            prop = {
                "emission": {
                    "impl": "image",
                    "prop": {
                        "file": os.path.join(
                            self.scene_dir, p.get("filename", "")
                        ),
                        "encoding": "linear",
                    },
                }
            }
            if float(p.get("scale", 1.0)) != 1.0:
                prop["scale"] = float(p["scale"])
            if "to_world" in p:
                prop["transform"] = self.transform_node(p["to_world"])
            self.environment = {"impl": "spherical", "prop": prop}
        elif t in ("sunsky", "sky"):
            self.environment = {
                "impl": "spherical",
                "prop": {
                    "emission": {"impl": "nishita_sky", "prop": {}},
                },
            }
        else:
            self.warn(f"emitter type '{t}' unsupported; skipped")

    # ---- sensor -----------------------------------------------------------
    def sensor(self, elem):
        p = self.props(elem)
        res = [768, 576]
        for c in elem:
            if c.tag == "film":
                fp = self.props(c)
                res = [int(fp.get("width", 768)), int(fp.get("height", 576))]
            elif c.tag == "sampler":
                sp = self.props(c)
                self.spp = int(sp.get("sample_count", self.spp))
        fov = float(p.get("fov", 45.0))
        axis = p.get("fov_axis", "x")
        if axis == "x":  # ours is vertical
            fov = math.degrees(
                2.0 * math.atan(math.tan(math.radians(fov) / 2.0) * res[1] / res[0])
            )
        m = p.get("to_world", np.eye(4))
        pos = m[:3, 3]
        front = m[:3, 2]  # mitsuba camera looks along +z
        up = m[:3, 1]
        self.camera = {
            "impl": "pinhole",
            "prop": {
                "fov": fov,
                "spp": self.spp,
                "film": {"impl": "color", "prop": {"resolution": res}},
                "filter": {"impl": "box", "prop": {}},
                "transform": {
                    "impl": "view",
                    "prop": {
                        "origin": [float(v) for v in pos],
                        "front": [float(v) for v in front],
                        "up": [float(v) for v in up],
                    },
                },
                "file": "mitsuba.exr",
            },
        }

    # ---- document ---------------------------------------------------------
    def run(self, root):
        for ch in root:
            if ch.tag == "default":
                self.defaults[ch.attrib["name"]] = ch.attrib["value"]
            elif ch.tag == "integrator":
                it = ch.attrib.get("type", "path")
                p = self.props(ch)
                depth = int(p.get("max_depth", p.get("maxDepth", -1)))
                if depth <= 0:
                    depth = 16
                impl = "megavpt" if "vol" in it else "megapath"
                self.integrator = {"impl": impl, "prop": {"depth": depth}}
            elif ch.tag == "sensor":
                self.sensor(ch)
            elif ch.tag == "bsdf":
                bid = ch.attrib.get("id")
                node = self.bsdf(ch)
                if bid:
                    self.named_bsdfs[bid] = node
            elif ch.tag == "shape":
                self.shape(ch)
            elif ch.tag == "emitter":
                self.emitter(ch)
            elif ch.tag == "include":
                f = os.path.join(self.scene_dir, ch.attrib["filename"])
                self.run(ET.parse(f).getroot())

    def document(self) -> dict:
        # apply spp chosen by the sampler (sensor may parse before sampler)
        if self.camera is not None:
            self.camera["prop"]["spp"] = self.spp
        render = {
            "cameras": [self.camera] if self.camera else [],
            "integrator": self.integrator,
            "shapes": self.shapes,
        }
        if self.environment is not None:
            render["environment"] = self.environment
        return {"render": render}


def convert(xml_path: str, out_path: str | None = None) -> dict:
    root = ET.parse(xml_path).getroot()
    conv = Converter(os.path.dirname(os.path.abspath(xml_path)))
    conv.run(root)
    doc = conv.document()
    if out_path:
        json.dump(doc, open(out_path, "w"), indent=1)
    return doc


def main(argv=None):
    argv = argv or sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    out = argv[1] if len(argv) > 1 else os.path.splitext(argv[0])[0] + ".json"
    convert(argv[0], out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
