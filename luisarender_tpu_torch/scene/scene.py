"""Scene: typed node loading and the scene graph root.

Counterpart of luisarender_tpu/scene/scene.py (LuisaRender's
base/scene.cpp Scene::create and its typed load_<category> family). Node
instances are deduplicated by descriptor identity. Plugins come from this
package's own registry (scene/registry.py).
"""

from __future__ import annotations

from typing import Optional

from . import registry
from .node import SceneNodeDesc, SceneNodeError, SceneNodeTag
from .parser import SceneDesc, parse_scene_dict, parse_scene_file


class SceneNode:
    """Base class of all typed scene nodes (base/scene_node.h)."""

    scene_node_tag: SceneNodeTag = SceneNodeTag.INTERNAL
    impl_names: tuple = ()

    def __init__(self, scene: "Scene", desc: SceneNodeDesc):
        self.scene = scene
        self.desc = desc

    @property
    def impl_type(self) -> str:
        return type(self).impl_names[0] if type(self).impl_names else ""

    def __repr__(self):
        return f"<{type(self).__name__} '{self.desc.identifier}'>"


class Scene:
    """Materialized scene graph with node dedup and global settings."""

    def __init__(self):
        self._nodes: dict[int, SceneNode] = {}  # id(desc) -> node
        self.accel: str = "auto"
        self.spectrum = None
        self.integrator = None
        self.environment = None
        self.environment_medium = None
        self.cameras: list = []
        self.shapes: list = []

    # --- generic loading with dedup (scene.cpp:79-131) ---
    def load_node(self, tag: SceneNodeTag, desc: Optional[SceneNodeDesc]):
        if desc is None:
            return None
        if not desc.is_defined:
            raise SceneNodeError(
                f"node '{desc.identifier}' is referenced but never defined"
            )
        cached = self._nodes.get(id(desc))
        if cached is not None:
            if desc.tag not in (tag, SceneNodeTag.INTERNAL) or (
                cached.scene_node_tag is not tag
            ):
                raise SceneNodeError(
                    f"node '{desc.identifier}' used with conflicting tags"
                )
            return cached
        if desc.tag not in (tag, SceneNodeTag.INTERNAL):
            raise SceneNodeError(
                f"node '{desc.identifier}' has tag {desc.tag.value}, expected {tag.value}"
            )
        cls = registry.lookup(tag, desc.impl_type)
        node = cls(self, desc)
        self._nodes[id(desc)] = node
        return node

    # --- typed loaders (scene.cpp:137-199) ---
    def load_camera(self, desc):
        return self.load_node(SceneNodeTag.CAMERA, desc)

    def load_shape(self, desc):
        return self.load_node(SceneNodeTag.SHAPE, desc)

    def load_surface(self, desc):
        return self.load_node(SceneNodeTag.SURFACE, desc)

    def load_light(self, desc):
        return self.load_node(SceneNodeTag.LIGHT, desc)

    def load_transform(self, desc):
        return self.load_node(SceneNodeTag.TRANSFORM, desc)

    def load_film(self, desc):
        return self.load_node(SceneNodeTag.FILM, desc)

    def load_filter(self, desc):
        return self.load_node(SceneNodeTag.FILTER, desc)

    def load_sampler(self, desc):
        return self.load_node(SceneNodeTag.SAMPLER, desc)

    def load_integrator(self, desc):
        return self.load_node(SceneNodeTag.INTEGRATOR, desc)

    def load_light_sampler(self, desc):
        return self.load_node(SceneNodeTag.LIGHT_SAMPLER, desc)

    def load_environment(self, desc):
        return self.load_node(SceneNodeTag.ENVIRONMENT, desc)

    def load_texture(self, desc):
        return self.load_node(SceneNodeTag.TEXTURE, desc)

    def load_texture_mapping(self, desc):
        return self.load_node(SceneNodeTag.TEXTURE_MAPPING, desc)

    def load_spectrum(self, desc):
        return self.load_node(SceneNodeTag.SPECTRUM, desc)

    def load_medium(self, desc):
        return self.load_node(SceneNodeTag.MEDIUM, desc)

    def load_phase_function(self, desc):
        return self.load_node(SceneNodeTag.PHASE_FUNCTION, desc)

    # --- creation (scene.cpp:201-233) ---
    @classmethod
    def create(cls, desc: SceneDesc) -> "Scene":
        root = desc.root
        if root is None or not root.is_defined:
            raise SceneNodeError("root node is not defined in the scene description")
        scene = cls()
        # acceleration-structure mode: "flat" (instances flattened to world
        # space), "twolevel" (a TLAS over shared per-mesh BLASes) or "auto"
        # (scene/compiler.py choose_two_level)
        scene.accel = root.string("accel", "auto").lower()
        spectrum_desc = root.node("spectrum")
        if spectrum_desc is None:
            spectrum_desc = SceneNodeDesc(
                identifier="$default_spectrum",
                tag=SceneNodeTag.SPECTRUM,
                impl_type="srgb",
            )
        scene.spectrum = scene.load_spectrum(spectrum_desc)
        integrator_desc = root.node("integrator")
        if integrator_desc is None:
            raise SceneNodeError("scene has no integrator")
        scene.integrator = scene.load_integrator(integrator_desc)
        scene.environment = scene.load_environment(root.node("environment"))
        scene.environment_medium = scene.load_medium(root.node("environment_medium"))
        scene.cameras = [scene.load_camera(c) for c in root.node_list("cameras")]
        scene.shapes = [scene.load_shape(s) for s in root.node_list("shapes")]
        if not scene.cameras:
            raise SceneNodeError("scene has no cameras")
        return scene

    @classmethod
    def from_file(cls, path, macros=None) -> "Scene":
        return cls.create(parse_scene_file(path, macros))

    @classmethod
    def from_dict(cls, data, base_dir=".") -> "Scene":
        return cls.create(parse_scene_dict(data, base_dir))
