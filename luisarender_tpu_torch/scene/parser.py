"""Scene description parser: the JSON front-end.

Counterpart of luisarender_tpu/scene/parser.py: JSON with `@name`
references, inline internal nodes, `import` lists and a singleton root node
named "render", collected into a global node table. The text (`.luisa`)
format goes to scene/text_parser.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from .node import SceneNodeDesc, SceneNodeError, SceneNodeTag, parse_scene_node_tag

ROOT_NODE_IDENTIFIER = "render"


class SceneDesc:
    """Global node table + singleton root (sdl/scene_desc.h:34-52)."""

    def __init__(self):
        self.nodes: dict[str, SceneNodeDesc] = {}
        self.root: Optional[SceneNodeDesc] = None
        self._internal_counter = 0

    def reference(self, identifier: str) -> SceneNodeDesc:
        """Get or forward-declare a node by identifier."""
        if identifier == ROOT_NODE_IDENTIFIER:
            raise SceneNodeError("cannot reference the root node")
        node = self.nodes.get(identifier)
        if node is None:
            node = SceneNodeDesc(identifier=identifier, tag=SceneNodeTag.INTERNAL)
            self.nodes[identifier] = node
        return node

    def define(self, identifier, tag, impl_type, source="<unknown>", base=None):
        node = self.nodes.get(identifier)
        if node is None:
            node = SceneNodeDesc(identifier=identifier, tag=tag, source=source)
            self.nodes[identifier] = node
        elif node.is_defined:
            raise SceneNodeError(f"node '{identifier}' is defined twice")
        node.tag = tag
        node.impl_type = impl_type
        node.base = base
        node.source = source
        return node

    def define_internal(self, impl_type, source="<unknown>", base=None):
        self._internal_counter += 1
        node = SceneNodeDesc(
            identifier=f"$internal{self._internal_counter}",
            tag=SceneNodeTag.INTERNAL,
            impl_type=impl_type,
            base=base,
            source=source,
        )
        return node

    def define_root(self, source="<unknown>"):
        if self.root is not None and self.root.is_defined:
            raise SceneNodeError("root node is defined twice")
        self.root = SceneNodeDesc(
            identifier=ROOT_NODE_IDENTIFIER,
            tag=SceneNodeTag.ROOT,
            impl_type="__root__",
            source=source,
        )
        return self.root

    def validate(self):
        if self.root is None:
            raise SceneNodeError("scene has no 'render' root node")
        for name, node in self.nodes.items():
            if not node.is_defined:
                raise SceneNodeError(f"node '{name}' is referenced but never defined")


def parse_scene_file(path, macros: Optional[dict[str, str]] = None) -> SceneDesc:
    """Entry point mirroring SceneParser::parse (sdl/scene_parser.h:29-60)."""
    path = Path(path)
    desc = SceneDesc()
    if path.suffix.lower() in (".json", ".luisa_render", ".lr"):
        _parse_json_file(desc, path)
    elif path.suffix.lower() == ".luisa":
        from .text_parser import parse_text_file

        parse_text_file(desc, path, macros or {})
    else:
        raise SceneNodeError(f"unknown scene file format: {path}")
    desc.validate()
    return desc


def parse_scene_dict(data: dict, base_dir=".") -> SceneDesc:
    """Parse an in-memory dict in the JSON SDL schema (for tests / Python API)."""
    desc = SceneDesc()
    # encode base_dir into the source string so relative "file" properties
    # resolve against it (Path(source).parent == base_dir)
    _parse_root(desc, data, Path(base_dir), source=str(Path(base_dir) / "<dict>"))
    desc.validate()
    return desc


def _parse_json_file(desc: SceneDesc, path: Path):
    with open(path) as f:
        # The reference enables nlohmann's ignore-comments mode; strip // lines.
        text = "\n".join(
            line for line in f.read().splitlines() if not line.lstrip().startswith("//")
        )
    root = json.loads(text)
    _parse_root(desc, root, path.parent, source=str(path))


def _parse_root(desc: SceneDesc, root: dict, base_dir: Path, source: str):
    if "import" in root:
        imports = root["import"]
        if isinstance(imports, str):
            imports = [imports]
        for file_name in imports:
            p = Path(file_name)
            if not p.is_absolute():
                p = base_dir / p
            _parse_json_file(desc, p)
    for key, value in root.items():
        if key == "import":
            continue
        if key == ROOT_NODE_IDENTIFIER:
            node = desc.define_root(source)
            _parse_node(desc, node, value.get("prop", value), source)
            # allow {"type": "...", "impl": "...", "prop": {...}} or bare props
            continue
        if not isinstance(value, dict):
            raise SceneNodeError(f"invalid global node '{key}': {value!r}")
        if "type" not in value:
            raise SceneNodeError(f"missing node type in global node '{key}'")
        tag = parse_scene_node_tag(value["type"])
        if tag is None or tag in (SceneNodeTag.ROOT, SceneNodeTag.INTERNAL):
            raise SceneNodeError(f"unknown scene node type '{value['type']}' in '{key}'")
        impl = value.get("impl")
        if impl is None:
            raise SceneNodeError(f"missing node impl in global node '{key}'")
        base = _reference(desc, value["base"]) if "base" in value else None
        node = desc.define(key, tag, impl, source, base)
        _parse_node(desc, node, value.get("prop", {}), source)


def _reference(desc: SceneDesc, name: str) -> SceneNodeDesc:
    if not name.startswith("@"):
        raise SceneNodeError(f"invalid reference name '{name}' (must start with '@')")
    return desc.reference(name[1:])


def _parse_internal(desc: SceneDesc, key: str, value: dict, source: str):
    for k in value:
        if k not in ("type", "impl", "base", "prop"):
            raise SceneNodeError(f"invalid internal node property '{key}.{k}'")
    base = _reference(desc, value["base"]) if "base" in value else None
    node = desc.define_internal(value["impl"], source, base)
    _parse_node(desc, node, value.get("prop", {}), source)
    return node


def _parse_node(desc: SceneDesc, node: SceneNodeDesc, props: dict, source: str):
    for key, value in props.items():
        if isinstance(value, str):
            if value.startswith("@"):
                node.properties[key] = _reference(desc, value)
            else:
                node.properties[key] = value
        elif isinstance(value, (bool, int, float)):
            node.properties[key] = value
        elif isinstance(value, list):
            if not value:
                raise SceneNodeError(
                    f"empty array is not allowed in '{node.identifier}'.'{key}'"
                )
            first = value[0]
            if isinstance(first, str) and first.startswith("@"):
                node.properties[key] = [
                    _reference(desc, v)
                    if isinstance(v, str)
                    else _parse_internal(desc, key, v, source)
                    for v in value
                ]
            elif isinstance(first, str):
                node.properties[key] = [str(v) for v in value]
            elif isinstance(first, (bool, int, float)):
                node.properties[key] = list(value)
            else:
                node.properties[key] = [
                    _reference(desc, v)
                    if isinstance(v, str)
                    else _parse_internal(desc, key, v, source)
                    for v in value
                ]
        elif isinstance(value, dict):
            node.properties[key] = _parse_internal(desc, key, value, source)
        elif value is None:
            continue
        else:
            raise SceneNodeError(
                f"invalid property value '{node.identifier}'.'{key}': {value!r}"
            )
