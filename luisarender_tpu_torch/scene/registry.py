"""Plugin registry: category -> impl name -> node class.

Counterpart of luisarender_tpu/scene/registry.py, and separate from it: the
port's plugins register here and never in the JAX package's registry.
Importing luisarender_tpu_torch registers every plugin the port has. A scene
that names a plugin of the reference that the port does not have yet fails
with NotImplementedError naming it.
"""

from __future__ import annotations

from .node import SceneNodeTag

_REGISTRY: dict[SceneNodeTag, dict[str, type]] = {tag: {} for tag in SceneNodeTag}


def register(tag: SceneNodeTag, *names: str):
    """Class decorator registering a node implementation under one or more
    case-insensitive impl names."""

    def deco(cls):
        for name in names:
            key = name.lower()
            existing = _REGISTRY[tag].get(key)
            if existing is not None and existing is not cls:
                raise RuntimeError(
                    f"duplicate plugin registration: {tag.value}::{name}"
                )
            _REGISTRY[tag][key] = cls
        cls.scene_node_tag = tag
        cls.impl_names = tuple(n.lower() for n in names)
        return cls

    return deco


def lookup(tag: SceneNodeTag, impl_type: str) -> type:
    cls = _REGISTRY[tag].get(impl_type.lower())
    if cls is None:
        available = sorted(_REGISTRY[tag])
        raise NotImplementedError(
            f"{tag.value} plugin '{impl_type}' is not supported by "
            f"luisarender_tpu_torch yet; available: {available}"
        )
    return cls


def registered(tag: SceneNodeTag) -> list:
    """The distinct classes registered under a category."""
    return list(dict.fromkeys(_REGISTRY[tag].values()))
