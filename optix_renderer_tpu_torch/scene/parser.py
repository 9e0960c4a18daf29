"""XML scene parser: same tag grammar as the reference.

Counterpart of `loadFromXML` (src/utils/parser.cpp:28-378). Parses the Nori XML
dialect — object tags (scene/shape/bsdf/emitter/...), property tags
(float/integer/.../color/point/vector), and `<transform>` blocks accumulating
translate/rotate/scale/matrix/lookat ops — into a lightweight `SceneNode` tree.
The tree is *configuration*, not render state: `optix_renderer_tpu_torch.scene.build`
lowers it to flat tensor tables (the analog of the reference's two-tree
cloneAndInit/update protocol, object.h:142-176: here "update" = rebuild).
A copy of `optix_renderer_tpu/scene/parser.py`, which cannot be imported
without JAX.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from optix_renderer_tpu_torch.core import transform as tf
from optix_renderer_tpu_torch.scene.proplist import PropertyList

# Object-class tags (parser.cpp:100-116)
OBJECT_TAGS = {
    "scene", "shape", "texture", "volume", "bsdf", "phase", "emitter", "medium",
    "camera", "integrator", "sampler", "pxsampler", "denoiser", "test", "rfilter",
    "renderer",
}
# Property tags (parser.cpp:117-130)
PROPERTY_TAGS = {
    "boolean", "integer", "float", "string", "point", "vector", "color",
    "transform", "translate", "matrix", "rotate", "scale", "lookat",
}
TRANSFORM_OPS = {"translate", "rotate", "scale", "matrix", "lookat"}


@dataclass
class SceneNode:
    """One parsed object: class tag, plugin type, properties, children."""

    tag: str  # e.g. "shape"
    type: str  # e.g. "obj"
    name: str = ""
    props: PropertyList = field(default_factory=PropertyList)
    children: list["SceneNode"] = field(default_factory=list)
    origin: str = ""  # source file, for resolving relative resource paths

    def child(self, tag: str, type_: str | None = None) -> "SceneNode | None":
        for c in self.children:
            if c.tag == tag and (type_ is None or c.type == type_):
                return c
        return None

    def children_of(self, tag: str) -> list["SceneNode"]:
        return [c for c in self.children if c.tag == tag]


def _tokenize(s: str) -> list[str]:
    """Split on commas and/or whitespace (reference tokenize, common.cpp:141)."""
    return [t for t in re.split(r"[,\s]+", s.strip()) if t]


def _to_vec(s: str) -> np.ndarray:
    return np.array([float(t) for t in _tokenize(s)], np.float64)


def _parse_transform(node: ET.Element) -> np.ndarray:
    """Accumulate transform ops left-multiplied, as parser.cpp:302-360."""
    m = tf.identity()
    for ch in node:
        op = ch.tag
        if op == "translate":
            m = tf.translate(_to_vec(ch.get("value"))) @ m
        elif op == "scale":
            m = tf.scale(_to_vec(ch.get("value"))) @ m
        elif op == "rotate":
            m = tf.rotate(_to_vec(ch.get("axis")), float(ch.get("angle"))) @ m
        elif op == "matrix":
            vals = _to_vec(ch.get("value"))
            if vals.size != 16:
                raise ValueError("Expected 16 values in <matrix>")
            m = vals.reshape(4, 4) @ m
        elif op == "lookat":
            m = (
                tf.lookat(
                    _to_vec(ch.get("origin")),
                    _to_vec(ch.get("target")),
                    _to_vec(ch.get("up")),
                )
                @ m
            )
        else:
            raise ValueError(
                f"transform nodes can only contain transform ops, got <{op}>"
            )
    return m


def _parse_node(node: ET.Element, origin: str) -> SceneNode:
    tag = node.tag
    if tag not in OBJECT_TAGS:
        raise ValueError(f"unexpected tag <{tag}> where an object was expected")
    type_ = node.get("type", "scene" if tag == "scene" else "")
    out = SceneNode(
        tag=tag, type=type_, name=node.get("name", ""), origin=origin
    )
    for ch in node:
        ctag = ch.tag
        if ctag in OBJECT_TAGS:
            out.children.append(_parse_node(ch, origin))
        elif ctag == "transform":
            out.props.set(ch.get("name"), _parse_transform(ch))
        elif ctag in TRANSFORM_OPS:
            raise ValueError(f"<{ctag}> outside a <transform> block")
        elif ctag in PROPERTY_TAGS:
            name = ch.get("name")
            value = ch.get("value")
            if ctag == "string":
                out.props.set(name, value)
            elif ctag == "float":
                out.props.set(name, float(value))
            elif ctag == "integer":
                out.props.set(name, int(value))
            elif ctag == "boolean":
                out.props.set(name, value.strip().lower() == "true")
            elif ctag in ("point", "vector", "color"):
                out.props.set(name, _to_vec(value).astype(np.float32))
            else:
                raise ValueError(f"unhandled property <{ctag}>")
        else:
            raise ValueError(f"unexpected tag <{ctag}>")
    return out


def load_from_xml(filename: str | Path) -> SceneNode:
    """Parse a scene XML file → SceneNode tree (parser.cpp:28 contract)."""
    filename = Path(filename)
    tree = ET.parse(str(filename))
    root = tree.getroot()
    return _parse_node(root, origin=str(filename.parent))


def load_from_string(text: str, origin: str = ".") -> SceneNode:
    return _parse_node(ET.fromstring(text), origin=origin)
