"""Typed property bag parsed from XML attributes.

Counterpart of the reference `PropertyList` (include/nori/proplist.h:41-113):
typed get/set with defaults. Values are plain Python / numpy — this exists at
scene-build time only, never inside jit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class PropertyList:
    props: dict[str, Any] = field(default_factory=dict)

    def has(self, name: str) -> bool:
        return name in self.props

    def _get(self, name: str, default, kind: str):
        if name not in self.props:
            if default is _REQUIRED:
                raise KeyError(f"Property '{name}' is missing (required {kind})")
            return default
        return self.props[name]

    def get_boolean(self, name, default=None):
        return bool(self._get(name, default, "boolean"))

    def get_integer(self, name, default=None):
        return int(self._get(name, default, "integer"))

    def get_float(self, name, default=None):
        return float(self._get(name, default, "float"))

    def get_string(self, name, default=None):
        return str(self._get(name, default, "string"))

    def get_color(self, name, default=None):
        v = self._get(name, default, "color")
        return np.asarray(v, np.float32).reshape(3)

    def get_point(self, name, default=None):
        v = self._get(name, default, "point")
        return np.asarray(v, np.float32).reshape(3)

    def get_vector(self, name, default=None):
        v = self._get(name, default, "vector")
        return np.asarray(v, np.float32).reshape(3)

    def get_transform(self, name, default=None):
        v = self._get(name, default, "transform")
        return np.asarray(v, np.float64).reshape(4, 4)

    def set(self, name, value):
        self.props[name] = value


class _Required:
    pass


_REQUIRED = _Required()
REQUIRED = _REQUIRED
