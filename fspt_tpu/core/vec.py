"""Structure-of-arrays 3-vectors: the data layout of the core.

The reference stores vectors as 3-element JS arrays / GLSL vec3
(reference vector.js).  The compute core instead carries a `V3` of three
flat (N,) planes, so each op is a contiguous elementwise pass over N
values and XLA fuses whole chains of them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp


class V3(NamedTuple):
    x: Any
    y: Any
    z: Any

    # NamedTuple would define tuple-concat +; override with elementwise ops.
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def splat(c, like=None):
    """V3 from a python/0-d scalar (optionally broadcast like an array)."""
    if like is not None:
        c = jnp.full_like(like, c)
    return V3(c, c, c)


def from_array(a):
    """(..., 3) -> V3 of (...,) components (use at API boundaries only)."""
    a = jnp.asarray(a)
    return V3(a[..., 0], a[..., 1], a[..., 2])


def to_array(v: V3):
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(v: V3):
    return jnp.sqrt(dot(v, v))


def normalize(v: V3, eps: float = 1.0e-20) -> V3:
    inv = jnp.reciprocal(jnp.maximum(length(v), eps))
    return v * inv


def where(mask, a: V3, b: V3) -> V3:
    return V3(jnp.where(mask, a.x, b.x),
              jnp.where(mask, a.y, b.y),
              jnp.where(mask, a.z, b.z))


def lerp(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


def vmax(v: V3):
    return jnp.maximum(jnp.maximum(v.x, v.y), v.z)


def sum3(v: V3):
    return v.x + v.y + v.z


def gather(tab: V3, idx) -> V3:
    """Component-wise flat gather: tab of (S,) planes, idx (N,) -> V3 (N,)."""
    return V3(tab.x[idx], tab.y[idx], tab.z[idx])
