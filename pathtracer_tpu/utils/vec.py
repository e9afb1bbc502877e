"""Component-wise 3-vector SoA — the core data layout.

Every per-ray quantity is a `Vec3` of three [N] arrays. This keeps all
vector math as fused elementwise ops over contiguous arrays: no (N,3)x(3,3)
mini-matmuls, no gathers for component selection, no minor-dim-3 layouts.
Matrix transforms are applied with the 16 matrix entries as broadcast
scalars.

Vec3 is a NamedTuple, hence a pytree: it nests freely in lax.scan carries,
jit arguments, and grad.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # --- arithmetic -------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return Vec3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # --- geometry ---------------------------------------------------------
    def dot(self, o: "Vec3") -> jnp.ndarray:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> jnp.ndarray:
        return self.dot(self)

    def length(self) -> jnp.ndarray:
        return jnp.sqrt(self.length_sq())

    def normalize(self) -> "Vec3":
        # rsqrt with a tiny clamp: zero vectors (masked lanes) stay finite so
        # NaNs never leak through unselected jnp.where branches or their grads
        inv = jax.lax.rsqrt(jnp.maximum(self.length_sq(), 1e-30))
        return self * inv

    # --- elementwise helpers ----------------------------------------------
    def min_component(self) -> jnp.ndarray:
        return jnp.minimum(jnp.minimum(self.x, self.y), self.z)

    def max_component(self) -> jnp.ndarray:
        return jnp.maximum(jnp.maximum(self.x, self.y), self.z)

    @staticmethod
    def where(cond, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(jnp.where(cond, a.x, b.x),
                    jnp.where(cond, a.y, b.y),
                    jnp.where(cond, a.z, b.z))

    @staticmethod
    def minimum(a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y),
                    jnp.minimum(a.z, b.z))

    @staticmethod
    def maximum(a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y),
                    jnp.maximum(a.z, b.z))

    @staticmethod
    def full(shape, vals, dtype=jnp.float32) -> "Vec3":
        return Vec3(jnp.full(shape, vals[0], dtype),
                    jnp.full(shape, vals[1], dtype),
                    jnp.full(shape, vals[2], dtype))

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Vec3":
        # three distinct buffers (not one aliased array): donation of a Vec3
        # requires each leaf to own its buffer
        return Vec3(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype),
                    jnp.zeros(shape, dtype))

    @staticmethod
    def broadcast(vec, shape) -> "Vec3":
        """From a length-3 array-like of scalars to a broadcast Vec3."""
        return Vec3(jnp.broadcast_to(vec[0], shape),
                    jnp.broadcast_to(vec[1], shape),
                    jnp.broadcast_to(vec[2], shape))

    # --- conversion ---------------------------------------------------------
    @staticmethod
    def from_array(a: jnp.ndarray) -> "Vec3":
        """[..., 3] -> Vec3 of [...]."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> jnp.ndarray:
        """Vec3 of [...] -> [..., 3]."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)


def mat4_apply(m: jnp.ndarray, v: Vec3, w: float) -> Vec3:
    """(m @ [v, w]).xyz with matrix entries as broadcast scalars.

    `m` is a [4,4] array; each m[i,j] is a scalar at trace time, so the whole
    transform is 9 multiplies + adds per lane — never a matmul.
    """
    return Vec3(
        m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z + w * m[0, 3],
        m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z + w * m[1, 3],
        m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z + w * m[2, 3],
    )
