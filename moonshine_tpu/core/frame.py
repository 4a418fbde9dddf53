"""Orthonormal shading frames, batched.

Behavioral parity target: shaders/hrtsystem/reflection_frame.hlsl. A frame
is represented as a dict-free tuple of three [...,3] arrays (n, s, t) so it
stays a plain pytree; helpers operate on direction arrays expressed in frame
space where z is the normal axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .mathutil import (
    coordinate_system, dot, mat_vec, normalize, safe_normalize,
)


class Frame(NamedTuple):
    n: jnp.ndarray  # normal
    s: jnp.ndarray  # tangent
    t: jnp.ndarray  # bitangent

    @staticmethod
    def from_normal(n):
        """Frame with arbitrary tangents around unit normal n
        (reflection_frame.hlsl:9-13)."""
        t, s = coordinate_system(n)
        return Frame(n=n, s=s, t=t)

    def reorthogonalize(self) -> "Frame":
        """Gram–Schmidt s against n, rebuild t (reflection_frame.hlsl:31-35)."""
        s = safe_normalize(self.s - self.n * dot(self.n, self.s))
        t = safe_normalize(jnp.cross(self.n, s))
        return Frame(n=self.n, s=s, t=t)

    def transform(self, mat3x3) -> "Frame":
        """Apply a linear map to all basis vectors and renormalize
        (reflection_frame.hlsl:23-29). mat3x3: [...,3,3]."""
        apply = lambda v: normalize(mat_vec(mat3x3, v))
        return Frame(n=apply(self.n), s=apply(self.s), t=apply(self.t))

    def world_to_frame(self, v):
        return jnp.stack(
            [
                dot(self.s, v, keepdims=False),
                dot(self.t, v, keepdims=False),
                dot(self.n, v, keepdims=False),
            ],
            axis=-1,
        )

    def frame_to_world(self, v):
        return (
            v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n
        )


# --- frame-space trig helpers (reflection_frame.hlsl:47-83) ---

def cos_theta(v):
    return v[..., 2]


def cos2_theta(v):
    return v[..., 2] * v[..., 2]


def sin2_theta(v):
    return jnp.maximum(0.0, 1.0 - cos2_theta(v))


def sin_theta(v):
    return jnp.sqrt(sin2_theta(v))


def tan2_theta(v):
    c2 = cos2_theta(v)
    return sin2_theta(v) / jnp.maximum(c2, 1e-30)


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0
