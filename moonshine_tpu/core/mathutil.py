"""Scalar/vector math helpers shared across the renderer.

Behavioral parity targets: shaders/utils/math.hlsl (constants, luminance,
faceForward, offsetAlongNormal, coordinateSystem). Everything operates on
batched arrays whose trailing axis is the vector axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PI = 3.14159265
# The reference uses a huge-but-finite tmax so t-comparisons never see inf
# (math.hlsl:5 "pranked").
INF_T = 1.0e12
AIR_IOR = 1.000277
MAX_U32 = jnp.uint32(0xFFFFFFFF)


def dot(a, b, keepdims: bool = True):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def safe_normalize(v, eps=1e-20):
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps)


def cross(a, b):
    return jnp.cross(a, b)


def luminance(color):
    """Rec.709 luminance (math.hlsl:17-21)."""
    return (
        0.2126 * color[..., 0] + 0.7152 * color[..., 1] + 0.0722 * color[..., 2]
    )


def face_forward(n, d):
    """Flip n to point into the same hemisphere as d (math.hlsl:23-25)."""
    return jnp.where(dot(n, d) > 0.0, n, -n)


def offset_along_normal(p, n):
    """Self-intersection-safe ray origin offset.

    Integer-ULP offset scheme (Wächter & Binder 2019), as used by
    math.hlsl:32-42: push p a few ULPs along n, with a fixed float offset
    near the origin where ULPs are too fine.
    """
    origin = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 256.0

    of_i = (n * int_scale).astype(jnp.int32)
    p_int = jax.lax.bitcast_convert_type(p, jnp.int32)
    p_i = jax.lax.bitcast_convert_type(
        p_int + jnp.where(p < 0.0, -of_i, of_i), jnp.float32
    )
    return jnp.where(jnp.abs(p) < origin, p + n * float_scale, p_i)


def coordinate_system(v1):
    """Build (v2, v3) orthonormal to unit v1 (math.hlsl:56-64).

    Branchless version of the reference's axis pick.
    """
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = jnp.abs(x) > jnp.abs(y)
    inv_a = jax.lax.rsqrt(jnp.maximum(x * x + z * z, 1e-30))
    inv_b = jax.lax.rsqrt(jnp.maximum(y * y + z * z, 1e-30))
    v2_a = jnp.stack([-z * inv_a, jnp.zeros_like(x), x * inv_a], axis=-1)
    v2_b = jnp.stack([jnp.zeros_like(x), z * inv_b, -y * inv_b], axis=-1)
    v2 = jnp.where(use_x[..., None], v2_a, v2_b)
    v3 = jnp.cross(v2, v1)
    return v2, v3


def reflect(v, n):
    """Mirror v about normal n (both unit, pointing away from surface)."""
    return 2.0 * dot(v, n) * n - v


def mat_vec(m, v):
    """[..., R, C] matrices times [..., C] vectors as float32 multiply-adds.

    Not a dot: on the GPU XLA may run an f32 dot in TF32 (about 10
    mantissa bits), enough to move a transformed ray origin to the wrong
    side of a surface."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def transform_point(mat3x4, p):
    """Apply a [...,3,4] affine transform to [...,3] points."""
    return mat_vec(mat3x4[..., :, :3], p) + mat3x4[..., :, 3]


def transform_dir(mat3x4, d):
    """Apply the linear part of a [...,3,4] transform to [...,3] vectors."""
    return mat_vec(mat3x4[..., :, :3], d)
