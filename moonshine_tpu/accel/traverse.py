"""Batched stackless BVH traversal in plain JAX: the reference walk.

Software replacement for the hardware `TraceRay` calls
(shaders/hrtsystem/intersection.hlsl:18-47): all rays advance in lockstep
through a single `lax.while_loop`, each lane holding its own node cursor.
Skip links (`escape`) make the walk stackless; leaves intersect a small
fixed triangle bundle (Möller–Trumbore) so the loop's per-iteration work is
pure gathers + elementwise math, which XLA vectorizes across the ray batch.
This is the CPU path and the reference the CUDA kernel (kernels/
traverse.cu) is checked against; accel/intersect.py picks between them.

`closest_hit` mirrors Intersection::find (force-opaque closest hit);
`any_hit` mirrors ShadowIntersection::hit (accept-first-hit, used by NEE
shadow rays) and terminates lanes as soon as any occluder is found.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .lbvh import BVH


class Hit(NamedTuple):
    t: jnp.ndarray  # [N] f32, = tmax on miss
    tri: jnp.ndarray  # [N] i32 original triangle index, -1 on miss
    u: jnp.ndarray  # [N] f32 barycentric of vertex 1
    v: jnp.ndarray  # [N] f32 barycentric of vertex 2
    # instance id: only the two-level (TLAS) traversal fills this; the
    # single-level kernels return flattened triangles whose instance lives
    # in the shade row instead (accel/tlas.py)
    inst: jnp.ndarray | None = None

    @property
    def is_hit(self):
        return self.tri >= 0


def _safe_inv(d):
    tiny = 1e-12
    mag = jnp.abs(d)
    sgn = jnp.where(d >= 0.0, 1.0, -1.0)
    return 1.0 / jnp.where(mag < tiny, sgn * tiny, d)


def _aabb_hit(amin, amax, o, inv_d, t_best):
    t0 = (amin - o) * inv_d
    t1 = (amax - o) * inv_d
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_best)


def _tri_intersect(v0, v1, v2, o, d, t_min, t_best):
    """Möller–Trumbore. Returns (hit_mask, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_best)
    )
    return hit, t, u, v


def closest_hit(
    bvh: BVH,
    sorted_tri_verts: jnp.ndarray,  # [T, 3, 3] in Morton-sorted order
    ray_o: jnp.ndarray,  # [N, 3]
    ray_d: jnp.ndarray,  # [N, 3]
    t_max,  # scalar or [N]
    leaf_size: int = 4,
    active_in: jnp.ndarray | None = None,
) -> Hit:
    """Closest intersection along each ray. Inactive lanes return a miss."""
    N = ray_o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))
    inv_d = _safe_inv(ray_d)

    cur0 = jnp.zeros(N, jnp.int32)
    if active_in is not None:
        cur0 = jnp.where(active_in, cur0, -1)

    def cond(state):
        cur, *_ = state
        return jnp.any(cur >= 0)

    def body(state):
        cur, t_best, best_tri, best_u, best_v = state
        node = jnp.clip(cur, 0, bvh.num_nodes - 1)
        active = cur >= 0

        amin = bvh.aabb_min[node]
        amax = bvh.aabb_max[node]
        box_hit = active & _aabb_hit(amin, amax, ray_o, inv_d, t_best)

        left = bvh.left[node]
        count = bvh.count[node]
        is_leaf = count > 0

        # leaf: test up to leaf_size triangles (statically unrolled bundle)
        leaf_do = box_hit & is_leaf
        for j in range(leaf_size):
            lane = leaf_do & (j < count)
            s_idx = jnp.clip(left + j, 0, bvh.num_tris - 1)
            tri = sorted_tri_verts[s_idx]
            h, t, u, v = _tri_intersect(
                tri[:, 0], tri[:, 1], tri[:, 2], ray_o, ray_d, 0.0, t_best
            )
            take = lane & h
            t_best = jnp.where(take, t, t_best)
            best_tri = jnp.where(take, bvh.tri_order[s_idx], best_tri)
            best_u = jnp.where(take, u, best_u)
            best_v = jnp.where(take, v, best_v)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, left, bvh.escape[node])
        cur = jnp.where(active, nxt, cur)
        return cur, t_best, best_tri, best_u, best_v

    init = (
        cur0,
        t_max,
        jnp.full(N, -1, jnp.int32),
        jnp.zeros(N, jnp.float32),
        jnp.zeros(N, jnp.float32),
    )
    _, t, tri, u, v = jax.lax.while_loop(cond, body, init)
    return Hit(t=t, tri=tri, u=u, v=v)


def any_hit(
    bvh: BVH,
    sorted_tri_verts: jnp.ndarray,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    t_max,
    leaf_size: int = 4,
    active_in: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """True where any occluder lies in (0, t_max). Lanes stop at first hit."""
    N = ray_o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))
    inv_d = _safe_inv(ray_d)

    cur0 = jnp.zeros(N, jnp.int32)
    if active_in is not None:
        cur0 = jnp.where(active_in, cur0, -1)

    def cond(state):
        cur, _ = state
        return jnp.any(cur >= 0)

    def body(state):
        cur, occluded = state
        node = jnp.clip(cur, 0, bvh.num_nodes - 1)
        active = cur >= 0

        box_hit = active & _aabb_hit(
            bvh.aabb_min[node], bvh.aabb_max[node], ray_o, inv_d, t_max
        )
        left = bvh.left[node]
        count = bvh.count[node]
        is_leaf = count > 0

        leaf_do = box_hit & is_leaf
        found = jnp.zeros_like(occluded)
        for j in range(leaf_size):
            lane = leaf_do & (j < count)
            s_idx = jnp.clip(left + j, 0, bvh.num_tris - 1)
            tri = sorted_tri_verts[s_idx]
            h, _, _, _ = _tri_intersect(
                tri[:, 0], tri[:, 1], tri[:, 2], ray_o, ray_d, 0.0, t_max
            )
            found = found | (lane & h)

        occluded = occluded | found
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, left, bvh.escape[node])
        nxt = jnp.where(found, -1, nxt)  # lane done at first hit
        cur = jnp.where(active, nxt, cur)
        return cur, occluded

    _, occluded = jax.lax.while_loop(
        cond, body, (cur0, jnp.zeros(N, bool))
    )
    return occluded


def brute_force_closest(tri_verts, ray_o, ray_d, t_max):
    """O(N*T) reference intersector for tests."""
    N = ray_o.shape[0]
    T = tri_verts.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))

    def per_tri(carry, tri_and_idx):
        t_best, best_tri, best_u, best_v = carry
        tri, idx = tri_and_idx
        h, t, u, v = _tri_intersect(
            tri[0][None], tri[1][None], tri[2][None], ray_o, ray_d, 0.0, t_best
        )
        t_best = jnp.where(h, t, t_best)
        best_tri = jnp.where(h, idx, best_tri)
        best_u = jnp.where(h, u, best_u)
        best_v = jnp.where(h, v, best_v)
        return (t_best, best_tri, best_u, best_v), None

    init = (
        t_max,
        jnp.full(N, -1, jnp.int32),
        jnp.zeros(N, jnp.float32),
        jnp.zeros(N, jnp.float32),
    )
    (t, tri, u, v), _ = jax.lax.scan(
        per_tri, init, (tri_verts, jnp.arange(T, dtype=jnp.int32))
    )
    return Hit(t=t, tri=tri, u=u, v=v)
