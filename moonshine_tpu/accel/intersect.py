"""The one traversal entry point for closest-hit and any-hit queries.

The integrator asks this module, never a kernel, for intersections. It
owns the choice of implementation:

  * two-level (instanced) scenes walk the TLAS in plain JAX (tlas.py);
  * otherwise the query is staged with `lax.platform_dependent`, so the
    platform the computation is lowered for picks it: the per-thread CUDA
    kernel (cuda.py) on `cuda`, the lockstep reference walk
    (traverse.py) on `cpu`. Both walk the same tree in the same order.
    Any other platform fails to lower.

A scene whose `packed` records are None uses traverse.py on every
platform; that is how the kernel is timed against the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cuda, lbvh, packed as packed_mod, tlas as tlas_mod, traverse
from .packed import PackedBVH
from .traverse import Hit


class Accel(NamedTuple):
    """What traversal reads of a scene (scene.world.DeviceScene carries
    the same fields)."""

    bvh: lbvh.BVH
    tri_verts_sorted: jnp.ndarray  # [T, 3, 3] in the BVH's sorted order
    packed: PackedBVH | None  # kernel records; None = traverse.py only
    tlas: object = None


def device_accel(bvh_host: lbvh.BVH, tri_verts: np.ndarray,
                 topology: lbvh.BVH | None = None) -> Accel:
    """Upload a host (numpy) BVH over [T, 3, 3] triangles together with
    the kernel's records of it. `topology`, a device BVH of the same tree
    (a refit), keeps its topology arrays: only the boxes are uploaded."""
    sorted_verts = np.asarray(tri_verts, np.float32)[
        np.asarray(bvh_host.tri_order)]
    rec = packed_mod.pack(bvh_host, sorted_verts)
    if topology is None:
        bvh = lbvh.device_bvh(bvh_host)
    else:
        bvh = topology._replace(aabb_min=jnp.asarray(bvh_host.aabb_min),
                                aabb_max=jnp.asarray(bvh_host.aabb_max))
    return Accel(
        bvh=bvh,
        tri_verts_sorted=jnp.asarray(sorted_verts),
        packed=PackedBVH(nodes=jnp.asarray(rec.nodes),
                         tris=jnp.asarray(rec.tris)),
    )


def _lanes(o, t_max, active):
    n = o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    active = jnp.ones(n, bool) if active is None else active
    return t_max, active


def closest_hit(scene, ray_o, ray_d, t_max, active=None) -> Hit:
    """Nearest hit in (0, t_max) per ray; inactive lanes return a miss
    with t = t_max. TLAS scenes also fill `Hit.inst`."""
    if scene.tlas is not None:
        return tlas_mod.closest_hit_tlas(scene.tlas, ray_o, ray_d, t_max,
                                         active_in=active)
    t_max, active = _lanes(ray_o, t_max, active)

    def plain(o, d, tm, act):
        return traverse.closest_hit(scene.bvh, scene.tri_verts_sorted, o, d,
                                    tm, active_in=act)

    if scene.packed is None:
        return plain(ray_o, ray_d, t_max, active)

    def kernel(o, d, tm, act):
        return cuda.closest_hit(scene.packed, scene.bvh.tri_order, o, d, tm,
                                act)

    return jax.lax.platform_dependent(ray_o, ray_d, t_max, active,
                                      cpu=plain, cuda=kernel)


def any_hit(scene, ray_o, ray_d, t_max, active=None) -> jnp.ndarray:
    """True where any occluder lies in (0, t_max); False on inactive
    lanes."""
    if scene.tlas is not None:
        return tlas_mod.any_hit_tlas(scene.tlas, ray_o, ray_d, t_max,
                                     active_in=active)
    t_max, active = _lanes(ray_o, t_max, active)

    def plain(o, d, tm, act):
        return traverse.any_hit(scene.bvh, scene.tri_verts_sorted, o, d, tm,
                                active_in=act)

    if scene.packed is None:
        return plain(ray_o, ray_d, t_max, active)

    def kernel(o, d, tm, act):
        return cuda.any_hit(scene.packed, o, d, tm, act)

    return jax.lax.platform_dependent(ray_o, ray_d, t_max, active,
                                      cpu=plain, cuda=kernel)
