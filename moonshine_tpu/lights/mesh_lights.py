"""Emissive-mesh (area light) sampling.

Parity target: MeshLights in shaders/hrtsystem/light.hlsl:105-158 — draw a
triangle from the area-weighted alias table, a uniform point on it, return
emitted radiance and the solid-angle pdf. The caller traces the shadow ray
(wavefront stage) and zeroes the pdf on occlusion, preserving the
reference's "pdf is with respect to obstructed solid angle" convention.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import alias_table
from ..core.gather import gather_rows
from ..core.mappings import square_to_triangle
from ..core.mathutil import dot, safe_normalize


def area_to_solid_angle(pos1, pos2, dir1, dir2):
    """r^2 / cos factor converting area pdf to solid-angle pdf
    (light.hlsl:105-110). dir1: shading->light, dir2: light normal."""
    diff = pos1 - pos2
    r2 = dot(diff, diff, keepdims=False)
    light_cos = dot(-dir1, dir2, keepdims=False)
    return jnp.where(light_cos > 0.0, r2 / jnp.maximum(light_cos, 1e-20), 0.0)


def sample_mesh_lights(scene, position_ws, rand2):
    """Sample one emissive-triangle direction per lane.

    scene: DeviceScene; position_ws: [N,3]; rand2: [N,2].
    Returns (dir_ws [N,3], light_pos [N,3], light_normal [N,3],
             tri_id [N] i32, bary [N,2], pdf [N], light_row [N,25]).
    light_row is the drawn emitter's packed row (EmitterTable.rows
    layout) — callers reuse it for the emissive lookup.
    pdf == 0 when there are no emitters (light.hlsl:134-136).
    """
    em = scene.emitters
    table = alias_table.AliasTable(
        select=em.select, alias=em.alias, weight_sum=0.0, count=0
    )
    has = em.count > 0
    count = jnp.maximum(em.count, 1)
    slot, rx = alias_table.sample(table, count, rand2[..., 0])
    light_row = gather_rows(
        em.rows, jnp.clip(slot, 0, em.rows.shape[0] - 1)
    )  # [N, 25]
    tri_id = light_row[:, 22].astype(jnp.int32)

    bary = square_to_triangle(
        jnp.stack([rx, rand2[..., 1]], axis=-1)
    )
    corners = light_row[:, 0:9].reshape(-1, 3, 3)
    b0 = (1.0 - bary[..., 0] - bary[..., 1])[..., None]
    b1 = bary[..., 0][..., None]
    b2 = bary[..., 1][..., None]
    light_pos = b0 * corners[:, 0] + b1 * corners[:, 1] + b2 * corners[:, 2]

    # geometric normal of the light triangle (front face emits)
    gn = safe_normalize(
        jnp.cross(corners[:, 0] - corners[:, 2], corners[:, 1] - corners[:, 2])
    )
    dir_ws = safe_normalize(light_pos - position_ws)
    pdf = area_to_solid_angle(light_pos, position_ws, dir_ws, gn) / jnp.maximum(
        em.weight_sum, 1e-20
    )
    pdf = jnp.where(has, pdf, 0.0)
    return dir_ws, light_pos, gn, tri_id, bary, pdf, light_row
