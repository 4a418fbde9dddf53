"""Direct-light integrator: primary hit + NEE only.

Parity target: DirectLightIntegrator (integrator.hlsl:188-249) — the
reference ships it unbound to any binary; here it is selectable, useful for
fast previews and light-baking style passes.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp

from ..accel.intersect import any_hit, closest_hit
from ..bsdf import materials as B
from ..core import rng as R
from ..core.frame import Frame, cos_theta
from ..core.mathutil import INF_T, dot, face_forward, offset_along_normal
from ..lights.envmap import sample_envmap
from ..lights.mesh_lights import sample_mesh_lights
from .path import (
    PathConfig,
    _decode_hit,
    _decode_material,
    _emissive_at,
    _texture_frame,
    power_heuristic,
)


@dataclass(frozen=True)
class DirectConfig:
    env_samples_per_bounce: int = 1
    mesh_samples_per_bounce: int = 1


def trace_direct(scene, ray_o, ray_d, rng_state, cfg: DirectConfig):
    """One primary hit + emissive + MIS NEE (integrator.hlsl:199-247).
    Returns (radiance [N,3], rng_state, rays_traced)."""
    N = ray_o.shape[0]
    rays = jnp.asarray(float(N), jnp.float32)
    rng = rng_state

    hit = closest_hit(scene, ray_o, ray_d, INF_T)
    active = hit.is_hit
    miss = ~active

    from ..lights.envmap import envmap_incoming_radiance

    radiance = jnp.where(
        miss[..., None],
        envmap_incoming_radiance(scene.env, ray_d),
        0.0,
    )

    tri = jnp.clip(hit.tri, 0, scene.num_tris - 1)
    position, uv, tri_frame, vtx_frame, mat_row, _ = _decode_hit(
        scene, tri, hit.u, hit.v, inst=hit.inst
    )
    mat, emissive, normal_rg = _decode_material(scene, mat_row, uv)
    tex_frame = _texture_frame(normal_rg, vtx_frame)

    w_o_ws = -ray_d
    tex_ok = dot(w_o_ws, tex_frame.n, keepdims=False) > 0.0
    vtx_ok = dot(w_o_ws, vtx_frame.n, keepdims=False) > 0.0
    pick = lambda a, b, c: jnp.where(
        tex_ok[..., None], a, jnp.where(vtx_ok[..., None], b, c)
    )
    frame = Frame(
        n=pick(tex_frame.n, vtx_frame.n, tri_frame.n),
        s=pick(tex_frame.s, vtx_frame.s, tri_frame.s),
        t=pick(tex_frame.t, vtx_frame.t, tri_frame.t),
    )
    w_o_ss = frame.world_to_frame(w_o_ws)

    radiance = radiance + jnp.where(active[..., None], emissive, 0.0)

    def nee(radiance, rng, rays, sampler, n_samples):
        for _ in range(n_samples):
            rng, r2 = R.next_float2(rng)
            l_dir, l_rad, l_pdf, tmax = sampler(r2)
            shadow_o = offset_along_normal(
                position, face_forward(tri_frame.n, l_dir)
            )
            lane = active & (l_pdf > 0.0)
            occluded = any_hit(scene, shadow_o, l_dir, tmax, lane)
            rays = rays + jnp.sum(lane)
            l_pdf = jnp.where(occluded, 0.0, l_pdf)
            w_i_ss = frame.world_to_frame(l_dir)
            scatter_pdf = B.pdf_bsdf(mat, w_i_ss, w_o_ss)
            brdf = B.eval_bsdf(mat, w_i_ss, w_o_ss)
            mis = power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
            contrib = l_rad * brdf * (
                jnp.abs(cos_theta(w_i_ss)) * mis / jnp.maximum(l_pdf, 1e-30)
            )[..., None]
            ok = lane & (l_pdf > 0.0) & (scatter_pdf > 0.0)
            radiance = radiance + jnp.where(
                ok[..., None], contrib / n_samples, 0.0
            )
        return radiance, rng, rays

    if cfg.env_samples_per_bounce > 0:
        def env_sampler(r2):
            l_dir, l_rad, l_pdf = sample_envmap(scene.env, r2)
            return l_dir, l_rad, l_pdf, jnp.full(N, INF_T, jnp.float32)

        radiance, rng, rays = nee(
            radiance, rng, rays, env_sampler, cfg.env_samples_per_bounce
        )

    if cfg.mesh_samples_per_bounce > 0:
        def mesh_sampler(r2):
            l_dir, l_pos, l_n, l_tri, l_bary, l_pdf, l_row = sample_mesh_lights(
                scene, position, r2
            )
            l_rad = _emissive_at(scene, l_row, l_bary)
            seg = offset_along_normal(l_pos, l_n) - position
            tmax = jnp.linalg.norm(seg, axis=-1)
            return l_dir, l_rad, l_pdf, tmax

        radiance, rng, rays = nee(
            radiance, rng, rays, mesh_sampler, cfg.mesh_samples_per_bounce
        )

    return radiance, rng, rays
