"""Unidirectional path tracer with NEE + MIS, batched over rays.

Behavioral parity target: PathTracingIntegrator
(shaders/hrtsystem/integrator.hlsl:55-184), including:
  * emissive handling — plain accumulation on primary/delta/unsampled hits,
    power-heuristic MIS against the area-light pdf otherwise (:109-124)
  * termination order — max-bounce cut *after* emissive, russian roulette
    (p = min(0.95, luminance(throughput))) after bounce 3 (:126-135)
  * NEE from the env map and from emissive meshes, skipped on delta
    materials, each with power-heuristic MIS (:139-151)
  * throughput update f * |cos| / pdf, pdf==0 kills the lane (:153-163)
  * env-map miss radiance with MIS unless primary/delta (:166-180)

The reference runs this as a per-thread megakernel on RT hardware; here one
`lax.while_loop` advances every lane in lockstep with masks, and each
iteration issues one batched closest-hit plus the NEE shadow batches.
Inactive lanes idle until the batch drains (wavefront compaction is the
planned optimization; semantics are already final).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..accel.intersect import any_hit, closest_hit
from ..bsdf import materials as B
from ..core import rng as R
from ..core.frame import Frame, cos_theta
from ..core.gather import gather_rows
from ..core.sortutil import sort_lanes
from ..core.mathutil import (
    INF_T,
    dot,
    face_forward,
    luminance,
    mat_vec,
    normalize,
    offset_along_normal,
    safe_normalize,
)
from ..lights.envmap import (
    envmap_incoming_radiance,
    miss_radiance_and_pdf,
    sample_envmap,
)
from ..lights.mesh_lights import area_to_solid_angle, sample_mesh_lights
from ..scene import textures as TX
from ..scene.textures import sample_material_block


@dataclass(frozen=True)
class PathConfig:
    """Static compile-time knobs (the reference's specialization constants,
    hrtsystem/pipeline.zig:319-327). Changing one re-jits, which is the
    XLA analogue of the reference's pipeline rebuild."""

    max_bounces: int = 4
    env_samples_per_bounce: int = 1
    mesh_samples_per_bounce: int = 1
    # None = auto: unroll the bounce loop when max_bounces + 2 <= 10
    unroll: bool | None = None
    # re-sort the whole lane state by ray coherence once per bounce, so
    # every traversal call (closest + the shadow batch) sees
    # coherence-ordered rays. Images agree up to float rounding (per-lane
    # RNG streams travel with their lanes; radiance scatters back by pixel
    # id at the end; the reordered program may fuse differently). Off by
    # default: whether it pays on the GPU is not measured yet.
    resort_bounces: bool = False


def power_heuristic(numf, f_pdf, numg, g_pdf):
    """Power heuristic, exponent 2 (integrator.hlsl:10-16)."""
    f = numf * f_pdf
    g = numg * g_pdf
    f2 = f * f
    return f2 / jnp.maximum(f2 + g * g, 1e-30)


def _interp(bary_u, bary_v, corners):
    """Barycentric interpolation of [N,3,C] corner attributes."""
    b0 = (1.0 - bary_u - bary_v)[..., None]
    return (
        b0 * corners[:, 0]
        + bary_u[..., None] * corners[:, 1]
        + bary_v[..., None] * corners[:, 2]
    )


def _tangent_bitangent(p0, p1, p2, t0, t1, t2):
    """UV-gradient tangent frame (world.hlsl:86-100)."""
    dt02 = t0 - t2
    dt12 = t1 - t2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = dt02[..., 0] * dt12[..., 1] - dt02[..., 1] * dt12[..., 0]
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    tangent = safe_normalize(
        (dt12[..., 1:2] * dp02 - dt02[..., 1:2] * dp12) * inv[..., None]
    )
    bitangent = safe_normalize(
        (-dt12[..., 0:1] * dp02 + dt02[..., 0:1] * dp12) * inv[..., None]
    )
    # degenerate uvs: fall back to an arbitrary frame around the normal
    n = safe_normalize(jnp.cross(p2 - p0, p1 - p0))
    fallback = Frame.from_normal(n)
    bad = (jnp.abs(det) < 1e-12)[..., None]
    tangent = jnp.where(bad, fallback.s, tangent)
    bitangent = jnp.where(bad, fallback.t, bitangent)
    return tangent, bitangent


def _inst_world(scene, inst, corners, nrms):
    """Two-level-instancing decode leg: transform OBJECT-space corner
    positions/normals of the gathered rows into world space with the
    hit lane's instance transform (accel/tlas.py stores object rows once
    per unique mesh; the flatten path bakes this at build time instead).
    Returns (corners_w, nrms_w, det_sign)."""
    I = scene.inst_tf.shape[0]
    tf = scene.inst_tf[jnp.clip(inst, 0, I - 1)]  # [N, 13]
    lin = tf[:, :9].reshape(-1, 3, 3)
    corners_w = mat_vec(lin[:, None], corners) + tf[:, None, 9:12]
    nrms_w = None
    if nrms is not None:
        # normal matrix = inverse-transpose of lin = (world->object
        # linear)^T, already stored in the TLAS's inverse transforms
        inv = scene.tlas.inst_inv[jnp.clip(inst, 0, I - 1)]
        nrm_m = inv[:, :9].reshape(-1, 3, 3)  # applied transposed
        nrms_w = safe_normalize(
            mat_vec(jnp.swapaxes(nrm_m, 1, 2)[:, None], nrms))
    return corners_w, nrms_w, tf[:, 12]


def _decode_hit(scene, tri, bary_u, bary_v, inst=None):
    """Gather and interpolate surface attributes at a hit
    (world.hlsl:107-177 MeshAttributes). One packed-row gather per lane.

    Returns (position, uv, tri_frame, vtx_frame, mat_row, sampled) where
    mat_row is the packed material record. `inst` (two-level instancing
    only) selects the per-lane transform applied to the object-space rows.
    """
    row = gather_rows(scene.tri_shade, tri)  # [N, 48]
    n = tri.shape[0]
    corners = row[:, 0:9].reshape(n, 3, 3)
    nrms = row[:, 9:18].reshape(n, 3, 3)
    uvs = row[:, 18:24].reshape(n, 3, 2)
    mat_id = row[:, 24].astype(jnp.int32)
    sampled = row[:, 25] > 0.5

    det_sign = None
    if inst is not None and getattr(scene, "tlas", None) is not None:
        corners, nrms, det_sign = _inst_world(scene, inst, corners, nrms)

    position = _interp(bary_u, bary_v, corners)
    uv = _interp(bary_u, bary_v, uvs)

    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    t0, t1, t2 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
    tangent, bitangent = _tangent_bitangent(p0, p1, p2, t0, t1, t2)
    tri_n = safe_normalize(jnp.cross(p0 - p2, p1 - p2))
    if det_sign is not None:
        # mirroring instances flip the winding the flatten path corrects
        # by swapping vertices; here the cross product's sign carries it
        tri_n = tri_n * det_sign[..., None]
    tri_frame = Frame(n=tri_n, s=tangent, t=bitangent).reorthogonalize()

    vtx_n = safe_normalize(_interp(bary_u, bary_v, nrms))
    vtx_frame = Frame(n=vtx_n, s=tri_frame.s, t=tri_frame.t).reorthogonalize()

    # material row rides in the shading row (cols 32:48) — folding it at
    # build time means no second gather
    mat_row = row[:, 32:48]
    return position, uv, tri_frame, vtx_frame, mat_row, sampled


def _decode_hit_thin(scene, tri, bary_u, bary_v, inst=None):
    """Last-segment decode: the final bounce only accumulates emissive
    (integrator.hlsl:109-124) and dies, so it needs position (mesh-light
    MIS pdf), the triangle normal (front-face test), uv (textured
    emissive), the material row, and the sampled flag — no vertex
    normals, tangent frames, or BSDF map fetch. Values are bit-identical
    to the full decode's."""
    row = gather_rows(scene.tri_shade, tri)  # [N, 48]
    n = tri.shape[0]
    corners = row[:, 0:9].reshape(n, 3, 3)
    uvs = row[:, 18:24].reshape(n, 3, 2)
    sampled = row[:, 25] > 0.5
    det_sign = None
    if inst is not None and getattr(scene, "tlas", None) is not None:
        corners, _, det_sign = _inst_world(scene, inst, corners, None)
    position = _interp(bary_u, bary_v, corners)
    uv = _interp(bary_u, bary_v, uvs)
    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    tri_n = safe_normalize(jnp.cross(p0 - p2, p1 - p2))
    if det_sign is not None:
        tri_n = tri_n * det_sign[..., None]
    return position, uv, tri_n, row[:, 32:48], sampled


def _decode_emissive(scene, mat_row, uv):
    """Emitted radiance only (getEmissive, material.hlsl:519-522)."""
    if scene.mat_atlas.emissive_constant:
        return mat_row[:, 7:10]
    block_b = sample_material_block(scene.mat_atlas.emissive,
                                    mat_row[:, 12:16], uv)
    return block_b[:, TX.EMISSIVE]


def _decode_material(scene, mat_row, uv):
    """Per-lane material parameters, emitted radiance, and tangent-space
    normal (material.hlsl loads :146-199 + getEmissive :519-522 + the
    normal sample of getTextureFrame).

    All-constant scenes (static atlas property) read every value straight
    from the packed material row — no atlas fetches at all. Textured
    scenes pay two independently-sized block fetches (BSDF maps +
    emissive)."""
    if scene.mat_atlas.bsdf_constant:
        color = mat_row[:, 1:4]
        metalness = mat_row[:, 4]
        roughness = mat_row[:, 6]
        normal_rg = mat_row[:, 10:12]
    else:
        block = sample_material_block(scene.mat_atlas.bsdf,
                                      mat_row[:, 1:5], uv)
        color = block[:, TX.COLOR]
        metalness = block[:, TX.METALNESS]
        roughness = block[:, TX.ROUGHNESS]
        normal_rg = block[:, TX.NORMAL_RG]
    emissive = _decode_emissive(scene, mat_row, uv)
    lanes = B.MaterialLanes(
        type=mat_row[:, 0].astype(jnp.int32),
        color=color,
        metalness=metalness,
        alpha=jnp.maximum(roughness * roughness, 1e-3),
        ior=mat_row[:, 5],
    )
    return lanes, emissive, normal_rg


def _texture_frame(normal_rg, vtx_frame):
    """Normal-mapped shading frame (material.hlsl:489-517); two-component
    normal decode is the reference default."""
    rg = normal_rg * 2.0 - 1.0
    z = jnp.sqrt(jnp.clip(1.0 - jnp.sum(rg * rg, axis=-1), 0.0, 1.0))
    n_ts = jnp.concatenate([rg, z[..., None]], axis=-1)
    n_ws = normalize(vtx_frame.frame_to_world(n_ts))
    return Frame(n=n_ws, s=vtx_frame.s, t=vtx_frame.t).reorthogonalize()


def _emissive_at(scene, light_row, bary):
    """Emitted radiance of a light sample point, from its (already
    gathered) packed emitter row (EmitterTable.rows layout)."""
    n = light_row.shape[0]
    uvs = light_row[:, 9:15].reshape(n, 3, 2)
    uv = _interp(bary[..., 0], bary[..., 1], uvs)
    if scene.mat_atlas.emissive_constant:
        return light_row[:, 15:18]
    # emissive lives in its own block (B): the NEE light-eval fetch never
    # touches the (possibly large) BSDF-map block
    block = sample_material_block(scene.mat_atlas.emissive,
                                  light_row[:, 18:22], uv)
    return block[:, TX.EMISSIVE]


def _bounce_body(scene, cfg: PathConfig, bounce, st, last: bool = False):
    """One path-tracing bounce over the whole lane batch.

    `bounce` may be a traced scalar (while_loop mode) or a Python int
    (unrolled mode — XLA then pipelines gathers across segments). State is a
    dict; RNG consumption on surviving lanes is identical in both modes so
    images match.

    last=True (static, unrolled mode only) marks the final segment, where
    every lane dies right after the emissive/miss accumulation
    (integrator.hlsl:126-128): NEE, russian roulette, and the BSDF scatter
    are statically skipped — they could only feed bounces that never run.
    """
    lor = jnp.logical_or
    land = jnp.logical_and

    active = st["active"]
    o, d = st["o"], st["d"]
    throughput = st["throughput"]
    radiance = st["radiance"]
    last_pdf = st["last_pdf"]
    last_delta = st["last_delta"]
    rng = st["rng"]
    rays = st["rays"] + jnp.sum(active)

    hit = closest_hit(scene, o, d, INF_T, active)
    is_hit = active & hit.is_hit
    miss = active & ~hit.is_hit

    # ---- miss: environment radiance (integrator.hlsl:166-180)
    env_plain = lor(cfg.env_samples_per_bounce == 0,
                    lor(bounce == 0, last_delta))
    if cfg.env_samples_per_bounce > 0:
        env_rad, rad_e, pdf_e = miss_radiance_and_pdf(scene.env, d)
        w = power_heuristic(1.0, last_pdf, cfg.env_samples_per_bounce, pdf_e)
        radiance = radiance + jnp.where(
            (miss & ~env_plain & (pdf_e > 0.0))[..., None],
            throughput * rad_e * w[..., None],
            0.0,
        )
    else:
        env_rad = envmap_incoming_radiance(scene.env, d)
    radiance = radiance + jnp.where(
        (miss & env_plain)[..., None], throughput * env_rad, 0.0
    )
    active = is_hit

    # ---- decode surface (gathers are clamped; masked lanes are junk-safe)
    tri = jnp.clip(hit.tri, 0, scene.num_tris - 1)
    inst = hit.inst  # two-level instancing only; None otherwise
    w_o_ws = -d
    if last:
        # final segment only accumulates emissive: thin decode, no frames
        position, uv, tri_n, mat_row, tri_sampled = _decode_hit_thin(
            scene, tri, hit.u, hit.v, inst=inst
        )
        emissive = _decode_emissive(scene, mat_row, uv)
    else:
        position, uv, tri_frame, vtx_frame, mat_row, tri_sampled = (
            _decode_hit(scene, tri, hit.u, hit.v, inst=inst)
        )
        mat, emissive, normal_rg = _decode_material(scene, mat_row, uv)
        tri_n = tri_frame.n

        # shading-normal selection chain (integrator.hlsl:93-104). When
        # every normal map is the flat constant the texture frame IS the
        # vertex frame, so the decode + frame construction + first chain
        # leg are statically skipped (static atlas property).
        frontfacing = dot(tri_frame.n, w_o_ws, keepdims=False) > 0.0
        sgn = jnp.where(frontfacing, 1.0, -1.0)
        vtx_ok = sgn * dot(w_o_ws, vtx_frame.n, keepdims=False) > 0.0
        if scene.mat_atlas.normals_flat:
            pick = lambda a, b, c: jnp.where(vtx_ok[..., None], b, c)
            tex_frame = vtx_frame
        else:
            tex_frame = _texture_frame(normal_rg, vtx_frame)
            tex_ok = sgn * dot(w_o_ws, tex_frame.n, keepdims=False) > 0.0
            pick = lambda a, b, c: jnp.where(
                tex_ok[..., None], a, jnp.where(vtx_ok[..., None], b, c)
            )
        frame = Frame(
            n=pick(tex_frame.n, vtx_frame.n, tri_frame.n),
            s=pick(tex_frame.s, vtx_frame.s, tri_frame.s),
            t=pick(tex_frame.t, vtx_frame.t, tri_frame.t),
        )
        w_o_ss = frame.world_to_frame(w_o_ws)

    # ---- emissive accumulation (integrator.hlsl:109-124)
    emit_plain = lor(cfg.mesh_samples_per_bounce == 0,
                     lor(bounce == 0, lor(~tri_sampled, last_delta)))
    emit_front = dot(w_o_ws, tri_n, keepdims=False) > 0.0
    radiance = radiance + jnp.where(
        (active & emit_plain & emit_front)[..., None],
        throughput * emissive,
        0.0,
    )
    if cfg.mesh_samples_per_bounce > 0:
        light_pdf = area_to_solid_angle(
            position, o, d, tri_n
        ) / jnp.maximum(scene.emitters.weight_sum, 1e-20)
        w = power_heuristic(
            1.0, last_pdf, cfg.mesh_samples_per_bounce, light_pdf
        )
        radiance = radiance + jnp.where(
            (active & ~emit_plain & (light_pdf > 0.0))[..., None],
            throughput * emissive * w[..., None],
            0.0,
        )

    # ---- termination (integrator.hlsl:126-135)
    if last:
        # final segment: the max-bounce cut kills every lane here; skip
        # RR, NEE, and the scatter — nothing after this can contribute
        return dict(
            active=jnp.zeros_like(active),
            o=o,
            d=d,
            throughput=throughput,
            radiance=radiance,
            last_pdf=last_pdf,
            last_delta=last_delta,
            rng=rng,
            rays=rays,
            pix=st["pix"],
        )

    active = land(active, bounce < cfg.max_bounces + 1)
    rng, rr_rand = R.next_float(rng)
    do_rr = jnp.asarray(bounce > 3)
    p_survive = jnp.minimum(0.95, luminance(throughput))
    die = do_rr & (rr_rand > p_survive)
    active = active & ~die
    throughput = jnp.where(
        (do_rr & active)[..., None],
        throughput / jnp.maximum(p_survive, 1e-20)[..., None],
        throughput,
    )

    is_delta = B.is_delta(mat.type)
    nee_active = active & ~is_delta

    # ---- NEE (integrator.hlsl:139-151): draw every light sample first,
    # trace ALL shadow rays as one batched any-hit dispatch, then weight.
    # The reference traces inside each light's sample(); batching the
    # segments halves the traversal dispatches per bounce.
    shadow_batches = []  # (origin, dir, tmax, lane, payload)

    for _ in range(cfg.env_samples_per_bounce):
        rng, r2 = R.next_float2(rng)
        l_dir, l_rad, l_pdf = sample_envmap(scene.env, r2)
        shadow_o = offset_along_normal(
            position, face_forward(tri_frame.n, l_dir)
        )
        lane = nee_active & (l_pdf > 0.0)
        shadow_batches.append(
            (shadow_o, l_dir, jnp.full_like(l_pdf, INF_T), lane,
             ("env", l_dir, l_rad, l_pdf))
        )

    for _ in range(cfg.mesh_samples_per_bounce):
        rng, r2 = R.next_float2(rng)
        l_dir, l_pos, l_n, l_tri, l_bary, l_pdf, l_row = sample_mesh_lights(
            scene, position, r2
        )
        l_rad = _emissive_at(scene, l_row, l_bary)
        # two-ended precise shadow segment (light.hlsl:149-154)
        off_light = offset_along_normal(l_pos, l_n)
        off_shade = offset_along_normal(
            position, face_forward(tri_frame.n, l_dir)
        )
        seg = off_light - off_shade
        seg_len = jnp.linalg.norm(seg, axis=-1)
        seg_dir = seg / jnp.maximum(seg_len, 1e-20)[..., None]
        lane = nee_active & (l_pdf > 0.0)
        shadow_batches.append(
            (off_shade, seg_dir, seg_len, lane,
             ("mesh", l_dir, l_rad, l_pdf))
        )

    if shadow_batches:
        occ_all = any_hit(
            scene,
            jnp.concatenate([b[0] for b in shadow_batches]),
            jnp.concatenate([b[1] for b in shadow_batches]),
            jnp.concatenate([b[2] for b in shadow_batches]),
            jnp.concatenate([b[3] for b in shadow_batches]),
        )
        n = position.shape[0]
        for i, (_, _, _, lane, payload) in enumerate(shadow_batches):
            kind, l_dir, l_rad, l_pdf = payload
            occluded = occ_all[i * n : (i + 1) * n]
            rays = rays + jnp.sum(lane)
            l_pdf = jnp.where(occluded, 0.0, l_pdf)
            w_i_ss = frame.world_to_frame(l_dir)
            brdf, scatter_pdf = B.eval_pdf_bsdf(mat, w_i_ss, w_o_ss)
            n_samples = (
                cfg.env_samples_per_bounce if kind == "env"
                else cfg.mesh_samples_per_bounce
            )
            mis = power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
            contrib = (
                l_rad
                * brdf
                * (jnp.abs(cos_theta(w_i_ss)) * mis
                   / jnp.maximum(l_pdf, 1e-30))[..., None]
            )
            ok = lane & (l_pdf > 0.0) & (scatter_pdf > 0.0)
            radiance = radiance + jnp.where(
                ok[..., None], throughput * contrib / n_samples, 0.0
            )

    # ---- scatter (integrator.hlsl:153-163)
    rng, r2 = R.next_float2(rng)
    w_i_ss, pdf = B.sample_bsdf(mat, w_o_ss, r2)
    active = active & (pdf > 0.0)
    new_d = normalize(frame.frame_to_world(w_i_ss))
    new_o = offset_along_normal(position, face_forward(tri_frame.n, new_d))
    f = B.eval_bsdf(mat, w_i_ss, w_o_ss)
    thr_mul = f * (jnp.abs(cos_theta(w_i_ss)) / jnp.maximum(pdf, 1e-30))[..., None]
    throughput = jnp.where(active[..., None], throughput * thr_mul, throughput)
    o = jnp.where(active[..., None], new_o, o)
    d = jnp.where(active[..., None], new_d, d)

    return dict(
        active=active,
        o=o,
        d=d,
        throughput=throughput,
        radiance=radiance,
        last_pdf=pdf,
        last_delta=is_delta,
        rng=rng,
        rays=rays,
        pix=st["pix"],
    )


def _resort_state(scene, st):
    """Reorder the whole lane state by ray coherence (8^3 origin cells x
    direction octant over the scene's root box; dead lanes to the tail) as
    ONE multi-operand lax.sort over all state columns (core/sortutil.py).
    Lanes keep their RNG streams and pixel ids, so images agree up to
    float rounding; trace_paths scatters radiance back to pixel order at
    the end. Two-level (TLAS) scenes keep their order."""
    if scene.bvh is None:
        return st
    o, d, active = st["o"], st["d"], st["active"]
    lo = scene.bvh.aabb_min[0]
    inv_ext = 1.0 / jnp.maximum(scene.bvh.aabb_max[0] - lo, 1e-20)
    cell = jnp.clip(((o - lo) * inv_ext * 8.0).astype(jnp.int32), 0, 7)
    octant = (
        (d[:, 0] > 0).astype(jnp.int32) * 4
        + (d[:, 1] > 0).astype(jnp.int32) * 2
        + (d[:, 2] > 0).astype(jnp.int32)
    )
    key = ((cell[:, 0] * 8 + cell[:, 1]) * 8 + cell[:, 2]) * 8 + octant
    key = jnp.where(active, key, jnp.int32(1 << 20))
    names = [k for k, v in st.items() if jnp.ndim(v) > 0]
    _, sorted_arrays = sort_lanes(key, [st[k] for k in names])
    out = dict(st)
    out.update(zip(names, sorted_arrays))
    return out


def _init_state(ray_o, ray_d, rng_state):
    N = ray_o.shape[0]
    f32 = jnp.float32
    return dict(
        active=jnp.ones(N, bool),
        o=ray_o,
        d=ray_d,
        throughput=jnp.ones((N, 3), f32),
        radiance=jnp.zeros((N, 3), f32),
        last_pdf=jnp.ones(N, f32),
        last_delta=jnp.zeros(N, bool),
        rng=rng_state,
        rays=jnp.asarray(0.0, f32),
        pix=jnp.arange(N, dtype=jnp.int32),
    )


def _bounce_shrunk(scene, cfg: PathConfig, bounce, st, last: bool):
    """Bounce over the live prefix only (requires a resorted state: the
    coherence key sends dead lanes to the tail, so all live lanes sit in
    a prefix). Deep bounces have few survivors, but the bounce machinery
    (hit decode, BSDF/NEE vector math, shadow batches) otherwise runs at
    full lane width — a lax.cond picks a N/2 or N/4 static prefix when
    the live count fits, processing the tail not at all. Dead lanes'
    radiance/state are final, so images are bit-identical; their RNG
    lanes stop advancing, which is unobservable (dead lanes never
    contribute again)."""
    N = st["o"].shape[0]
    if N < 4 * 1024:  # not worth the extra kernel variants
        return _bounce_body(scene, cfg, bounce, st, last=last)
    live = jnp.sum(st["active"])

    def prefix_fn(M):
        def fn(s):
            head = {
                k: (v[:M] if jnp.ndim(v) >= 1 and v.shape[0] == N else v)
                for k, v in s.items()
            }
            out = _bounce_body(scene, cfg, bounce, head, last=last)
            return {
                k: (jnp.concatenate([out[k], v[M:]], axis=0)
                    if jnp.ndim(v) >= 1 and v.shape[0] == N else out[k])
                for k, v in s.items()
            }
        return fn

    full_fn = lambda s: _bounce_body(scene, cfg, bounce, s, last=last)
    return jax.lax.cond(
        live <= N // 4,
        prefix_fn(N // 4),
        lambda s: jax.lax.cond(live <= N // 2, prefix_fn(N // 2),
                               full_fn, s),
        st,
    )


@partial(jax.jit, static_argnames=("cfg", "resort", "last"),
         donate_argnums=(1,))
def _staged_bounce(scene, st, bounce, cfg: PathConfig, resort: bool,
                   last: bool):
    """One bounce as its own device dispatch with the lane state donated:
    XLA's live set stays one segment deep no matter how many lanes (see
    renderer.MAX_LANES). `bounce` is traced so all mid bounces share one
    executable."""
    if resort:
        st = _resort_state(scene, st)
        return _bounce_shrunk(scene, cfg, bounce, st, last=last)
    return _bounce_body(scene, cfg, bounce, st, last=last)


@partial(jax.jit, static_argnames=("resort",))
def _staged_finish(st, resort: bool):
    radiance = st["radiance"]
    if resort:
        radiance = jnp.zeros_like(radiance).at[st["pix"]].set(radiance)
    return radiance, st["rng"], st["rays"]


def trace_paths_staged(scene, ray_o, ray_d, rng_state, cfg: PathConfig):
    """Host-orchestrated trace_paths for very large lane counts: one
    donated dispatch per bounce instead of one fused graph. Semantics and
    RNG consumption identical to the unrolled trace_paths — images match
    bit-for-bit."""
    resort = cfg.resort_bounces
    st = jax.jit(_init_state)(ray_o, ray_d, rng_state)
    n_segments = cfg.max_bounces + 2
    for b in range(n_segments):
        st = _staged_bounce(
            scene, st, jnp.asarray(b, jnp.int32), cfg,
            resort=resort and b > 0, last=b == n_segments - 1,
        )
    return _staged_finish(st, resort=resort)


def trace_paths(scene, ray_o, ray_d, rng_state, cfg: PathConfig):
    """Estimate incoming radiance along N rays.

    Returns (radiance [N,3], rng_state, rays_traced scalar f32).
    rays_traced counts closest-hit + shadow rays actually issued (active
    lanes), the Mrays/sec numerator.

    Two compilation modes: for small max_bounces the bounce loop unrolls
    into a straight-line graph (XLA pipelines the gathers); deep bounce
    budgets (the reference's offline 1024) use a while_loop that exits as
    soon as every lane terminates.
    """
    st = _init_state(ray_o, ray_d, rng_state)
    n_segments = cfg.max_bounces + 2
    unroll = cfg.unroll if cfg.unroll is not None else n_segments <= 10
    resort = cfg.resort_bounces

    def finish(fs):
        radiance = fs["radiance"]
        if resort:
            # lanes moved; scatter back to pixel order
            radiance = jnp.zeros_like(radiance).at[fs["pix"]].set(radiance)
        return radiance, fs["rng"], fs["rays"]

    if unroll:
        for bounce in range(n_segments):
            if resort and bounce > 0:
                st = _resort_state(scene, st)
                st = _bounce_shrunk(scene, cfg, bounce, st,
                                    last=bounce == n_segments - 1)
            else:
                st = _bounce_body(scene, cfg, bounce, st,
                                  last=bounce == n_segments - 1)
        return finish(st)

    keys = tuple(st.keys())

    def cond(carry):
        bounce, s = carry[0], dict(zip(keys, carry[1:]))
        return jnp.any(s["active"]) & (bounce < n_segments)

    def body(carry):
        bounce = carry[0]
        s = dict(zip(keys, carry[1:]))
        if resort:
            # bounce 0 enters unsorted-but-fully-live; the shrink's live
            # check keeps it at full width there automatically
            s = _resort_state(scene, s)
            s = _bounce_shrunk(scene, cfg, bounce, s, last=False)
        else:
            s = _bounce_body(scene, cfg, bounce, s)
        return (bounce + 1,) + tuple(s[k] for k in keys)

    final = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32),) + tuple(st[k] for k in keys)
    )
    fs = dict(zip(keys, final[1:]))
    return finish(fs)
