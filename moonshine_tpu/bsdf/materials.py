"""Branchless batched BSDFs.

Behavioral parity target: shaders/hrtsystem/material.hlsl (GGX :20-67,
Fresnel :71-123, Lambert :137-175, StandardPBR :179-270, PerfectMirror
:313-332, Glass :345-393, MaterialVariant dispatch :395-487).

The reference dispatches a tagged union per ray with a switch; here we
evaluate all four material models for every lane and select by type code —
four fused closed forms are cheaper than divergent control flow.
All directions are in the local reflection frame (z = shading normal).
`w_o` points away from the surface toward the viewer; `w_i` toward the
light/next bounce.

Type codes follow the reference enum (world.hlsl:31-36) so scene buffers
are interchangeable: Glass=0, Lambert=1, PerfectMirror=2, StandardPBR=3.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.frame import cos_theta, same_hemisphere, tan2_theta
from ..core.mappings import (
    coin_flip_remap,
    spherical_to_cartesian,
    square_to_cosine_hemisphere,
)
from ..core.mathutil import AIR_IOR, PI, dot, safe_normalize

GLASS = 0
LAMBERT = 1
MIRROR = 2
STANDARD_PBR = 3


class MaterialLanes(NamedTuple):
    """Per-lane decoded material parameters (post texture lookup)."""

    type: jnp.ndarray  # [N] int32
    color: jnp.ndarray  # [N, 3] base color / albedo
    metalness: jnp.ndarray  # [N]
    alpha: jnp.ndarray  # [N] GGX alpha = max(roughness^2, 1e-3)
    ior: jnp.ndarray  # [N] interior IOR (StandardPBR + Glass)


# --- GGX microfacet distribution (material.hlsl:20-67) ---

def ggx_d(alpha, m):
    a2 = alpha * alpha
    c2 = cos_theta(m) ** 2
    denom = PI * (c2 * (a2 - 1.0) + 1.0) ** 2
    return a2 / jnp.maximum(denom, 1e-20)


def _ggx_lambda(alpha, v):
    t2 = tan2_theta(v)
    # isinf(tan2) -> 0 in the reference; t2 is clamped finite here, and the
    # sqrt dominates anyway
    return (jnp.sqrt(1.0 + alpha * alpha * t2) - 1.0) / 2.0


def ggx_g(alpha, w_i, w_o):
    return 1.0 / (1.0 + _ggx_lambda(alpha, w_i) + _ggx_lambda(alpha, w_o))


def ggx_sample(alpha, w_o, square):
    tan2 = alpha * alpha * square[..., 0] / jnp.maximum(1.0 - square[..., 0], 1e-8)
    cos2 = 1.0 / (1.0 + tan2)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos2))
    cos_t = jnp.sqrt(cos2)
    phi = 2.0 * PI * square[..., 1]
    h = spherical_to_cartesian(sin_t, cos_t, phi)
    return jnp.where(same_hemisphere(w_o, h)[..., None], h, -h)


def ggx_pdf(alpha, m):
    return ggx_d(alpha, m) * jnp.abs(cos_theta(m))


# --- Fresnel (material.hlsl:71-123) ---

def schlick_r0(eta_i, eta_t):
    return ((eta_t - eta_i) / (eta_t + eta_i)) ** 2


def schlick_weight(c):
    return (1.0 - c) ** 5


def schlick_scalar(cos_t, r0):
    return r0 + (1.0 - r0) * schlick_weight(cos_t)


def schlick_color(cos_t, r0_rgb):
    return r0_rgb + (1.0 - r0_rgb) * schlick_weight(cos_t)[..., None]


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel (PBRT form, material.hlsl:96-122)."""
    c = jnp.clip(cos_theta_i, -1.0, 1.0)
    entering = c > 0.0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    c = jnp.abs(c)
    sin_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - c * c))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))
    r_parl = (et * c - ei * cos_t) / jnp.maximum(et * c + ei * cos_t, 1e-12)
    r_perp = (ei * c - et * cos_t) / jnp.maximum(ei * c + et * cos_t, 1e-12)
    f = (r_parl * r_parl + r_perp * r_perp) / 2.0
    return jnp.where(tir, 1.0, f)


# --- Lambert (material.hlsl:137-175) ---

def _lambert_pdf(w_i, w_o):
    return jnp.where(
        same_hemisphere(w_i, w_o), jnp.abs(cos_theta(w_i)) / PI, 0.0
    )


def _lambert_eval(color, w_i, w_o):
    return color / PI


def _lambert_sample(w_o, square):
    w_i = square_to_cosine_hemisphere(square)
    flip = cos_theta(w_o) < 0.0
    w_i = w_i.at[..., 2].set(jnp.where(flip, -w_i[..., 2], w_i[..., 2]))
    return w_i, _lambert_pdf(w_i, w_o)


# --- StandardPBR: metalness lerp of GGX specular + Lambert diffuse with
#     one-sample lobe MIS (material.hlsl:179-270) ---

def _micro_pdf(alpha, w_i, w_o):
    h = safe_normalize(w_i + w_o)
    pdf = ggx_pdf(alpha, h) / jnp.maximum(4.0 * dot(w_o, h, keepdims=False), 1e-12)
    return jnp.where(same_hemisphere(w_o, w_i), pdf, 0.0)


def _micro_sample(alpha, w_o, square):
    h = ggx_sample(alpha, w_o, square)
    w_i = 2.0 * dot(w_o, h) * h - w_o
    pdf = ggx_pdf(alpha, h) / jnp.maximum(4.0 * dot(w_o, h, keepdims=False), 1e-12)
    pdf = jnp.where(same_hemisphere(w_o, w_i), pdf, 0.0)
    return w_i, pdf


def _pbr_p_specular(metalness):
    # specularWeight=1, diffuseWeight=1-metalness (material.hlsl:218-220)
    return 1.0 / (2.0 - metalness)


def _pbr_sample(mat: MaterialLanes, w_o, square):
    p_spec = _pbr_p_specular(mat.metalness)
    take_spec, rx = coin_flip_remap(p_spec, square[..., 0])
    sq = jnp.stack([rx, square[..., 1]], axis=-1)

    spec_dir, spec_pdf = _micro_sample(mat.alpha, w_o, sq)
    spec_other = _lambert_pdf(spec_dir, w_o)
    pdf_if_spec = spec_other + (spec_pdf - spec_other) * p_spec

    diff_dir, diff_pdf = _lambert_sample(w_o, sq)
    diff_other = _micro_pdf(mat.alpha, diff_dir, w_o)
    pdf_if_diff = diff_pdf + (diff_other - diff_pdf) * p_spec

    w_i = jnp.where(take_spec[..., None], spec_dir, diff_dir)
    pdf = jnp.where(take_spec, pdf_if_spec, pdf_if_diff)
    return w_i, pdf


def _pbr_pdf(mat: MaterialLanes, w_i, w_o):
    p_spec = _pbr_p_specular(mat.metalness)
    lam = _lambert_pdf(w_i, w_o)
    mic = _micro_pdf(mat.alpha, w_i, w_o)
    return lam + (mic - lam) * p_spec


def _pbr_eval(mat: MaterialLanes, w_i, w_o):
    h = safe_normalize(w_i + w_o)
    cos_ih = dot(w_i, h, keepdims=False)
    f_dielectric = fresnel_dielectric(cos_ih, AIR_IOR, mat.ior)[..., None]
    f_metallic = schlick_color(cos_ih, mat.color)
    f = f_dielectric + (f_metallic - f_dielectric) * mat.metalness[..., None]
    g = ggx_g(mat.alpha, w_i, w_o)
    d = ggx_d(mat.alpha, h)
    denom = 4.0 * jnp.abs(cos_theta(w_i)) * jnp.abs(cos_theta(w_o))
    spec = f * (g * d / jnp.maximum(denom, 1e-12))[..., None]
    spec = jnp.where(same_hemisphere(w_o, w_i)[..., None], spec, 0.0)
    diffuse = _lambert_eval(mat.color, w_i, w_o)
    return spec + (1.0 - mat.metalness[..., None]) * diffuse


# --- DisneyDiffuse (material.hlsl:272-311) ---
# The reference carries this model unbound to any variant; exposed here the
# same way: usable standalone, not part of the runtime dispatch.

def disney_diffuse_sample(color, roughness, w_o, square):
    return _lambert_sample(w_o, square)


def disney_diffuse_pdf(w_i, w_o):
    return _lambert_pdf(w_i, w_o)


def disney_diffuse_eval(color, roughness, w_i, w_o):
    lambertian = color / PI
    h = safe_normalize(w_i + w_o)
    cos_hi = dot(w_i, h, keepdims=False)
    cos_ni = jnp.abs(cos_theta(w_i))
    cos_no = jnp.abs(cos_theta(w_o))
    f_i = (1.0 - cos_ni) ** 5
    f_o = (1.0 - cos_no) ** 5
    r_r = 2.0 * roughness * cos_hi * cos_hi
    retro = r_r * (f_i + f_o + f_i * f_o * (r_r - 1.0))
    scale = (1.0 - f_i / 2.0) * (1.0 - f_o / 2.0) + retro
    return lambertian * scale[..., None]


# --- PerfectMirror (material.hlsl:313-332) ---

def _mirror_sample(w_o):
    w_i = jnp.stack([-w_o[..., 0], -w_o[..., 1], w_o[..., 2]], axis=-1)
    return w_i, jnp.ones(w_o.shape[:-1], w_o.dtype)


def _mirror_eval(w_i):
    return (1.0 / jnp.maximum(jnp.abs(cos_theta(w_i)), 1e-12))[..., None] * jnp.ones(3)


# --- Glass (material.hlsl:334-393) ---

def _refract_dir(wi, n, eta):
    """Returns (dir, valid). material.hlsl:334-343."""
    cos_i = dot(n, wi, keepdims=False)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    valid = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    d = eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n
    return jnp.where(valid[..., None], d, 0.0), valid


def _glass_sample(mat: MaterialLanes, w_o, square):
    f = fresnel_dielectric(cos_theta(w_o), AIR_IOR, mat.ior)
    reflect = square[..., 0] < f
    refl_dir = jnp.stack([-w_o[..., 0], -w_o[..., 1], w_o[..., 2]], axis=-1)

    entering = cos_theta(w_o) > 0.0
    eta_i = jnp.where(entering, AIR_IOR, mat.ior)
    eta_t = jnp.where(entering, mat.ior, AIR_IOR)
    # faceForward(+z, w_o)
    n = jnp.zeros_like(w_o).at[..., 2].set(jnp.where(entering, 1.0, -1.0))
    refr_dir, refr_valid = _refract_dir(w_o, n, eta_i / eta_t)
    refr_pdf = jnp.where(refr_valid, 1.0 - f, 0.0)

    w_i = jnp.where(reflect[..., None], refl_dir, refr_dir)
    pdf = jnp.where(reflect, f, refr_pdf)
    return w_i, pdf


def _glass_eval(mat: MaterialLanes, w_i, w_o):
    f = fresnel_dielectric(cos_theta(w_o), AIR_IOR, mat.ior)
    mag = jnp.where(same_hemisphere(w_i, w_o), f, 1.0 - f)
    return (mag / jnp.maximum(jnp.abs(cos_theta(w_i)), 1e-12))[..., None] * jnp.ones(3)


# --- dispatch (material.hlsl:395-487) ---

def is_delta(mat_type):
    return (mat_type == MIRROR) | (mat_type == GLASS)


def _select(mat_type, glass, lambert, mirror, pbr):
    expand = glass.ndim > mat_type.ndim
    cond = lambda c: c[..., None] if expand else c
    out = jnp.where(cond(mat_type == GLASS), glass, lambert)
    out = jnp.where(cond(mat_type == MIRROR), mirror, out)
    out = jnp.where(cond(mat_type == STANDARD_PBR), pbr, out)
    return out


def eval_bsdf(mat: MaterialLanes, w_i, w_o):
    """BSDF value (radiance transfer density). For delta materials this is
    the reference's convention: magnitude / |cos w_i| so that
    eval * |cos| / pdf gives the correct throughput."""
    return _select(
        mat.type,
        _glass_eval(mat, w_i, w_o),
        _lambert_eval(mat.color, w_i, w_o),
        _mirror_eval(w_i),
        _pbr_eval(mat, w_i, w_o),
    )


def pdf_bsdf(mat: MaterialLanes, w_i, w_o):
    """Solid-angle pdf of sampling w_i; 0 for delta materials."""
    zeros = jnp.zeros(w_i.shape[:-1], w_i.dtype)
    return _select(
        mat.type,
        zeros,
        _lambert_pdf(w_i, w_o),
        zeros,
        _pbr_pdf(mat, w_i, w_o),
    )


def eval_pdf_bsdf(mat: MaterialLanes, w_i, w_o):
    """Fused eval_bsdf + pdf_bsdf: the NEE weighting needs both values for
    every shadow sample (estimateDirectMISLight, integrator.hlsl:20-35
    calls eval and pdf back-to-back); computing them together shares the
    GGX half-vector, D term, Lambert pdf, and hemisphere tests. Returns
    (f [N,3], pdf [N]) — delta materials contribute f like eval_bsdf and
    pdf 0 like pdf_bsdf.
    """
    h = safe_normalize(w_i + w_o)
    same_h = same_hemisphere(w_o, w_i)
    d_ggx = ggx_d(mat.alpha, h)
    lam_pdf = jnp.where(same_h, jnp.abs(cos_theta(w_i)) / PI, 0.0)

    # StandardPBR eval (material.hlsl:179-270) off the shared terms
    cos_ih = dot(w_i, h, keepdims=False)
    f_dielectric = fresnel_dielectric(cos_ih, AIR_IOR, mat.ior)[..., None]
    f_metallic = schlick_color(cos_ih, mat.color)
    fr = f_dielectric + (f_metallic - f_dielectric) * mat.metalness[..., None]
    g = ggx_g(mat.alpha, w_i, w_o)
    denom = 4.0 * jnp.abs(cos_theta(w_i)) * jnp.abs(cos_theta(w_o))
    spec = fr * (g * d_ggx / jnp.maximum(denom, 1e-12))[..., None]
    spec = jnp.where(same_h[..., None], spec, 0.0)
    diffuse = _lambert_eval(mat.color, w_i, w_o)
    pbr_f = spec + (1.0 - mat.metalness[..., None]) * diffuse

    # StandardPBR pdf: micro pdf reuses the same h and D
    mic = d_ggx * jnp.abs(cos_theta(h)) / jnp.maximum(
        4.0 * dot(w_o, h, keepdims=False), 1e-12)
    mic = jnp.where(same_h, mic, 0.0)
    pbr_pdf = lam_pdf + (mic - lam_pdf) * _pbr_p_specular(mat.metalness)

    zeros = jnp.zeros_like(lam_pdf)
    f = _select(
        mat.type,
        _glass_eval(mat, w_i, w_o),
        _lambert_eval(mat.color, w_i, w_o),
        _mirror_eval(w_i),
        pbr_f,
    )
    pdf = _select(mat.type, zeros, lam_pdf, zeros, pbr_pdf)
    return f, pdf


def sample_bsdf(mat: MaterialLanes, w_o, square):
    """Draw a scattering direction. Returns (w_i [N,3], pdf [N]).

    pdf == 0 marks an invalid/terminated sample (matches
    MaterialSample.pdf semantics, integrator.hlsl:154-155).
    """
    g_dir, g_pdf = _glass_sample(mat, w_o, square)
    l_dir, l_pdf = _lambert_sample(w_o, square)
    m_dir, m_pdf = _mirror_sample(w_o)
    p_dir, p_pdf = _pbr_sample(mat, w_o, square)
    w_i = _select(mat.type, g_dir, l_dir, m_dir, p_dir)
    pdf = _select(mat.type, g_pdf, l_pdf, m_pdf, p_pdf)
    return w_i, pdf
