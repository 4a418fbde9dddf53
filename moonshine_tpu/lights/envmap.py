"""Environment-map lighting with equal-area parameterization.

Parity targets:
  * preprocessing — shaders/background/*.hlsl via BackgroundManager.zig:
    equirect -> equal-area square resample with 3x3 supersampling
    (equirectangular_to_equal_area.hlsl:16-29), Rec.709 luminance
    (luminance.hlsl), and the luminance integral that normalizes the
    sampling pdf (fold.hlsl's sum pyramid computes the same integral).
  * sampling/eval — EnvMap in shaders/hrtsystem/light.hlsl:34-103: a texel
    is drawn proportional to luminance; pdf is
    (texel luminance * S^2 / integral) / 4pi, uniform over the texel's
    equal-area footprint.

The reference samples by walking its sum-mip pyramid on the GPU because
building a distribution there is awkward. We build host-side anyway, so the
same texel distribution comes from one O(1) alias-table draw — identical
pdf, 2 gathers instead of 4*log2(S). Radiance and luminance are packed in
one [S*S, 4] row so the post-draw fetch is a single gather.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..core import alias_table
from ..core.gather import gather_rows, weighted_gather_rows
from ..core.mappings import (
    cartesian_to_spherical,
    square_to_equal_area_sphere,
    square_to_equal_area_sphere_inverse,
)
from ..core.mathutil import PI


class EnvMap(NamedTuple):
    rgbl: jnp.ndarray  # [S*S, 4] flat equal-area square: radiance + luminance
    integral: jnp.ndarray  # scalar: sum of texel luminances
    select: jnp.ndarray  # [S*S] alias-table keep probability
    alias: jnp.ndarray  # [S*S] alias-table fallback texel

    @property
    def size(self) -> int:
        """Equal-area square resolution, static from the array shape."""
        return int(round(self.rgbl.shape[0] ** 0.5))

    @property
    def rgb_image(self):
        s = self.size
        return self.rgbl[:, :3].reshape(s, s, 3)


def _finish(rgb: np.ndarray) -> EnvMap:
    s = rgb.shape[0]
    lum = (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    ).astype(np.float32)
    table = alias_table.build(lum.reshape(-1))
    rgbl = np.concatenate([rgb, lum[..., None]], axis=-1).reshape(-1, 4)
    return EnvMap(
        rgbl=jnp.asarray(rgbl, jnp.float32),
        integral=jnp.asarray(table.weight_sum, jnp.float32),
        select=table.select,
        alias=table.alias,
    )


def constant_envmap(rgb=(1.0, 1.0, 1.0)) -> EnvMap:
    """1x1 default background (BackgroundManager.zig:116-126)."""
    return _finish(np.asarray(rgb, np.float32).reshape(1, 1, 3))


def build_envmap(equirect: np.ndarray, size: int | None = None) -> EnvMap:
    """Convert an equirectangular [H, W, 3] image to the sampling-ready
    equal-area representation."""
    equirect = np.asarray(equirect, np.float32)
    if equirect.ndim == 2:
        equirect = equirect[..., None] * np.ones(3, np.float32)
    H, W = equirect.shape[:2]
    if size is None:
        size = int(min(1024, _next_pow2(max(H // 2, 1)) * 2))
    S = max(_next_pow2(size), 1)

    # 3x3 supersampled resample (equirectangular_to_equal_area.hlsl:16-29).
    # Convention: rgb[a, b] covers equal-area square coords
    # (u, v) = ((a+.5)/S, (b+.5)/S) — axis 0 is the first square coordinate.
    # The mappings are the integrator's own jnp code, run once per
    # subsample on the default device.
    spd = 3
    acc = np.zeros((S, S, 3), np.float32)
    px = np.arange(S, dtype=np.float32)
    for i in range(spd):
        for j in range(spd):
            sub = np.asarray([1 + i, 1 + j], np.float32) / (spd + 1)
            u = (px[:, None] + sub[0]) / S
            v = (px[None, :] + sub[1]) / S
            uv = np.stack(np.broadcast_arrays(u, v), axis=-1)
            sph = np.asarray(cartesian_to_spherical(
                square_to_equal_area_sphere(jnp.asarray(uv))))
            src_u = sph[..., 0] / (2 * PI)
            src_v = sph[..., 1] / PI
            acc += _bilinear_wrap_x(equirect, src_u, src_v)
    return _finish(acc / (spd * spd))


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def _bilinear_wrap_x(img: np.ndarray, u, v):
    """Bilinear sample, wrapping longitude, clamping latitude."""
    H, W = img.shape[:2]
    x = u * W - 0.5
    y = np.clip(v * H - 0.5, 0.0, H - 1.0)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0w = np.mod(x0, W)
    x1w = np.mod(x0 + 1, W)
    y0c = np.clip(y0, 0, H - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    top = img[y0c, x0w] * (1 - fx) + img[y0c, x1w] * fx
    bot = img[y1c, x0w] * (1 - fx) + img[y1c, x1w] * fx
    return top * (1 - fy) + bot * fy


def sample_envmap(env: EnvMap, rand2: jnp.ndarray):
    """Luminance-proportional texel draw (distribution parity with the
    hierarchical descent of light.hlsl:47-74).

    rand2: [N, 2] -> (dir_ws [N,3], radiance [N,3], pdf [N]).
    Occlusion is the caller's job (the reference traces inside sample;
    the wavefront design batches shadow rays separately).
    """
    S = env.size
    if S == 1:
        # constant env (static property): the alias draw is the identity
        # (texel 0, residual rand unchanged) and the pdf is uniform —
        # skip both row gathers; the direction mapping still runs.
        n = rand2.shape[0]
        radiance = jnp.broadcast_to(env.rgbl[0, :3], (n, 3))
        pdf = jnp.full((n,), 1.0 / (4.0 * PI), jnp.float32)
        return square_to_equal_area_sphere(rand2), radiance, pdf
    table = alias_table.AliasTable(
        select=env.select, alias=env.alias, weight_sum=0.0, count=0
    )
    texel, ru = alias_table.sample(table, S * S, rand2[..., 0])
    texel = texel.astype(jnp.int32)
    ix = texel // S
    iy = texel - ix * S

    row = gather_rows(env.rgbl, texel)
    radiance = row[..., :3]
    lum = row[..., 3]
    discrete_pdf = lum * (S * S) / jnp.maximum(env.integral, 1e-30)
    uv = (
        jnp.stack([ix, iy], axis=-1).astype(jnp.float32)
        + jnp.stack([ru, rand2[..., 1]], axis=-1)
    ) / S
    dir_ws = square_to_equal_area_sphere(uv)
    pdf = discrete_pdf / (4.0 * PI)
    return dir_ws, radiance, pdf


def eval_envmap(env: EnvMap, dir_ws: jnp.ndarray):
    """(radiance [N,3], pdf [N]) of a given direction (light.hlsl:83-97)."""
    S = env.size
    if S == 1:
        n = dir_ws.shape[0]
        return (jnp.broadcast_to(env.rgbl[0, :3], (n, 3)),
                jnp.full((n,), 1.0 / (4.0 * PI), jnp.float32))
    uv = square_to_equal_area_sphere_inverse(dir_ws)
    idx = jnp.clip((uv * S).astype(jnp.int32), 0, S - 1)
    row = gather_rows(env.rgbl, idx[..., 0] * S + idx[..., 1])
    pdf = row[..., 3] * (S * S) / jnp.maximum(env.integral, 1e-30) / (4.0 * PI)
    return row[..., :3], pdf


def miss_radiance_and_pdf(env: EnvMap, dir_ws: jnp.ndarray):
    """Fused miss-path query: bilinear incoming radiance + texel pdf with a
    single equal-area inverse (the integrator needs both every bounce)."""
    S = env.size
    if S == 1:
        n = dir_ws.shape[0]
        rad = jnp.broadcast_to(env.rgbl[0, :3], (n, 3))
        return rad, rad, jnp.full((n,), 1.0 / (4.0 * PI), jnp.float32)
    uv = square_to_equal_area_sphere_inverse(dir_ws)
    x = uv[..., 0] * S - 0.5
    y = uv[..., 1] * S - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = jnp.clip(x0.astype(jnp.int32), 0, S - 1)
    xi1 = jnp.clip(xi0 + 1, 0, S - 1)
    yi0 = jnp.clip(y0.astype(jnp.int32), 0, S - 1)
    yi1 = jnp.clip(yi0 + 1, 0, S - 1)
    bilinear = _bilinear_taps(env, xi0, xi1, yi0, yi1, fx, fy)[..., :3]
    # pdf uses the point-sampled texel, like eval (light.hlsl:90-95)
    idx = jnp.clip((uv * S).astype(jnp.int32), 0, S - 1)
    texel = gather_rows(env.rgbl, idx[..., 0] * S + idx[..., 1])
    pdf = texel[..., 3] * (S * S) / jnp.maximum(env.integral, 1e-30) / (4.0 * PI)
    return bilinear, texel[..., :3], pdf


def _bilinear_taps(env: EnvMap, xi0, xi1, yi0, yi1, fx, fy):
    """Four-tap bilinear env fetch as one weighted gather."""
    S = env.size
    fx1 = fx[..., 0]
    fy1 = fy[..., 0]
    ids = jnp.stack(
        [xi0 * S + yi0, xi1 * S + yi0, xi0 * S + yi1, xi1 * S + yi1], axis=-1
    )
    weights = jnp.stack(
        [(1 - fx1) * (1 - fy1), fx1 * (1 - fy1), (1 - fx1) * fy1, fx1 * fy1],
        axis=-1,
    )
    return weighted_gather_rows(env.rgbl, ids, weights)


def envmap_incoming_radiance(env: EnvMap, dir_ws: jnp.ndarray):
    """Bilinear-filtered miss radiance (light.hlsl:99-102)."""
    S = env.size
    if S == 1:
        return jnp.broadcast_to(env.rgbl[0, :3], (dir_ws.shape[0], 3))
    uv = square_to_equal_area_sphere_inverse(dir_ws)
    x = uv[..., 0] * S - 0.5
    y = uv[..., 1] * S - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = jnp.clip(x0.astype(jnp.int32), 0, S - 1)
    xi1 = jnp.clip(xi0 + 1, 0, S - 1)
    yi0 = jnp.clip(y0.astype(jnp.int32), 0, S - 1)
    yi1 = jnp.clip(yi0 + 1, 0, S - 1)
    return _bilinear_taps(env, xi0, xi1, yi0, yi1, fx, fy)[..., :3]
