"""Render orchestration: pixels -> rays -> radiance -> sensor.

The per-sample step is one jitted function (the analogue of the reference's
recorded trace dispatch, offline/main.zig:131-165); progressive use calls it
repeatedly with an increasing sample index, exactly like the reference's
sample_count push constant.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import rng as R
from ..integrator.path import PathConfig, trace_paths, trace_paths_staged
from .camera import LensArrays, generate_rays, pixel_uv
from .sensor import Sensor, accumulate


# 2D tile shape for lane ordering. Lanes keep the same pixel for the whole
# trace, so tile-major order makes neighbouring lanes (a GPU warp, a
# thread block) cover a compact image region instead of a full-width
# scanline strip, and their rays stay coherent across bounces. Pure
# reshape/transpose both ways; RNG is (sample, x, y)-keyed, so the image
# is bit-identical to scanline order.
TILE_H, TILE_W = 64, 128


def _pixel_coords(height: int, width: int):
    """(py, px, unpack) — tile-major when the image spans multiple tiles,
    scanline otherwise. `unpack(flat [N, C]) -> [height, width, C]`."""
    if height % TILE_H or width % TILE_W:
        # non-multiple sizes keep scanline order (tests, thumbnails, pick)
        ys, xs = jnp.meshgrid(
            jnp.arange(height, dtype=jnp.uint32),
            jnp.arange(width, dtype=jnp.uint32),
            indexing="ij",
        )
        return ys.reshape(-1), xs.reshape(-1), (
            lambda flat: flat.reshape(height, width, -1)
        )
    ty, tx = height // TILE_H, width // TILE_W
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.uint32),
        jnp.arange(width, dtype=jnp.uint32),
        indexing="ij",
    )

    def tiled(a):
        return (
            a.reshape(ty, TILE_H, tx, TILE_W)
            .transpose(0, 2, 1, 3)
            .reshape(-1)
        )

    def unpack(flat):
        return (
            flat.reshape(ty, tx, TILE_H, TILE_W, -1)
            .transpose(0, 2, 1, 3, 4)
            .reshape(height, width, -1)
        )

    return tiled(ys), tiled(xs), unpack


# lanes per fused-graph dispatch. The fused bounce graph keeps the live
# state of every unrolled segment (tens of arrays x lanes x segments);
# larger frames switch to the STAGED path: one donated device dispatch
# per bounce (path.trace_paths_staged), whose live set is one segment
# deep at any lane count. RNG is (sample, x, y)-keyed, so the two paths
# produce identical images. The value is not yet derived for the GPU.
MAX_LANES = 512 * 1024
# the staged path runs max_bounces + 2 host dispatches with no early exit,
# so deep bounce budgets keep the fused while_loop (which exits when
# every lane is dead) at any lane count
MAX_STAGED_SEGMENTS = 10


def use_staged(lanes: int, cfg: PathConfig) -> bool:
    """Whether a dispatch of `lanes` lanes takes the staged path."""
    return lanes > MAX_LANES and cfg.max_bounces + 2 <= MAX_STAGED_SEGMENTS


@partial(jax.jit, static_argnames=("height", "width", "cfg", "flip_image",
                                   "band_h"))
def render_sample(scene, lens: LensArrays, height: int, width: int,
                  sample_index, cfg: PathConfig, flip_image: bool = True,
                  y0=0, band_h: int | None = None):
    """Trace one sample for every pixel of rows [y0, y0+band_h).

    Returns (radiance [band_h, W, 3], rays_traced scalar); band_h defaults
    to the full height. RNG streams are keyed by (sample_index, x, y)
    (main.hlsl:85) so any chunking/sharding of this dispatch produces
    identical images; y0 is traced so every band shares one compilation.
    """
    bh = band_h if band_h is not None else height
    py, px, unpack = _pixel_coords(bh, width)
    py = py + jnp.asarray(y0, jnp.uint32)  # absolute pixel rows
    rng = R.seed(jnp.asarray(sample_index, jnp.uint32), px, py)

    rng, jitter = R.next_float2(rng)
    uv = pixel_uv(px, py, width, height, jitter, flip_image)
    rng, ap = R.next_float2(rng)
    o, d = generate_rays(lens, width, height, uv, ap)

    radiance, rng, rays = trace_paths(scene, o, d, rng, cfg)
    return unpack(radiance), rays


@partial(jax.jit, static_argnames=("height", "width", "spp", "cfg",
                                   "flip_image", "band_h"))
def _render_spp_band(scene, lens, height, width, y0, start_index, spp,
                     cfg, flip_image, band_h):
    start = jnp.asarray(start_index, jnp.uint32)

    def body(i, carry):
        acc, rays_acc = carry
        img, rays = render_sample(
            scene, lens, height, width, start + jnp.uint32(i), cfg,
            flip_image, y0=y0, band_h=band_h,
        )
        return acc + img, rays_acc + rays

    init = (jnp.zeros((band_h, width, 3), jnp.float32),
            jnp.zeros((), jnp.float32))
    return jax.lax.fori_loop(0, spp, body, init)


@partial(jax.jit, static_argnames=("height", "width", "flip_image"))
def _sample_rays(lens, height: int, width: int, sample_index,
                 flip_image: bool):
    """Camera rays + per-lane RNG for one sample (the raygen stage of the
    staged path)."""
    py, px, _ = _pixel_coords(height, width)
    rng = R.seed(jnp.asarray(sample_index, jnp.uint32), px, py)
    rng, jitter = R.next_float2(rng)
    uv = pixel_uv(px, py, width, height, jitter, flip_image)
    rng, ap = R.next_float2(rng)
    o, d = generate_rays(lens, width, height, uv, ap)
    return o, d, rng


@partial(jax.jit, static_argnames=("height", "width", "nbatch",
                                   "flip_image"))
def _sample_rays_batched(lens, height: int, width: int, start_index,
                         nbatch: int, flip_image: bool):
    """Rays + RNG for `nbatch` consecutive samples, concatenated on the
    lane axis ([nbatch*H*W, ...], sample-major). Streams are the same
    (sample, x, y)-keyed ones as the unbatched path, so batching is
    bit-invisible in the image."""
    start = jnp.asarray(start_index, jnp.uint32)

    def one(s):
        return _sample_rays(lens, height, width, start + s, flip_image)

    o, d, rng = jax.vmap(one)(jnp.arange(nbatch, dtype=jnp.uint32))
    flat = lambda a: a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])
    return flat(o), flat(d), jax.tree.map(flat, rng)


@partial(jax.jit, static_argnames=("height", "width"), donate_argnums=(0, 1))
def _staged_accum(acc, rays_acc, radiance_flat, rays, height: int,
                  width: int):
    _, _, unpack = _pixel_coords(height, width)
    n = height * width
    if radiance_flat.shape[0] != n:  # sample-batched: sum over samples
        radiance_flat = radiance_flat.reshape(-1, n, 3).sum(axis=0)
    return acc + unpack(radiance_flat), rays_acc + rays


# lane target for one staged dispatch when batching samples: consecutive
# samples share the lane axis up to this many lanes, so small frames
# amortize each dispatch like a large one. The value is not yet derived
# for the GPU.
STAGE_TARGET_LANES = 2 * 1024 * 1024


def _render_spp_staged(scene, lens, height, width, start_index, spp, cfg,
                       flip_image, batch: int | None = None):
    """Large-frame / batched path: host-orchestrated per-bounce dispatches
    (see MAX_LANES). Samples are packed onto the lane axis up to
    STAGE_TARGET_LANES per dispatch; RNG is
    (sample, x, y)-keyed so the image is bit-identical to per-sample
    rendering."""
    lanes = height * width
    if batch is None:
        batch = max(1, min(spp, STAGE_TARGET_LANES // lanes))
    acc = jnp.zeros((height, width, 3), jnp.float32)
    rays_acc = jnp.zeros((), jnp.float32)
    start = int(start_index) if not hasattr(start_index, "shape") else start_index
    s = 0
    while s < spp:
        b = min(batch, spp - s)
        o, d, rng = _sample_rays_batched(
            lens, height, width,
            jnp.asarray(start, jnp.uint32) + jnp.uint32(s), b, flip_image)
        radiance, _, rays = trace_paths_staged(scene, o, d, rng, cfg)
        acc, rays_acc = _staged_accum(acc, rays_acc, radiance, rays,
                                      height, width)
        s += b
    return acc, rays_acc


def render_spp(scene, lens: LensArrays, height: int, width: int,
               start_index, spp: int, cfg: PathConfig,
               flip_image: bool = True):
    """Trace spp samples, summing radiance on-device.

    Images at or below MAX_LANES pixels, and deep bounce budgets, run as
    ONE device dispatch (lax.fori_loop over render_sample — the analogue
    of the reference recording all spp trace calls into a single command
    buffer, offline/main.zig:131-165). Larger frames run through the
    staged per-bounce path (see use_staged) as one full-frame lane batch.
    Returns (radiance_sum [H,W,3], rays)."""
    if use_staged(height * width, cfg):
        return _render_spp_staged(scene, lens, height, width, start_index,
                                  spp, cfg, flip_image)
    return _render_spp_band(scene, lens, height, width, 0, start_index,
                            spp, cfg, flip_image, band_h=height)


def render(scene, lens, height, width, spp, cfg: PathConfig,
           flip_image: bool = True, sensor: Sensor | None = None,
           progress=None):
    """Accumulate spp samples into a (possibly pre-existing) sensor.

    Returns (sensor, total_rays). Equivalent of the offline frontend's
    spp-iteration command buffer (offline/main.zig:131-165).
    """
    if isinstance(lens, LensArrays):
        lens_arrays = lens
    else:
        lens_arrays = LensArrays.from_lens(lens)
    if sensor is None:
        sensor = Sensor.create(height, width)
    total_rays = 0.0
    for s in range(spp):
        img, rays = render_sample(
            scene, lens_arrays, height, width, sensor.sample_count, cfg,
            flip_image,
        )
        sensor = accumulate(sensor, img, 1)
        total_rays += float(rays)
        if progress is not None:
            progress(s + 1, spp)
    return sensor, total_rays
