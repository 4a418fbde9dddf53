"""Multi-chip rendering via jax.sharding.

The distributed axis the reference never had (SURVEY.md §2.8): rendering is
sample- and pixel-parallel, so we shard the dispatch over a 2D device mesh:

  * "dp" — pixel-row tiles: each device traces its own block of rows
    (zero communication; the image comes out row-sharded)
  * "sp" — sample ranges: devices trace disjoint sample indices of the
    same pixels and psum-average at the end (one small collective, the
    running-mean commutes — main.hlsl:42-51)

Because RNG streams are keyed by (global sample index, x, y), any
(sp, dp) factorization produces the same image up to f32 summation order —
chip-count-invariant reproducibility.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core import rng as R
from ..integrator.path import PathConfig, trace_paths, trace_paths_staged
from ..render.camera import LensArrays, generate_rays, pixel_uv


def make_mesh(devices=None, sp: int | None = None) -> Mesh:
    """Factor the devices into a (sp, dp) mesh. Default: sp=2 when the
    device count is even, else pure dp."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // sp
    import numpy as np

    return Mesh(np.asarray(devices)[: sp * dp].reshape(sp, dp), ("sp", "dp"))


def mesh_from_spec(spec: str) -> Mesh:
    """Mesh from a CLI-style spec: 'auto' (all devices, sp=2 when even) or
    'SP,DP' (e.g. '2,4'). The frontends' entry to multi-chip rendering."""
    if spec == "auto":
        return make_mesh()
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(f"mesh spec must be 'auto' or 'SP,DP', got {spec!r}")
    sp, dp = int(parts[0]), int(parts[1])
    devices = jax.devices()
    if sp * dp > len(devices):
        raise ValueError(
            f"mesh {sp}x{dp} needs {sp * dp} devices, have {len(devices)}")
    return make_mesh(devices[: sp * dp], sp=sp)


@partial(jax.jit, static_argnames=("mesh", "height", "width", "spp", "cfg",
                                   "staged", "flip_image"))
def _sharded_step(scene, lens, base_sample, *, mesh: Mesh, height: int,
                  width: int, spp: int, cfg: PathConfig, staged: bool,
                  flip_image: bool):
    """Module-level jitted shard_map step. base_sample is a TRACED uint32
    so progressive frames (Engine.render with an advancing sample_count)
    reuse one cached executable instead of re-lowering the whole sharded
    bounce graph per frame."""
    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    rows = height // dp
    local_spp = spp // sp
    trace = trace_paths_staged if staged else trace_paths

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(None, "dp", None, None), P()),
        check_vma=False,
    )
    def step(scene, lens, base_sample):
        di = jax.lax.axis_index("dp")
        si = jax.lax.axis_index("sp")
        row0 = di * rows

        ys, xs = jnp.meshgrid(
            jnp.arange(rows, dtype=jnp.uint32),
            jnp.arange(width, dtype=jnp.uint32),
            indexing="ij",
        )
        px = xs.reshape(-1)
        py = ys.reshape(-1) + row0.astype(jnp.uint32)

        acc = jnp.zeros((rows, width, 3), jnp.float32)
        rays_total = jnp.asarray(0.0, jnp.float32)
        for s in range(local_spp):
            sample_index = (
                base_sample + si.astype(jnp.uint32) * local_spp + s
            )
            rng = R.seed(sample_index, px, py)
            rng, jitter = R.next_float2(rng)
            uv = pixel_uv(px, py, width, height, jitter, flip_image)
            rng, ap = R.next_float2(rng)
            o, d = generate_rays(lens, width, height, uv, ap)
            radiance, rng, rays = trace(scene, o, d, rng, cfg)
            acc = acc + radiance.reshape(rows, width, 3)
            rays_total = rays_total + rays

        acc = jax.lax.psum(acc, "sp") / spp
        rays_total = jax.lax.psum(rays_total, ("sp", "dp"))
        # leading singleton is the "sp" shard axis (replicated post-psum)
        return acc[None], rays_total

    return step(scene, lens, base_sample)


def render_sharded(scene, lens: LensArrays, height: int, width: int,
                   spp: int, cfg: PathConfig, mesh: Mesh,
                   flip_image: bool = True, base_sample: int = 0,
                   staged: bool | None = None):
    """Render spp samples over the mesh; returns ([H, W, 3] mean image,
    rays traced). height % dp == 0 and spp % sp == 0 required.

    staged: use the per-bounce staged integrator (trace_paths_staged)
    inside each shard instead of the fused bounce graph. Default: the
    same switch the single-device renderer makes on a device's local
    lane count (renderer.use_staged). Deep bounce budgets never stage:
    inside the traced shard_map the per-bounce host dispatch can't apply
    and the Python loop would inline max_bounces+2 segments into one
    program, so they run the fused while_loop path instead (early exit,
    one-segment live set)."""
    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    if height % dp or spp % sp:
        raise ValueError(
            f"height ({height}) must divide by dp ({dp}) and "
            f"spp ({spp}) by sp ({sp})"
        )
    rows = height // dp
    from ..render.renderer import MAX_STAGED_SEGMENTS, use_staged
    if staged is None:
        staged = use_staged(rows * width, cfg)
    if staged and cfg.max_bounces + 2 > MAX_STAGED_SEGMENTS:
        staged = False
        cfg = replace(cfg, unroll=False)
    image, rays = _sharded_step(
        scene, lens, jnp.asarray(base_sample, jnp.uint32), mesh=mesh,
        height=height, width=width, spp=spp, cfg=cfg, staged=staged,
        flip_image=flip_image,
    )
    return image[0], rays
