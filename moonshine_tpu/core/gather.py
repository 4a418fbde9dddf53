"""Row gathers shared by the integrator, the lights and the textures.

Plain XLA gathers. Every form clamps out-of-range ids to the nearest valid
row, so a masked lane's junk id (a miss's -1) reads a real row instead of
wrapping around to the last one.
"""

from __future__ import annotations

import jax.numpy as jnp


def gather_rows(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """table [T, C], ids [N] int -> [N, C]."""
    return table[jnp.clip(ids, 0, table.shape[0] - 1)]


def weighted_gather_rows(table: jnp.ndarray, ids: jnp.ndarray,
                         weights: jnp.ndarray) -> jnp.ndarray:
    """K-tap filtered gather: table [T, C], ids [N, K] int, weights [N, K]
    -> sum_k weights[:, k] * table[ids[:, k]] (the bilinear env fetch)."""
    out = 0.0
    for k in range(ids.shape[1]):
        rows = gather_rows(table, ids[:, k]).astype(weights.dtype)
        out = out + weights[:, k:k + 1] * rows
    return out


def shift_gather_rows(table: jnp.ndarray, base: jnp.ndarray, shifts,
                      weights: jnp.ndarray) -> jnp.ndarray:
    """K-tap filtered gather where every tap is a fixed row shift of one
    base id: sum_k weights[:, k] * table[base + shifts[k]], in float32.

    This is the bilinear texture fetch over wrap-border-padded atlases
    (textures.py): the 4 taps of a bilinear fetch are (+0, +1, +stride,
    +stride+1) of the top-left texel. `shifts` entries may be traced
    scalars (the runtime row stride)."""
    out = 0.0
    for k, shift in enumerate(shifts):
        rows = gather_rows(table, base + shift).astype(jnp.float32)
        out = out + weights[:, k:k + 1] * rows
    return out
