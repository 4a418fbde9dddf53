"""Alias-method discrete sampling.

Host-side O(n) Vose build (parity: engine/alias_table.zig:12-174) and a
batched device-side sampler (parity: sampleAlias, utils/mappings.hlsl:114-126).
Unlike the reference — which smuggles {count, weight_sum} into entry 0 of the
GPU buffer — we keep the header as explicit fields.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from .gather import gather_rows
from .mappings import coin_flip_remap


class AliasTable(NamedTuple):
    """select[i] = probability of keeping bucket i; alias[i] = fallback bucket.

    `weight_sum` is the unnormalized total weight, `count` the number of live
    entries (arrays may be padded beyond it).
    """

    select: jnp.ndarray  # [n] float32
    alias: jnp.ndarray  # [n] uint32
    weight_sum: float
    count: int


def build(weights: np.ndarray, pad_to: int | None = None) -> AliasTable:
    """Vose's algorithm over nonnegative weights (alias_table.zig:37-127)."""
    weights = np.asarray(weights, np.float64)
    n = len(weights)
    total = float(weights.sum())
    select = np.ones(max(n, 1), np.float64)
    alias = np.arange(max(n, 1), dtype=np.uint32)
    if n > 0 and total > 0.0:
        scaled = weights * (n / total)
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            lo = small.pop()
            hi = large.pop()
            select[lo] = scaled[lo]
            alias[lo] = hi
            scaled[hi] = (scaled[hi] + scaled[lo]) - 1.0
            (small if scaled[hi] < 1.0 else large).append(hi)
        for i in large + small:
            select[i] = 1.0
    if pad_to is not None and pad_to > len(select):
        select = np.pad(select, (0, pad_to - len(select)), constant_values=1.0)
        alias = np.pad(alias, (0, pad_to - len(alias)))
    return AliasTable(
        select=jnp.asarray(select, jnp.float32),
        alias=jnp.asarray(alias, jnp.uint32),
        weight_sum=total,
        count=n,
    )


def sample(table: AliasTable, count, rand):
    """Batched draw: rand [..] in [0,1) → (bucket index [..] uint32, remapped rand).

    `count` may be a traced scalar (the live-entry count for padded tables).
    Matches sampleAlias's double rand-reuse (mappings.hlsl:114-126).
    """
    scaled = rand * jnp.asarray(count, jnp.float32)
    idx = jnp.minimum(
        scaled.astype(jnp.uint32), jnp.asarray(count - 1, jnp.uint32)
    )
    rand = scaled - jnp.floor(scaled)
    # one fused (select, alias) row fetch; alias ids are exact in f32
    # below 2^24 entries
    sa = gather_rows(
        jnp.stack([table.select, table.alias.astype(jnp.float32)], axis=-1),
        idx,
    )
    keep, rand = coin_flip_remap(sa[..., 0], rand)
    idx = jnp.where(keep, idx, sa[..., 1].astype(jnp.uint32))
    return idx, rand
