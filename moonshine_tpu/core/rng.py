"""Counter-based per-lane RNG.

Batched equivalent of the reference's per-pixel PCG stream
(reference: shaders/utils/random.hlsl:7-47). Each ray/pixel lane carries a
single uint32 state; seeding hashes (sample_index, x, y) so every sample of
every pixel draws from an independent, reproducible stream — independent of
batch slicing or device count, which keeps multi-chip renders bit-stable.

The generator is the public-domain PCG-RXS-M-XS permutation over an LCG
state (O'Neill, pcg-random.org), the same construction the reference uses,
so image statistics are directly comparable.

All functions are stateless: they take and return uint32 state arrays of any
shape, and are safe inside jit/vmap/shard_map.
"""

from __future__ import annotations

import jax.numpy as jnp

_LCG_MULT = jnp.uint32(747796405)
_LCG_INC = jnp.uint32(2891336453)
_RXS_MULT = jnp.uint32(277803737)


def _lcg(a: jnp.ndarray) -> jnp.ndarray:
    return a * _LCG_MULT + _LCG_INC


def _rxs_m_xs(a: jnp.ndarray) -> jnp.ndarray:
    b = ((a >> ((a >> jnp.uint32(28)) + jnp.uint32(4))) ^ a) * _RXS_MULT
    return (b >> jnp.uint32(22)) ^ b


def hash_pcg(a: jnp.ndarray) -> jnp.ndarray:
    """One-shot PCG hash of a uint32 array."""
    return _rxs_m_xs(_lcg(a))


def seed(sample_index, x, y) -> jnp.ndarray:
    """Build per-lane states from (sample index, pixel x, pixel y).

    Mirrors Rng::fromSeed (random.hlsl:28-31): nested PCG hashing so nearby
    pixels/samples decorrelate.
    """
    s = jnp.asarray(sample_index, jnp.uint32)
    x = jnp.asarray(x, jnp.uint32)
    y = jnp.asarray(y, jnp.uint32)
    return hash_pcg(s + hash_pcg(x + hash_pcg(y)))


def next_float(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Advance each lane and return (new_state, uniform float32 in [0,1)).

    The output keeps 24 bits of the permuted state so the float grid is
    exactly representable (random.hlsl:38-46).
    """
    state = _lcg(state)
    bits = _rxs_m_xs(state)
    f = (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)
    return state, f


def next_float2(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two uniforms per lane; returned array has trailing dim 2."""
    state, a = next_float(state)
    state, b = next_float(state)
    return state, jnp.stack([a, b], axis=-1)
