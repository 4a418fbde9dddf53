"""Multi-operand lane sorting.

`lax.sort` with payload operands moves every payload through one sort
network, instead of an argsort followed by one permutation gather per
array. The per-bounce state resort (integrator/path.py) goes through
here.

Restoring original order is the same primitive: carry a lane-index iota as
one payload, then sort the outputs by it.
"""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp


def sort_lanes(key, arrays):
    """Sort every array in `arrays` by `key` with ONE multi-operand sort.

    key: [N] integer/float key. arrays: list of [N] or [N, K] arrays
    (columns are split and re-stacked; bools ride as int8). The sort is
    stable, so ties preserve the incoming lane order — coherence keys
    keep their tile-major sub-order.

    Returns (key_sorted, arrays_sorted) with dtypes/shapes preserved.
    """
    cols = []
    specs = []
    for a in arrays:
        if a.ndim == 1:
            specs.append((a.dtype, None))
            cols.append(a)
        else:
            specs.append((a.dtype, a.shape[1]))
            for c in range(a.shape[1]):
                cols.append(a[:, c])
    cast = [
        c.astype(jnp.int8) if c.dtype == jnp.bool_ else c for c in cols
    ]
    out = lax.sort([key] + cast, num_keys=1, is_stable=True)
    key_sorted, out = out[0], list(out[1:])
    result = []
    i = 0
    for dtype, ncols in specs:
        if ncols is None:
            result.append(out[i].astype(dtype))
            i += 1
        else:
            result.append(
                jnp.stack([out[i + c].astype(dtype) for c in range(ncols)],
                          axis=1)
            )
            i += ncols
    return key_sorted, result
