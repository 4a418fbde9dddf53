"""core/gather.py: the row gathers behind hit decode, lights and textures."""

import jax.numpy as jnp
import numpy as np
import pytest

from moonshine_tpu.core import gather as G


def _table(t=300, c=7, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(t, c)).astype(np.float32) * 50)


class TestGatherRows:
    def test_fallback_matches_indexing(self):
        tab = _table()
        ids = jnp.asarray([0, 5, 299, 5, 17], jnp.int32)
        np.testing.assert_array_equal(G.gather_rows(tab, ids), tab[ids])

    def test_out_of_range_clamps(self):
        """Out-of-range ids read the nearest valid row; a miss lane's -1
        must not wrap around to the last row."""
        tab = _table()
        out = G.gather_rows(tab, jnp.asarray([-3, -1, 300, 1000], jnp.int32))
        np.testing.assert_array_equal(
            out, np.asarray(tab)[[0, 0, 299, 299]]
        )


class TestWeightedGatherRows:
    def _check(self, tab, ids, w):
        ref = sum(
            np.asarray(w)[:, k : k + 1] * np.asarray(tab)[np.asarray(ids)[:, k]]
            for k in range(ids.shape[1])
        )
        got = G.weighted_gather_rows(tab, ids, w)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)

    def test_fallback(self):
        tab = _table()
        rng = np.random.default_rng(2)
        ids = jnp.asarray(rng.integers(0, 300, size=(64, 4)), jnp.int32)
        w = jnp.asarray(rng.random((64, 4)).astype(np.float32))
        self._check(tab, ids, w)

    def test_duplicate_taps_accumulate(self):
        """Bilinear wrap can land two taps on the same texel; their
        weights must add."""
        tab = _table()
        ids = jnp.asarray([[7, 7, 2, 2]], jnp.int32)
        w = jnp.asarray([[0.25, 0.25, 0.3, 0.2]], jnp.float32)
        got = G.weighted_gather_rows(tab, ids, w)
        ref = 0.5 * tab[7] + 0.5 * tab[2]
        np.testing.assert_allclose(got[0], ref, rtol=1e-6)


class TestShiftGatherRows:
    """Fixed-shift taps of one base id (the bilinear atlas fetch)."""

    def _check(self, tab, base, shifts, w):
        ref = sum(
            np.asarray(w)[:, k : k + 1]
            * np.asarray(tab, np.float32)[np.asarray(base) + int(s)]
            for k, s in enumerate(shifts)
        )
        got = G.shift_gather_rows(tab, base, shifts, w)
        assert got.dtype == jnp.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)

    def _fixture(self, rows=300, c=7, n=96, seed=4):
        rng = np.random.default_rng(seed)
        shifts = (0, 1, 17, 18)
        tab = jnp.asarray(
            rng.random((rows + 18, c)).astype(np.float32), jnp.bfloat16
        )
        base = jnp.asarray(rng.integers(0, rows, size=n), jnp.int32)
        w = jnp.asarray(rng.random((n, 4)).astype(np.float32))
        return tab, base, shifts, w

    def test_fallback(self):
        self._check(*self._fixture())

    def test_traced_shift(self):
        """Shift entries may be traced scalars (the runtime row stride)."""
        tab, base, shifts, w = self._fixture()
        shifts = (0, 1, jnp.asarray(17, jnp.int32), jnp.asarray(18, jnp.int32))
        self._check(tab, base, shifts, w)


class TestMaterialBlockBilinear:
    """sample_material_block against a dense numpy repeat-wrap bilinear."""

    def _reference(self, img, uv):
        h, w = img.shape[:2]
        u = uv[:, 0] * w - 0.5
        v = uv[:, 1] * h - 0.5
        iu, iv = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
        fu, fv = (u - iu)[:, None], (v - iv)[:, None]
        t00 = img[iv % h][np.arange(len(uv)), iu % w]
        t10 = img[iv % h][np.arange(len(uv)), (iu + 1) % w]
        t01 = img[(iv + 1) % h][np.arange(len(uv)), iu % w]
        t11 = img[(iv + 1) % h][np.arange(len(uv)), (iu + 1) % w]
        return (t00 * (1 - fu) * (1 - fv) + t10 * fu * (1 - fv)
                + t01 * (1 - fu) * fv + t11 * fu * fv)

    # one case, the plain gather; its id dates from a second, matmul-based
    # gather path that no longer exists
    @pytest.mark.parametrize("use_mm", [False])
    def test_wrap_bilinear(self, use_mm):
        from moonshine_tpu.scene import textures as TX

        rng = np.random.default_rng(5)
        img = rng.random((4, 6, 3)).astype(np.float32)
        b = TX.MaterialBlockBuilder()
        b.add(img, 0.25, 0.5, (0, 0, 0), (0.5, 0.5))
        atlas, rects, _ = b.build()
        # uvs straddling every wrap edge, incl. negatives and >1
        uv = np.array([[0.0, 0.0], [0.99, 0.99], [1.0, 1.0], [-0.3, 2.7],
                       [0.5, 0.5], [0.999, 0.001], [3.999, -0.001]],
                      np.float32)
        rect = jnp.broadcast_to(
            jnp.asarray(rects[0, 0], jnp.float32), (len(uv), 4))
        out = np.asarray(TX.sample_material_block(
            atlas.bsdf, rect, jnp.asarray(uv)))
        img_bf = np.asarray(jnp.asarray(img, jnp.bfloat16), np.float32)
        ref = self._reference(img_bf, uv)
        np.testing.assert_allclose(out[:, :3], ref, rtol=2e-2, atol=2e-3)
