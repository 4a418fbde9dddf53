"""Statistical & cross-validation tests.

The reference wishes for "proper statistical tests ... of the mean/variance
of images" (README TODO); this file provides them, plus cross-validation
between the two traversal implementations (the CUDA kernel's records,
walked by their numpy twin, vs the jnp while_loop) — valuable because
they share no intersection code.
"""

import numpy as np
import pytest

from moonshine_tpu.integrator import PathConfig
from moonshine_tpu.render.renderer import render
from moonshine_tpu.scene import gltf

from glb_builder import cornell_box_glb


@pytest.fixture(scope="module")
def cornell():
    world = gltf.world_from_glb(cornell_box_glb())
    world.set_background(np.zeros((4, 8, 3), np.float32))
    lens = gltf.lens_from_glb(cornell_box_glb())
    return world.build(), lens


CFG = PathConfig(max_bounces=4, env_samples_per_bounce=0,
                 mesh_samples_per_bounce=1, unroll=False)


class TestCrossValidation:
    def test_packet_matches_jnp_traversal(self, cornell):
        """The scene's kernel records, walked by the numpy twin of the
        CUDA loop, against the traversal entry point (the jnp walk on the
        CPU) on the cornell's camera rays and on rays leaving the hits."""
        import jax

        from moonshine_tpu.accel import intersect, packed
        from moonshine_tpu.render.camera import LensArrays
        from moonshine_tpu.render.renderer import _sample_rays

        scene, lens = cornell
        o, d, _ = _sample_rays(LensArrays.from_lens(lens), 24, 24, 0, True)
        h = intersect.closest_hit(scene, o, d, 1e12)
        p = np.asarray(o + h.t[:, None] * d * 0.999)
        d2 = np.asarray(-d)  # back out of the box through the hit point
        recs = jax.device_get(scene.packed)
        order = np.asarray(scene.bvh.tri_order)
        for ro, rd in ((np.asarray(o), np.asarray(d)), (p, d2)):
            want = intersect.closest_hit(scene, ro, rd, 1e12)
            t, tri, _, _ = packed.closest_hit_np(recs, order, ro, rd, 1e12)
            # tiny t differences may flip a rare edge tie
            assert (tri == np.asarray(want.tri)).mean() > 0.995
            np.testing.assert_allclose(t, np.asarray(want.t), rtol=1e-5)
            np.testing.assert_array_equal(
                packed.any_hit_np(recs, ro, rd, 1.0),
                np.asarray(intersect.any_hit(scene, ro, rd, 1.0)))

    def test_deterministic_across_runs(self, cornell):
        scene, lens = cornell
        s1, _ = render(scene, lens, 16, 16, spp=4, cfg=CFG)
        s2, _ = render(scene, lens, 16, 16, spp=4, cfg=CFG)
        np.testing.assert_array_equal(
            np.asarray(s1.image), np.asarray(s2.image)
        )


class TestImageStatistics:
    def test_independent_halves_agree(self, cornell):
        """Two disjoint sample ranges estimate the same image: their
        difference must be pure Monte Carlo noise, shrinking ~1/sqrt(N)."""
        scene, lens = cornell
        spp = 24
        sensor_a, _ = render(scene, lens, 24, 24, spp=spp, cfg=CFG)
        # second, disjoint sample range: continue from a fresh sensor whose
        # first sample index is offset via sample_count
        from moonshine_tpu.render.sensor import Sensor
        import jax.numpy as jnp

        start = Sensor.create(24, 24)._replace(
            sample_count=jnp.asarray(0, jnp.int32)
        )
        sensor_b, _ = render(scene, lens, 24, 24, spp=spp, cfg=CFG,
                             sensor=Sensor(
                                 image=jnp.zeros((24, 24, 3)),
                                 sample_count=jnp.asarray(0, jnp.int32),
                             ))
        a = np.asarray(sensor_a.image)
        # render range [spp, 2*spp) by continuing accumulation then undoing
        sensor_ab, _ = render(scene, lens, 24, 24, spp=spp, cfg=CFG,
                              sensor=sensor_a)
        ab = np.asarray(sensor_ab.image)
        b = 2 * ab - a  # mean of the second half alone
        diff = a - b
        rmse = float(np.sqrt((diff ** 2).mean()))
        mean_level = max(float(a.mean()), 1e-6)
        assert rmse < 0.6 * mean_level, f"halves disagree: rmse {rmse:.4f}"
        # and the means must agree much more tightly than pixels
        assert abs(a.mean() - b.mean()) < 0.05 * mean_level

    def test_variance_decreases_with_spp(self, cornell):
        scene, lens = cornell
        s_lo, _ = render(scene, lens, 16, 16, spp=4, cfg=CFG)
        s_hi, _ = render(scene, lens, 16, 16, spp=32, cfg=CFG)
        ref, _ = render(scene, lens, 16, 16, spp=64, cfg=CFG,
                        sensor=s_hi)  # 96-sample reference
        r = np.asarray(ref.image)
        err_lo = np.sqrt(((np.asarray(s_lo.image) - r) ** 2).mean())
        err_hi = np.sqrt(((np.asarray(s_hi.image) - r) ** 2).mean())
        assert err_hi < err_lo, (err_lo, err_hi)


if __name__ == "__main__":
    pytest.main([__file__, "-q", "-x"])
