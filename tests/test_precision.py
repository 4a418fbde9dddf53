"""Small matrix-vector products run as float32 multiply-adds, not dots.

On the GPU XLA may run an f32 dot in TF32 (about 10 mantissa bits), enough
to move a transformed ray origin to the wrong side of a surface. Each
transform on the render path is checked against float64 numpy, and its
lowering must contain no dot at all."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moonshine_tpu.accel import tlas
from moonshine_tpu.core.frame import Frame
from moonshine_tpu.core.mathutil import mat_vec, transform_dir, transform_point
from moonshine_tpu.integrator import path

N = 64
RS = np.random.RandomState(0)
M34 = RS.randn(N, 3, 4).astype(np.float32) * 3 + np.float32([0, 0, 0, 900])
V3 = (RS.randn(N, 3) * 50).astype(np.float32)
CORNERS = (RS.randn(N, 3, 3) * 50).astype(np.float32)
INV = RS.randn(4, 12).astype(np.float32)
TF = np.concatenate([RS.randn(4, 12), np.ones((4, 1))], 1).astype(np.float32)
INST = RS.randint(0, 4, N).astype(np.int32)


def _f64(x):
    return np.asarray(x, np.float64)


def _obj_ray():
    t = SimpleNamespace(inst_inv=jnp.asarray(INV), num_instances=4)
    return tlas._obj_ray(t, jnp.asarray(INST), jnp.asarray(V3),
                         jnp.asarray(V3[::-1].copy()))


def _obj_ray_ref():
    inv = _f64(INV)[INST]
    r = inv[:, :9].reshape(-1, 3, 3)
    return (np.einsum("nij,nj->ni", r, _f64(V3)) + inv[:, 9:12],
            np.einsum("nij,nj->ni", r, _f64(V3[::-1])))


def _inst_world():
    scene = SimpleNamespace(inst_tf=jnp.asarray(TF),
                            tlas=SimpleNamespace(inst_inv=jnp.asarray(INV)))
    return path._inst_world(scene, jnp.asarray(INST), jnp.asarray(CORNERS),
                            jnp.asarray(CORNERS))[:2]


def _inst_world_ref():
    tf, inv = _f64(TF)[INST], _f64(INV)[INST]
    lin = tf[:, :9].reshape(-1, 3, 3)
    corners = np.einsum("nij,nkj->nki", lin, _f64(CORNERS)) + tf[:, None, 9:12]
    nrm = np.einsum("nji,nkj->nki", inv[:, :9].reshape(-1, 3, 3),
                    _f64(CORNERS))
    return corners, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


UNIT = V3 / np.linalg.norm(V3, axis=-1, keepdims=True)


def _frame():
    return tuple(Frame.from_normal(jnp.asarray(UNIT)).transform(
        jnp.asarray(M34[:, :, :3])))


def _frame_ref():
    f = Frame.from_normal(jnp.asarray(UNIT))
    out = []
    for v in (f.n, f.s, f.t):
        w = np.einsum("nij,nj->ni", _f64(M34[:, :, :3]), _f64(v))
        out.append(w / np.linalg.norm(w, axis=-1, keepdims=True))
    return tuple(out)


def _linear_ref():
    return (np.einsum("nij,nj->ni", _f64(M34[:, :, :3]), _f64(V3)),)


# name -> (the repo's float32 transform, its float64 reference)
CASES = {
    "mat_vec": (lambda: (mat_vec(jnp.asarray(M34[:, :, :3]),
                                 jnp.asarray(V3)),), _linear_ref),
    "transform_point": (
        lambda: (transform_point(jnp.asarray(M34), jnp.asarray(V3)),),
        lambda: (_linear_ref()[0] + _f64(M34[:, :, 3]),)),
    "transform_dir": (
        lambda: (transform_dir(jnp.asarray(M34), jnp.asarray(V3)),),
        _linear_ref),
    "frame_transform": (_frame, _frame_ref),
    "tlas_obj_ray": (_obj_ray, _obj_ray_ref),
    "inst_world": (_inst_world, _inst_world_ref),
}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_float64(name):
    fn, ref = CASES[name]
    got, want = fn(), ref()
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), w,
                                   rtol=2e-6, atol=2e-6 * np.abs(w).max())


@pytest.mark.parametrize("name", list(CASES))
def test_lowers_without_a_dot(name):
    text = jax.jit(CASES[name][0]).lower().as_text()
    assert "dot_general" not in text
