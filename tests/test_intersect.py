"""The traversal entry point (accel/intersect.py), the CUDA kernel's node
and triangle records (accel/packed.py) and the kernel's build and backend
choice (accel/cuda.py).

Every traversal case runs against the brute-force oracle through three
implementations of the same walk:

  entry  intersect.py on this process's default backend (traverse.py on
         the CPU, the kernel on a GPU);
  twin   packed.py's numpy twin of the kernel's loop over its records;
  cuda   the entry point on a CUDA device: marked gpu, skips without one.
         chip_smoke.py runs CASES with the kernel on the card.
"""

from __future__ import annotations

import os
import stat
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moonshine_tpu.accel import cuda, intersect, lbvh, packed, traverse

from test_bvh import random_rays, random_tris


class Impl(NamedTuple):
    name: str  # "entry" | "twin" | "cuda"
    device: object = None

    def _put(self, *xs):
        return jax.device_put(xs, self.device) if self.device else xs

    def closest(self, acc, o, d, t_max, active=None):
        """(t, tri, u, v) numpy arrays."""
        if self.name == "twin":
            return packed.closest_hit_np(
                jax.device_get(acc.packed), np.asarray(acc.bvh.tri_order),
                o, d, t_max, active)
        args = self._put(acc, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t_max, jnp.float32), active)
        h = jax.jit(intersect.closest_hit)(*args)
        return tuple(np.asarray(x) for x in (h.t, h.tri, h.u, h.v))

    def any(self, acc, o, d, t_max, active=None):
        if self.name == "twin":
            return packed.any_hit_np(jax.device_get(acc.packed), o, d, t_max,
                                     active)
        args = self._put(acc, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t_max, jnp.float32), active)
        return np.asarray(jax.jit(intersect.any_hit)(*args))


def make_accel(tris, builder="karras", refs=None):
    if builder == "karras":
        bvh = lbvh.build(tris, as_numpy=True)
    else:
        bvh = lbvh.build_sah(tris, as_numpy=True, refs=refs)
    return intersect.device_accel(bvh, tris)


def oracle(tris, o, d, t_max=1e12):
    h = traverse.brute_force_closest(jnp.asarray(tris), jnp.asarray(o),
                                     jnp.asarray(d), t_max)
    return np.asarray(h.t), np.asarray(h.tri)


def assert_matches_oracle(got, want, active=None):
    t, tri, u, v = got
    want_t, want_tri = want
    hit = want_tri >= 0
    if active is not None:
        hit &= np.asarray(active)
    lanes = np.ones(len(tri), bool) if active is None else np.asarray(active)
    np.testing.assert_array_equal(tri[lanes] >= 0, hit[lanes])
    np.testing.assert_allclose(t[hit], want_t[hit], rtol=1e-4, atol=1e-5)
    if hit.any():  # the triangle may differ only on exact ties
        assert (tri[hit] == want_tri[hit]).mean() > 0.99
    miss = lanes & ~hit
    np.testing.assert_array_equal(t[miss], want_t[miss])  # == t_max


# --- traversal cases (each runs for every implementation) ---

def check_closest_matches_oracle(impl, n_tris, seed, builder="karras"):
    tris = random_tris(n_tris, seed=seed)
    o, d = random_rays(256, seed=seed + 10)
    got = impl.closest(make_accel(tris, builder), o, d, 1e12)
    assert_matches_oracle(got, oracle(tris, o, d))


def check_active_mask(impl):
    tris = random_tris(100, seed=6)
    o, d = random_rays(128, seed=7)
    active = np.arange(128) % 3 == 0
    t, tri, u, v = impl.closest(make_accel(tris), o, d, 7.5,
                                jnp.asarray(active))
    off = ~active
    assert (tri[off] == -1).all()
    assert (t[off] == np.float32(7.5)).all()
    assert (u[off] == 0).all() and (v[off] == 0).all()
    assert_matches_oracle((t, tri, u, v), oracle(tris, o, d, 7.5), active)
    occ = impl.any(make_accel(tris), o, d, 1e12, jnp.asarray(active))
    assert not occ[off].any()


def check_any_hit_matches_closest(impl):
    tris = random_tris(400, seed=8)
    o, d = random_rays(512, seed=9)
    acc = make_accel(tris)
    _, want_tri = oracle(tris, o, d)
    np.testing.assert_array_equal(impl.any(acc, o, d, 1e12), want_tri >= 0)


def check_any_hit_tmax(impl):
    tris = random_tris(200, seed=10)
    o, d = random_rays(256, seed=11)
    acc = make_accel(tris)
    want_t, want_tri = oracle(tris, o, d)
    hit = want_tri >= 0
    short = np.where(hit, want_t * 0.999, 1e12).astype(np.float32)
    assert not impl.any(acc, o, d, short)[hit].any()
    longer = np.where(hit, want_t * 1.001, 1e-3).astype(np.float32)
    assert impl.any(acc, o, d, longer)[hit].all()


def check_closest_tmax(impl):
    """Per-lane t_max: hits beyond it are misses that return t_max."""
    tris = random_tris(300, seed=12)
    o, d = random_rays(300, seed=13)
    t_max = np.random.RandomState(14).uniform(0.5, 12.0, 300)
    t_max = t_max.astype(np.float32)
    got = impl.closest(make_accel(tris), o, d, t_max)
    assert_matches_oracle(got, oracle(tris, o, d, t_max))


def check_ray_count(impl, n_rays):
    """Lane counts that are not multiples of the kernel's block."""
    tris = random_tris(64, seed=15)
    o, d = random_rays(n_rays, seed=16)
    got = impl.closest(make_accel(tris), o, d, 1e12)
    assert got[0].shape == (n_rays,)
    assert_matches_oracle(got, oracle(tris, o, d))


def check_presplit_refs(impl):
    """SBVH spatial splits: large walls become several clipped references
    (duplicate sorted slots); leaves intersect full triangles, so hits are
    those of the plain build."""
    rs = np.random.RandomState(23)
    c = rs.rand(300, 1, 3).astype(np.float32) * 10
    tris = c + (rs.rand(300, 3, 3).astype(np.float32) - 0.5) * 0.4
    walls = np.asarray([
        [[0, 0, 0], [10, 0, 0], [10, 10, 0]],
        [[0, 0, 0], [10, 10, 0], [0, 10, 0]],
        [[0, 0, 10], [10, 0, 10], [10, 10, 10]],
    ], np.float32)
    tris = np.concatenate([tris, walls])
    refs = lbvh.presplit_refs(tris, max_refs_factor=1.5)
    assert len(refs[0]) > len(tris)  # the walls actually split
    acc = make_accel(tris, "sah", refs=refs)
    assert acc.packed.tris.shape[0] == len(refs[0])
    o, d = random_rays(512, seed=24)
    o = o * 0.5 + 5.0
    assert_matches_oracle(impl.closest(acc, o, d, 1e12), oracle(tris, o, d))
    _, want_tri = oracle(tris, o, d, 6.0)
    np.testing.assert_array_equal(impl.any(acc, o, d, 6.0), want_tri >= 0)


def check_zero_rays(impl):
    tris = random_tris(20, seed=17)
    o = np.zeros((0, 3), np.float32)
    t, tri, u, v = impl.closest(make_accel(tris), o, o, 1e12)
    assert t.shape == tri.shape == u.shape == v.shape == (0,)
    assert impl.any(make_accel(tris), o, o, 1e12).shape == (0,)


CASES = [
    ("closest_37", check_closest_matches_oracle, dict(n_tris=37, seed=4)),
    ("closest_700", check_closest_matches_oracle, dict(n_tris=700, seed=5)),
    ("closest_sah_700", check_closest_matches_oracle,
     dict(n_tris=700, seed=5, builder="sah")),
    ("single_leaf", check_closest_matches_oracle, dict(n_tris=3, seed=3)),
    ("active_mask", check_active_mask, {}),
    ("any_matches_closest", check_any_hit_matches_closest, {}),
    ("any_tmax", check_any_hit_tmax, {}),
    ("closest_tmax", check_closest_tmax, {}),
    ("rays_1", check_ray_count, dict(n_rays=1)),
    ("rays_129", check_ray_count, dict(n_rays=129)),
    ("rays_1000", check_ray_count, dict(n_rays=1000)),
    ("presplit_refs", check_presplit_refs, {}),
    ("zero_rays", check_zero_rays, {}),
]


@pytest.fixture(params=["entry", "twin",
                        pytest.param("cuda", marks=pytest.mark.gpu)])
def impl(request):
    if request.param == "cuda":
        return Impl("cuda", request.getfixturevalue("gpu_device"))
    return Impl(request.param)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_traversal_case(impl, case):
    _, fn, kwargs = case
    fn(impl, **kwargs)


# --- the kernel's records ---

@pytest.mark.parametrize("builder", ["karras", "sah"])
def test_node_records_roundtrip(builder):
    tris = random_tris(300, seed=30)
    bvh = (lbvh.build(tris, as_numpy=True) if builder == "karras"
           else lbvh.build_sah(tris, as_numpy=True))
    nodes = packed.pack_nodes(bvh.aabb_min, bvh.aabb_max, bvh.left,
                              bvh.count, bvh.escape)
    assert nodes.shape == (len(bvh.left), 8) and nodes.dtype == np.int32
    for i in range(bvh.num_nodes):
        lo, hi, leaf, link, count, esc = packed.unpack_node(nodes[i])
        np.testing.assert_array_equal(lo, bvh.aabb_min[i])
        np.testing.assert_array_equal(hi, bvh.aabb_max[i])
        assert leaf == (bvh.count[i] > 0)
        assert link == bvh.left[i] and count == bvh.count[i]
        assert esc == bvh.escape[i]


def test_tri_records_hold_vertex_and_edges():
    v = random_tris(50, seed=31)
    rec = packed.pack_tris(v)
    assert rec.shape == (50, 12) and rec.dtype == np.float32
    np.testing.assert_array_equal(rec[:, 0:3], v[:, 0])
    np.testing.assert_array_equal(rec[:, 4:7], v[:, 1] - v[:, 0])
    np.testing.assert_array_equal(rec[:, 8:11], v[:, 2] - v[:, 0])
    assert (rec[:, 3::4] == 0).all()


def test_pack_rejects_oversized_leaf():
    z = np.zeros((1, 3), np.float32)
    with pytest.raises(ValueError, match="more than"):
        packed.pack_nodes(z, z, [0], [packed._MAX_LEAF_COUNT + 1], [-1])


def test_pack_rejects_offset_overflow():
    z = np.zeros((1, 3), np.float32)
    with pytest.raises(ValueError, match="offset"):
        packed.pack_nodes(z, z, [packed._MAX_LEAF_OFFSET + 1], [1], [-1])


@pytest.mark.parametrize("builder", ["karras", "sah"])
def test_device_accel_shapes(builder):
    tris = random_tris(500, seed=32)
    acc = make_accel(tris, builder)
    m = acc.bvh.left.shape[0]
    assert acc.packed.nodes.shape == (m, 8)
    assert acc.packed.nodes.dtype == jnp.int32
    assert acc.packed.tris.shape == (500, 12)
    assert acc.packed.tris.dtype == jnp.float32
    assert acc.tri_verts_sorted.shape == (500, 3, 3)
    assert isinstance(acc.packed.nodes, jax.Array)
    assert acc.tlas is None


def test_refit_keeps_topology_arrays():
    tris = random_tris(200, seed=33)
    bvh = lbvh.build(tris, as_numpy=True)
    acc = intersect.device_accel(bvh, tris)
    moved = tris + np.float32([0.0, 0.0, 1.5])
    lo, hi = lbvh.refit_host(bvh.left, bvh.count, bvh.escape, bvh.tri_order,
                             moved)
    acc2 = intersect.device_accel(bvh._replace(aabb_min=lo, aabb_max=hi),
                                  moved, topology=acc.bvh)
    assert acc2.bvh.left is acc.bvh.left
    assert acc2.bvh.tri_order is acc.bvh.tri_order
    np.testing.assert_array_equal(np.asarray(acc2.bvh.aabb_min), lo)
    o, d = random_rays(128, seed=34)
    got = packed.closest_hit_np(jax.device_get(acc2.packed),
                                np.asarray(acc2.bvh.tri_order), o, d, 1e12)
    assert_matches_oracle(got, oracle(moved, o, d))


# --- the entry point's wrapper and backend choice ---

def test_entry_broadcasts_lanes():
    tris = random_tris(40, seed=35)
    acc = make_accel(tris)
    o, d = random_rays(37, seed=36)
    h = intersect.closest_hit(acc, o, d, 3.0)
    assert h.t.shape == h.tri.shape == h.u.shape == h.v.shape == (37,)
    assert (h.t.dtype, h.tri.dtype, h.u.dtype) == (
        jnp.float32, jnp.int32, jnp.float32)
    assert h.inst is None
    occ = intersect.any_hit(acc, o, d, 3.0)
    assert occ.shape == (37,) and occ.dtype == jnp.bool_


def _lowered(fn, platforms=None):
    tris = random_tris(30, seed=37)
    acc = make_accel(tris)
    o, d = random_rays(8, seed=38)
    traced = jax.jit(lambda a, o, d: fn(a, o, d, 5.0)).trace(acc, o, d)
    if platforms is None:
        return traced.lower().as_text()
    return traced.lower(lowering_platforms=platforms).as_text()


@pytest.mark.parametrize("fn,target", [
    (intersect.closest_hit, cuda.CLOSEST_TARGET),
    (intersect.any_hit, cuda.ANY_TARGET),
], ids=["closest", "any"])
def test_cuda_lowering_calls_the_kernel(fn, target):
    text = _lowered(fn, ("cuda",))
    assert target in text and "stablehlo.while" not in text


@pytest.mark.parametrize("fn,target", [
    (intersect.closest_hit, cuda.CLOSEST_TARGET),
    (intersect.any_hit, cuda.ANY_TARGET),
], ids=["closest", "any"])
def test_cpu_lowering_walks_in_jax(fn, target):
    text = _lowered(fn)
    assert target not in text and "stablehlo.while" in text


def test_scene_without_records_walks_in_jax_everywhere():
    tris = random_tris(30, seed=39)
    acc = make_accel(tris)._replace(packed=None)
    o, d = random_rays(8, seed=40)
    text = jax.jit(lambda a, o, d: intersect.closest_hit(a, o, d, 5.0)).trace(
        acc, o, d).lower(lowering_platforms=("cuda",)).as_text()
    assert cuda.CLOSEST_TARGET not in text


@pytest.fixture
def no_cuda_toolkit(monkeypatch, tmp_path):
    """A process that has a CUDA backend but no nvcc and no library."""
    monkeypatch.setattr(cuda, "_cuda_backend_present", lambda: True)
    monkeypatch.setattr(cuda, "_lib", None)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda, "CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))


@pytest.mark.parametrize("fn", [intersect.closest_hit, intersect.any_hit],
                         ids=["closest", "any"])
def test_gpu_without_kernel_raises(no_cuda_toolkit, fn):
    """With a CUDA backend, a kernel that cannot be built is an error,
    never a quiet fallback to the JAX walk (tracing stages the kernel's
    branch on every platform, so this raises even on the CPU)."""
    tris = random_tris(30, seed=41)
    o, d = random_rays(8, seed=42)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        jax.jit(fn)(make_accel(tris), o, d, 5.0)


def _fake_nvcc(tmp_path, body: str):
    exe = tmp_path / "bin" / "nvcc"
    exe.parent.mkdir(parents=True, exist_ok=True)
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    return exe


def test_build_reports_nvcc_failure(no_cuda_toolkit, tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, "echo 'error: no sm_90a here' >&2\nexit 2\n")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        cuda.build()
    assert not list((tmp_path / "build").glob("*"))


def test_build_compiles_for_sm90a(no_cuda_toolkit, tmp_path, monkeypatch):
    """nvcc gets the Hopper target and JAX's FFI headers; the library
    lands under its source-hash name."""
    log = tmp_path / "args"
    _fake_nvcc(tmp_path, f'echo "$@" > {log}\n'
               'while [ "$1" != "-o" ]; do shift; done; : > "$2"\n')
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    path = cuda.build()
    assert path == cuda.library_path() and path.exists()
    args = log.read_text()
    assert "arch=compute_90a,code=sm_90a" in args
    assert jax.ffi.include_dir() in args
    assert str(cuda.KERNEL_DIR / "traverse.cu") in args


def test_build_reuses_existing_library(no_cuda_toolkit, tmp_path,
                                       monkeypatch):
    _fake_nvcc(tmp_path, "exit 1\n")  # must not be called
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    path = cuda.library_path()
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    assert cuda.build() == path


def test_library_name_tracks_sources(tmp_path, monkeypatch):
    """A changed source gives a new library name, so a stale build is
    never loaded."""
    before = cuda.library_path()
    kdir = tmp_path / "kernels"
    kdir.mkdir()
    for name in cuda.SOURCES:
        src = (cuda.KERNEL_DIR / name).read_text()
        (kdir / name).write_text(src + "\n// changed\n")
    monkeypatch.setattr(cuda, "KERNEL_DIR", kdir)
    after = cuda.library_path()
    assert after != before
    assert after.parent == before.parent
    assert os.path.basename(after).startswith("libmsn_traverse-")
