"""Build, load and call the CUDA traversal kernels (kernels/traverse.cu).

The shared library is compiled with nvcc from the sources committed next
to this file into `_build/` (listed in .gitignore), named by a hash of the
sources, the compiler flags and the JAX version, so a stale library is
never loaded. It is built at first use on a machine with a CUDA backend,
or ahead of time with:

    python -m moonshine_tpu.accel.cuda

A failure to build or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp

from .packed import PackedBVH
from .traverse import Hit

KERNEL_DIR = Path(__file__).resolve().parent / "kernels"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("traverse.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
CUDA_HOME = Path("/usr/local/cuda")

CLOSEST_TARGET = "msn_closest_hit"
ANY_TARGET = "msn_any_hit"
_SYMBOLS = {CLOSEST_TARGET: "MsnClosestHit", ANY_TARGET: "MsnAnyHit"}

_lib = None  # keeps the loaded library alive once its targets are registered


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((KERNEL_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(jax.__version__.encode())
    return BUILD_DIR / f"libmsn_traverse-{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or str(CUDA_HOME / "bin" / "nvcc")
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in "
            f"{CUDA_HOME / 'bin'}): cannot build the CUDA traversal kernels")
    return nvcc


def build() -> Path:
    """Compile the library unless this exact version already exists."""
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", str(tmp),
           *(str(KERNEL_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def load() -> None:
    """Build if needed, load, and register the FFI targets for CUDA."""
    global _lib
    if _lib is not None:
        return
    lib = ctypes.cdll.LoadLibrary(str(build()))
    for target, symbol in _SYMBOLS.items():
        jax.ffi.register_ffi_target(
            target, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA")
    _lib = lib


def _cuda_backend_present() -> bool:
    try:
        jax.devices("cuda")
    except RuntimeError:
        return False
    return True


def _ensure_registered() -> None:
    # The kernel branch is traced on every platform (lax.platform_dependent
    # stages all branches) but lowered only for CUDA, and lowering for CUDA
    # needs a CUDA backend in this process. So the library is loaded exactly
    # when it can be used, and any failure to do so raises.
    if _cuda_backend_present():
        load()


def closest_hit(packed: PackedBVH, tri_order, ray_o, ray_d, t_max,
                active) -> Hit:
    """Kernel call; t_max [N] f32 and active [N] bool already broadcast."""
    _ensure_registered()
    n = ray_o.shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    t, tri, u, v = jax.ffi.ffi_call(
        CLOSEST_TARGET, (f32, i32, f32, f32), vmap_method="sequential",
    )(packed.nodes, packed.tris, tri_order, ray_o, ray_d, t_max, active)
    return Hit(t=t, tri=tri, u=u, v=v)


def any_hit(packed: PackedBVH, ray_o, ray_d, t_max, active):
    _ensure_registered()
    n = ray_o.shape[0]
    return jax.ffi.ffi_call(
        ANY_TARGET, jax.ShapeDtypeStruct((n,), jnp.bool_),
        vmap_method="sequential",
    )(packed.nodes, packed.tris, ray_o, ray_d, t_max, active)


if __name__ == "__main__":
    print(build())
