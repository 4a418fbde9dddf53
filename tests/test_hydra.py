"""Hydra delegate layer: compiles and runs the USD-free delegate core
(native/hydra/hydra_core.cpp) against the real engine — a mock Hydra
session covering triangulation, primvar remapping, instancer products,
UsdPreviewSurface mapping, camera extraction, and the mesh-Sync reconcile
machine. The USD adapter classes themselves (renderDelegate.cpp etc.) need
a USD install and are syntax-gated here instead.

Parity surface: reference hydra/*.cpp (~900 LoC USD delegate)."""

import pathlib
import os
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
NATIVE = ROOT / "native"
HYDRA = NATIVE / "hydra"


@pytest.fixture(scope="module")
def native_lib():
    r = subprocess.run(["make", "-C", str(NATIVE)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        pytest.skip(f"native build failed: {r.stderr[-400:]}")
    return NATIVE / "libmoonshine_tpu.so"


@pytest.mark.slow
class TestHydraCore:
    def test_mock_hydra_session(self, native_lib):
        """Build + run the mock-Hydra e2e binary (embedded engine)."""
        r = subprocess.run(["make", "-C", str(NATIVE),
                            "hydra/test_hydra_core"],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-500:]
        env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
        r = subprocess.run([str(HYDRA / "test_hydra_core")],
                           capture_output=True, text=True, env=env,
                           timeout=280)
        assert r.returncode == 0, (r.stdout[-300:], r.stderr[-800:])
        assert "hydra core ok" in r.stdout


class TestHydraSources:
    def test_usd_adapter_sources_present(self):
        """The compile-gated USD adapter layer is complete on disk."""
        for name in ["renderDelegate", "renderPass", "renderBuffer",
                     "mesh", "material", "instancer", "camera",
                     "rendererPlugin"]:
            assert (HYDRA / f"{name}.cpp").exists(), name
        assert (HYDRA / "plugInfo.json").exists()
        assert (HYDRA / "blender.py").exists()

    def test_usd_adapters_compile_against_stub_api(self):
        """Every USD adapter TU goes through g++ against the vendored
        pxr API-surface stubs (native/usd_stub/) — wrong override
        signatures, misspelled members, or bad include paths fail here
        like they would against a real USD install. (No USD distribution
        exists in this environment and there is no network egress, so
        the real `make hydra` link target cannot run; this is the
        closest reachable compile check.)"""
        subprocess.run(["make", "-C", str(NATIVE), "clean-stubcheck"],
                       capture_output=True, text=True)
        r = subprocess.run(["make", "-C", str(NATIVE), "hydra-syntax"],
                           capture_output=True, text=True, timeout=280)
        assert r.returncode == 0, (r.stdout[-400:], r.stderr[-1200:])
