"""chip_smoke.py's phases at tiny sizes on the CPU.

On the card the same functions run at full size; here they prove the
control flow, the checks and the argument plumbing. main() itself must
refuse to run without a GPU and print no result."""

import json
import sys

import jax
import pytest

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))

import chip_smoke  # noqa: E402

TINY_ROOM = dict(grid=1, subdivisions=1)
SHALLOW = 1  # max_bounces: keeps the CPU compiles small


@pytest.fixture
def cache_env(monkeypatch, tmp_path):
    """main() defaults JAX_COMPILATION_CACHE_DIR; keep that out of the
    test process's environment."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))


def test_main_fails_without_gpu(cache_env, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    for line in capsys.readouterr().out.splitlines():
        assert not line.startswith("{"), line


def test_traversal_phase():
    # the oracle cases run in test_intersect.py
    out = chip_smoke.phase_traversal(
        room=TINY_ROOM, room_res=(16, 24), flag_res=(16, 16), frame_spp=1,
        resort_size=64, reps=1, oracle=False, max_bounces=SHALLOW)
    for name in ("room", "flagship"):
        assert set(out[name]) == {
            "closest_kernel_s", "closest_plain_s", "any_kernel_s",
            "any_plain_s", "frame_kernel_s", "frame_plain_s"}


def test_offline_phase():
    chip_smoke.phase_offline(size=16, spp=1, max_bounces=2)


def test_furnace_phase():
    # a handful of paths: only the plumbing and a loose mean
    chip_smoke.phase_furnace(size=16, spp=4, tol=0.05)


def test_flagship_phase():
    chip_smoke.phase_flagship(size=16, spp=2, other=jax.devices("cpu")[1],
                              max_bounces=SHALLOW)


def test_engine_phase_takes_staged_path(monkeypatch, capsys):
    from moonshine_tpu.render import renderer

    monkeypatch.setattr(renderer, "MAX_LANES", 256)  # 32x48 is "large"
    chip_smoke.phase_engine(room=TINY_ROOM, res=(32, 48), frames=1,
                            max_bounces=SHALLOW)
    assert "staged path True" in capsys.readouterr().out


def test_room_1m_phase():
    chip_smoke.phase_room_1m(room=TINY_ROOM, res=(16, 16),
                             max_bounces=SHALLOW)


def test_instanced_phase():
    chip_smoke.phase_instanced(size=16, spp=1)


def test_four_phase_on_virtual_devices():
    chip_smoke.phase_four(room=TINY_ROOM, res=(8, 16), spp=4,
                          devices=jax.devices()[:4], max_bounces=SHALLOW)


def test_oracle_cases_run_on_a_device():
    chip_smoke.run_oracle_cases(jax.devices()[0])


def test_check_raises_on_failure():
    with pytest.raises(AssertionError, match="bad"):
        chip_smoke.check("bad", False, "detail")


def test_result_line_format(cache_env, monkeypatch, capsys):
    """With a GPU, the last line is the JSON result naming the device."""
    dev = {"platform": "gpu", "kind": "NVIDIA H100", "count": 1}
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: dev)
    monkeypatch.setattr(chip_smoke, "PHASES", {"noop": lambda: None})
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": dev}
