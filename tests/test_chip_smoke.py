"""chip_smoke.py: its phases at a tiny size on the CPU, and its refusal to
report success without a GPU."""

import os
import subprocess
import sys

import pytest

import chip_smoke

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = 20_000


@pytest.fixture
def recorded_sorts(monkeypatch):
    """Sort-program recording, undone after the test."""
    from andix.chain import evpack
    from andix.esa import doubling, subject_index

    for mod, name in ((doubling, "_sa_core"),
                      (subject_index, "fused_build"),
                      (evpack, "_encode_fn")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(chip_smoke, "_SORT_PROGRAMS", {})
    chip_smoke.record_sort_programs()


def test_main_refuses_cpu(monkeypatch, capsys):
    """With the CPU backend already up (as in this process), main() finds
    no GPU and refuses; a fresh process is the next test."""
    import jax

    jax.devices()
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # restored after the test
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_fails_under_cpu_platform():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_pair_and_family_phases(tmp_path, recorded_sorts, capsys,
                                monkeypatch):
    monkeypatch.setenv("ANDIX_SHARDED", "0")  # one device, as on one card
    (tmp_path / "pair").mkdir()
    (tmp_path / "family").mkdir()
    chip_smoke.phase_pair(str(tmp_path / "pair"), TINY)
    chip_smoke.phase_family(str(tmp_path / "family"), 3, TINY)
    rows = chip_smoke.phase_sorts()
    out = capsys.readouterr().out
    assert "pair jax cold vs numpy: byte-identical" in out
    assert "family auto vs " in out and "JC check: 2 pairs" in out
    assert "peak device memory not measured" in out
    programs = {r[0].split(" (")[0] for r in rows}
    assert {"joint SA", "subject SA", "event pack"} <= programs
    # XLA:CPU has no CUB: every sort is the comparator kernel
    assert {r[1] for r in rows} == {"comparator"}


def test_family_disagreement_fails(tmp_path, monkeypatch):
    """A schedule whose output differs must fail the phase."""
    monkeypatch.setenv("ANDIX_SHARDED", "0")
    real = chip_smoke.run_cli

    def skewed(argv, env=None):
        run = real(argv, env)
        if (env or {}).get("ANDIX_INDEX"):
            run.stdout = run.stdout.replace("0.0", "0.1", 1)
        return run

    monkeypatch.setattr(chip_smoke, "run_cli", skewed)
    with pytest.raises(chip_smoke.SmokeFailure, match="differ"):
        chip_smoke.phase_family(str(tmp_path), 3, TINY)


def test_jc_check_tolerance():
    stdout = "2\ng0 0.0 0.05\ng1 0.05 0.0\n"
    chip_smoke.check_jc(stdout, [0.0485])  # JC(0.0485) = 0.0502
    with pytest.raises(chip_smoke.SmokeFailure, match="simulated rate"):
        chip_smoke.check_jc(stdout, [0.03])


def test_sort_ops_parses_both_lowerings():
    hlo = "\n".join([
        "  %sort.1 = (s64[1024]{0}, s32[1024]{0}) sort(s64[1024]{0} %a, "
        "s32[1024]{0} %b), dimensions={0}, to_apply=%cmp",
        "  ROOT %custom-call.2 = (s64[4096]{0}, s32[4096]{0}, u8[99]{0}) "
        "custom-call(s64[4096]{0} %k, s32[4096]{0} %v), "
        'custom_call_target="__cub$DeviceRadixSort"',
        "  %custom-call.3 = f32[8]{0} custom-call(f32[8]{0} %x), "
        'custom_call_target="something_else"',
    ])
    assert chip_smoke.sort_ops(hlo) == [
        ("comparator", "(s64[1024]{0}, s32[1024]{0})"),
        ("cub", "(s64[4096]{0}, s32[4096]{0}, u8[99]{0})"),
    ]


@pytest.mark.gpu
def test_family_phase_on_gpu(gpu_device, tmp_path):
    """The family phase on the card at a tiny size (run there with
    ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``)."""
    chip_smoke.phase_family(str(tmp_path), 3, TINY)
