"""GPU hardware tier — the translation of the reference's ``@Tag("gpu")`` +
``@EnabledIfSystemProperty`` tier (``GpuFrequencyServiceTest.java:13,39``).

Each ``gpu``-marked test runs one phase of ``chip_smoke.py`` on the card in a
clean subprocess (the rest of the suite pins this process to a virtual CPU
mesh).  They skip without an NVIDIA GPU; on the card run them with

    python -m pytest -m gpu tests/test_gpu_hardware.py

The unmarked tests check, on the CPU, that the smoke script refuses to run
without a GPU.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _card_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture
def gpu_card():
    """Skip unless nvidia-smi reports a card (decided here, at run time,
    never at import)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    probe = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if probe.returncode != 0 or "GPU" not in probe.stdout:
        pytest.skip("no NVIDIA GPU reported by nvidia-smi")
    return probe.stdout.splitlines()[0]


def _run_smoke(*args, env=None, cwd=REPO, script=SMOKE, timeout=1200):
    return subprocess.run(
        [sys.executable, script, *args], env=env or _card_env(), cwd=cwd,
        capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["device", "ops", "service", "cli"])
def test_smoke_phase_on_gpu(gpu_card, phase):
    proc = _run_smoke("--phase", phase)
    assert proc.returncode == 0, (
        f"chip_smoke --phase {phase} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    )
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


def test_smoke_refuses_cpu_only_jax():
    """Under JAX_PLATFORMS=cpu the smoke script exits non-zero and never
    prints a result line."""
    env = dict(_card_env(), JAX_PLATFORMS="cpu")
    proc = _run_smoke(env=env, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_smoke_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repository,
    the smoke script cannot import the program and fails."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    env = {k: v for k, v in _card_env().items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = _run_smoke(env=env, cwd=str(tmp_path), script=str(alone), timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
