"""chip_smoke.py refuses to run anywhere but on a GPU inside a checkout:
it exits non-zero and prints no result line on a CPU-only machine, with
the GPU excluded by JAX_PLATFORMS, or when copied out of the repository."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(script, env_update, cwd):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(env_update)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )


@pytest.mark.parametrize("env", [
    {"JAX_PLATFORMS": "cpu"},  # the GPU is excluded
    {"PATH": ""},  # no nvidia-smi: no card to run on
])
def test_refuses_without_gpu(env):
    out = _run(SCRIPT, env, ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert out.stdout.strip() == ""


def test_refuses_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    out = _run(str(lone), {}, str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert not (tmp_path / ".smoke_data").exists()
