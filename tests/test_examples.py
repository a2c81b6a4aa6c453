"""Smoke-run every example script (examples are imported by nothing else,
so they would rot unseen as the API grows keywords).

Each example runs as a fresh subprocess on the CPU backend (8 virtual
devices for the distributed one) and must exit 0 with converged output.
"""

import os
import pathlib
import subprocess
import sys

import pytest

_EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _run(name, extra_env=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    if extra_env:
        env.update(extra_env)
    proc = subprocess.run(
        [sys.executable, str(_EXAMPLES / name)],
        capture_output=True,
        text=True,
        env=env,
        timeout=600,
    )
    assert proc.returncode == 0, f"{name} failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


@pytest.mark.parametrize(
    "name",
    [
        "basic_solve.py",
        "distributed_solve.py",
        "preconditioned.py",
        "production_long_solve.py",
        "multi_rhs_solve.py",
    ],
)
def test_example_runs(name):
    out = _run(name)
    assert "diverged" not in out
    if name == "basic_solve.py":
        assert out.count("converged") == 5
    if name == "distributed_solve.py":
        assert "true relative residual" in out
    if name == "preconditioned.py":
        assert out.count("converged=True") == 12
    if name == "production_long_solve.py":
        assert "matches unbroken solve" in out
        assert "resumed: converged=True" in out
    if name == "multi_rhs_solve.py":
        assert out.count("converged=True") == 8
