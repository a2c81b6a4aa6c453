"""``chip_smoke.py`` C1-sweep at a tiny size on the CPU: one case per
method, each through ``solve(restarts=2)`` and the host float64 check."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("method", sorted(chip_smoke.C1_METHODS))
def test_phase_c1_sweep(method):
    (rec,) = chip_smoke.phase_c1_sweep(nx=24, methods=(method,))
    assert rec["solve"] == method and rec["n"] == 576
    assert rec["true_residual"] < chip_smoke.TOL
