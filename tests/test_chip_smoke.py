"""``chip_smoke.py`` on the CPU: its plain references, its checks, its exit
path without a GPU, and every solve of its phases at a tiny size.

The phases themselves are meant for a GPU at full size; here each runs the
same entry points and the same reference checks on small systems, so a
wrong path, argument or check shows up before a run on the card.
"""

import pathlib
import sys

import numpy as np
import pytest

import jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


# -- plain references and checks -------------------------------------------


def test_laplace2d_ref_matches_fixture():
    from krylov_tpu.sparse.fixtures import laplace2d

    ref = chip_smoke.laplace2d_ref(9).toarray()
    np.testing.assert_array_equal(laplace2d(9).to_dia().todense(), ref)


def test_laplace3d_ref_matches_fixture():
    from krylov_tpu.sparse.fixtures import laplace3d

    ref = chip_smoke.laplace3d_ref(5).toarray()
    np.testing.assert_array_equal(laplace3d(5).to_dia().todense(), ref)


def test_check_rejects_a_perturbed_solution():
    """A wrong answer cannot pass: perturb an exact solution by 1e-3 and
    the true-residual check must raise."""
    A = chip_smoke.laplace2d_ref(12)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    b = A @ x
    assert chip_smoke.check_true_residual(A, b, x, 1e-12, "exact") < 1e-12
    with pytest.raises(chip_smoke.PhaseFailure, match="true residual"):
        chip_smoke.check_true_residual(A, b, x * (1 + 1e-3), 1e-5, "perturbed")


def test_parse_smi_line():
    assert chip_smoke.parse_smi_line("NVIDIA H100 80GB HBM3, 700.00 W\n") == (
        "NVIDIA H100 80GB HBM3", "700.00 W",
    )
    with pytest.raises(ValueError):
        chip_smoke.parse_smi_line("NVIDIA H100 80GB HBM3")


def test_main_exits_nonzero_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_bench_exits_nonzero_without_gpu(capsys):
    import bench

    assert bench.main([]) != 0
    assert '"metric"' not in capsys.readouterr().out


# -- compile cache helper --------------------------------------------------


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    from krylov_tpu import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from krylov_tpu import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(ROOT / ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


# -- trace reduction ---------------------------------------------------------


def test_per_iteration_reduces_device_events():
    """Busy time is the union of overlapping events; copies are counted
    apart from kernels; idle share is the uncovered part of the window."""
    from krylov_tpu.diagnostics.profiling import per_iteration

    events = [
        ("fusion_1", 0, 100),
        ("fusion_2", 50, 100),  # overlaps fusion_1: busy 0-150
        ("Memcpy DtoH", 200, 50),  # busy 200-250
        ("fusion_1", 300, 100),  # busy 300-400
    ]
    s = per_iteration(events, 2)
    assert s["kernels_per_iter"] == 1.5
    assert s["copies_per_iter"] == 0.5
    assert s["busy_us_per_iter"] == pytest.approx(0.15)
    assert s["window_us_per_iter"] == pytest.approx(0.2)
    assert s["idle_share"] == pytest.approx(0.25)


# -- the phases at a tiny size ----------------------------------------------


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_phase_c1_f64(method):
    (rec,) = chip_smoke.phase_c1_f64(nx=24, methods=(method,))
    assert rec["true_residual"] < chip_smoke.TOL_F64
    assert abs(rec["iterations"] - rec["numpy_iterations"]) <= 5


def test_phase_c1_leak():
    recs = chip_smoke.phase_c1_leak(nx=24)
    assert recs[0]["iterations"] == recs[1]["iterations"] > 0


@pytest.mark.parametrize("method", ["cg", "adaptivekskipmrr"])
def test_phase_c2(method):
    (rec,) = chip_smoke.phase_c2(n=10, methods=(method,))
    assert rec["n"] == 1000 and rec["true_residual"] < chip_smoke.TOL


@pytest.mark.parametrize("solve", ["single", "batched"])
def test_phase_c3(solve):
    (rec,) = chip_smoke.phase_c3(n=2048, solves=(solve,), nrhs=3)
    key = "true_residual" if solve == "single" else "true_residual_max"
    assert rec[key] < chip_smoke.TOL
