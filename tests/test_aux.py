"""Auxiliary subsystems: checkpoint/resume, profiling, batched API exports."""

import numpy as np

import krylov_tpu
from krylov_tpu import checkpoint
from krylov_tpu.diagnostics import profiling
from krylov_tpu.sparse.fixtures import laplace2d


def test_checkpoint_roundtrip_and_resume(tmp_path):
    A = laplace2d(16)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n)
    b = A.todense() @ x_true

    # partial solve, checkpoint, resume
    x_partial, info1 = krylov_tpu.solve(A, b, method="cg", tol=1e-12, maxiter=10)
    assert not info1["converged"]
    ckpt = tmp_path / "solve.npz"
    checkpoint.save(str(ckpt), x_partial, info1, problem="lap16")

    x_loaded, state = checkpoint.load(str(ckpt))
    np.testing.assert_array_equal(x_loaded, x_partial)
    assert state["meta"]["problem"] == "lap16"
    assert state["meta"]["iterations"] == 10

    x, info2 = checkpoint.resume(A, b, str(ckpt), method="cg", tol=1e-10)
    assert info2["converged"]
    assert info2["resumed_from"]["prior_iterations"] == 10
    np.testing.assert_allclose(x, x_true, rtol=1e-6, atol=1e-8)
    # warm start should need fewer iterations than from scratch
    _, info_cold = krylov_tpu.solve(A, b, method="cg", tol=1e-10)
    assert info2["iterations"] < info_cold["iterations"]


def test_phase_times():
    A = laplace2d(12)
    b = np.ones(A.shape[0])
    t = profiling.phase_times(A, b, method="cg", tol=1e-8, maxiter=500)
    assert t["converged"]
    assert t["solve_s"] <= t["compile_plus_first_solve_s"]
    assert t["iterations"] > 0
