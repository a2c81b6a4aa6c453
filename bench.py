"""Benchmark harness: MrR on the 2-D 5-point Laplacian, N=250k, float32,
one GPU (BASELINE.md config 2).

    python bench.py [--seed 0]

Prints the GPU's name and power limit, then ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "extra": {...}}

``value`` is the median wall time of a single ``solve_device`` dispatch on a
fresh right-hand side, timed to ``jax.block_until_ready``; compilation is
timed apart.  ``vs_baseline`` is the speedup over a NumPy/SciPy float64
implementation with the reference's semantics (per-iteration Python loop),
measured in the same run.  Further stages, each recorded in ``extra`` (a
stage that raises records ``<stage>_error`` and the rest still run):

* fidelity — ``solve(restarts=2)`` and its true residual in host float64;
* spmv — SpMV rate from the slope of two ``fori_loop`` trip counts;
* amortized — 8 right-hand sides solved in one jitted dispatch, wall / 8;
* solve_api — wall time of the public ``solve()`` including transfers.

Every input comes from ``--seed``.  Without a GPU the script exits non-zero.
"""

import argparse
import json
import math
import sys
import time

import numpy as np

from chip_smoke import laplace2d_ref, mrr_ref, parse_smi_line, query_gpus

NX = 500  # N = 250,000
TOL = 1e-5
MAXITER = 3000
NRHS = 8
DTYPE = np.float32


def _finite(obj):
    """Strict-JSON sanitizer: NaN/inf floats become strings."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, found {dev.platform!r}", file=sys.stderr)
        return 2
    smi = query_gpus()
    print(smi[0], flush=True)
    name, limit = parse_smi_line(smi[0])

    import jax.numpy as jnp
    from jax import lax

    import krylov_tpu
    from krylov_tpu.compile_cache import enable_compile_cache
    from krylov_tpu.sparse.fixtures import laplace2d

    enable_compile_cache()
    rng = np.random.default_rng(args.seed)
    extra = {"gpu": name, "power_limit": limit, "device_kind": dev.device_kind,
             "dtype": np.dtype(DTYPE).name, "seed": args.seed}
    headline = {"value": None, "baseline": None}

    def stage(key, fn):
        print(f"[bench] {key}", file=sys.stderr, flush=True)
        try:
            fn()
        except Exception as e:  # record, keep going
            extra[f"{key}_error"] = f"{type(e).__name__}: {e}"

    A_ref = laplace2d_ref(NX)
    n = A_ref.shape[0]
    A = laplace2d(NX, dtype=DTYPE, constant=True)

    def baseline():
        b = rng.standard_normal(n)
        t0 = time.perf_counter()
        iters = mrr_ref(A_ref, b, TOL, MAXITER)
        headline["baseline"] = time.perf_counter() - t0
        extra["baseline_numpy_time_s"] = headline["baseline"]
        extra["baseline_iterations"] = iters

    def single():
        fn = jax.jit(lambda bi: krylov_tpu.solve_device(
            A, bi, method="mrr", tol=TOL, maxiter=MAXITER))
        extra["compile_plus_first_s"], _ = _timed(
            fn, jnp.asarray(rng.standard_normal(n).astype(DTYPE)))
        trials = []
        for _ in range(3):
            b = jnp.asarray(rng.standard_normal(n).astype(DTYPE))
            dt, res = _timed(fn, b)
            trials.append((dt, res, b))
        trials.sort(key=lambda t: t[0])
        dt, res, b = trials[1]
        headline["value"] = dt
        extra["single_dispatch_trials_s"] = [t[0] for t in trials]
        extra["iterations"] = int(res.iterations)
        extra["converged"] = bool(res.converged)
        extra["final_residual_true"] = float(
            np.linalg.norm(np.asarray(b, np.float64) - A_ref @ np.asarray(res.x, np.float64))
            / np.linalg.norm(np.asarray(b, np.float64)))

    def fidelity():
        b = rng.standard_normal(n).astype(DTYPE)
        x, info = krylov_tpu.solve(A, b, method="mrr", tol=TOL,
                                   maxiter=MAXITER, restarts=2)
        true = float(np.linalg.norm(b.astype(np.float64) - A_ref @ np.asarray(x, np.float64))
                     / np.linalg.norm(b.astype(np.float64)))
        extra["fidelity"] = {
            "true_residual": true, "passes_tol": true < TOL,
            "exec_s": info["time"], "compile_s": info.get("compile_time", 0.0),
            "iterations": info["iterations"],
        }

    def spmv():
        A_scaled = jax.tree.map(lambda d: d / 8.0, A)
        loops = {
            r: jax.jit(lambda v, r=r: lax.fori_loop(
                0, r, lambda i, u: A_scaled.matvec(u), v))
            for r in (200, 5200)
        }
        best = {}
        for r, fn in loops.items():
            _timed(fn, jnp.asarray(rng.standard_normal(n).astype(DTYPE)))
            best[r] = min(
                _timed(fn, jnp.asarray(rng.standard_normal(n).astype(DTYPE)))[0]
                for _ in range(3)
            )
        t = (best[5200] - best[200]) / 5000.0
        extra["spmv_us"] = t * 1e6
        extra["spmv_gnnz_per_s"] = A.nnz / t / 1e9

    def amortized():
        many = jax.jit(lambda B: lax.map(lambda bi: krylov_tpu.solve_device(
            A, bi, method="mrr", tol=TOL, maxiter=MAXITER), B))
        _timed(many, jnp.asarray(rng.standard_normal((NRHS, n)).astype(DTYPE)))
        dt, res = _timed(
            many, jnp.asarray(rng.standard_normal((NRHS, n)).astype(DTYPE)))
        extra["amortized_per_solve_s"] = dt / NRHS
        extra["iterations_all_rhs"] = [int(v) for v in np.asarray(res.iterations)]

    def solve_api():
        krylov_tpu.solve(A, rng.standard_normal(n).astype(DTYPE), method="mrr",
                         tol=TOL, maxiter=MAXITER)
        b = rng.standard_normal(n).astype(DTYPE)
        t0 = time.perf_counter()
        krylov_tpu.solve(A, b, method="mrr", tol=TOL, maxiter=MAXITER)
        extra["solve_api_incl_host_transfer_s"] = time.perf_counter() - t0

    for key, fn in (("baseline", baseline), ("headline", single),
                    ("fidelity", fidelity), ("spmv", spmv),
                    ("amortized", amortized), ("solve_api", solve_api)):
        stage(key, fn)

    value, base = headline["value"], headline["baseline"]
    print(json.dumps({
        "metric": "mrr_laplace2d_n250k_time_to_solution",
        "value": value if value else -1.0,
        "unit": "s",
        "vs_baseline": base / value if (value and base) else -1.0,
        "extra": _finite(extra),
    }), flush=True)
    return 1 if any(k.endswith("_error") for k in extra) else 0


if __name__ == "__main__":
    sys.exit(main())
