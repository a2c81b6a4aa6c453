"""Weak-scaling harness: nnz/s efficiency as devices and problem size grow
together (BASELINE.md rows 4-5).

On a multi-GPU host this measures wall-clock nnz/s per device; on a CPU
dev box (``--cpu``) it still validates the sharded code path on a forced
virtual device mesh, where the times mean nothing about a device.

Usage:
    python benchmarks/weak_scaling.py [--devices 1 2 4 8] [--rows-per-dev 65536]
"""

import argparse
import os
import sys
import time

if "--cpu" in sys.argv or os.environ.get("JAX_PLATFORMS") == "cpu":
    # Re-exec with the env set BEFORE the interpreter starts: XLA reads
    # XLA_FLAGS (the virtual device count) once, when the backend starts.
    if "--xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""
    ):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        )
        env["JAX_PLATFORMS"] = "cpu"
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def run(n_devices: int, rows_per_dev: int, method: str, k: int, iters: int):
    import krylov_tpu
    from krylov_tpu.dist import make_mesh
    from krylov_tpu.sparse.fixtures import laplace2d

    devs = jax.devices()[:n_devices]
    mesh = make_mesh(devs)
    # grid: leading axis divides the mesh; per-device slab of rows_per_dev.
    g1 = 1024
    g0 = n_devices * max(1, rows_per_dev // g1)
    A = laplace2d(g1, g0, dtype=np.float32)  # grid (g0, g1)
    n = A.shape[0]
    b = np.ones(n, dtype=np.float32)

    res = krylov_tpu.solve_device(
        A, b, method=method, k=k, tol=0.0, maxiter=iters, mesh=mesh
    )
    jax.block_until_ready(res)
    t0 = time.perf_counter()
    res = krylov_tpu.solve_device(
        A, b, method=method, k=k, tol=0.0, maxiter=iters, mesh=mesh
    )
    jax.block_until_ready(res)
    dt = time.perf_counter() - t0
    it = int(res.iterations)
    nnzs = A.nnz * max(it, 1) / dt
    return dict(
        devices=n_devices,
        n=n,
        iters=it,
        time_s=dt,
        nnz_per_s=nnzs,
        nnz_per_s_per_dev=nnzs / n_devices,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--rows-per-dev", type=int, default=65536)
    ap.add_argument("--method", default="kskipmrr")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    counts = args.devices or sorted(
        {c for c in (1, 2, 4, 8) if c <= jax.device_count()}
    )
    base = None
    for c in counts:
        r = run(c, args.rows_per_dev, args.method, args.k, args.iters)
        if base is None:
            base = r["nnz_per_s_per_dev"]
        r["weak_scaling_efficiency"] = r["nnz_per_s_per_dev"] / base
        print(
            f"devices={r['devices']} N={r['n']:>9} iters={r['iters']:>4} "
            f"time={r['time_s']:.4f}s nnz/s={r['nnz_per_s']/1e9:8.2f}G "
            f"eff={r['weak_scaling_efficiency']:.2%}"
        )


if __name__ == "__main__":
    main()
