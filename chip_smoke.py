"""Drive the public solve path once on a GPU, at full size, and check it.

    python chip_smoke.py            # one GPU: phases C1-sweep, C1-f64, C1-leak, C2, C3
    python chip_smoke.py --multi    # four GPUs: sharded C2 and C3 against one-GPU solves

Every solve goes through the library's own entry points (``solve``,
``solve_device``, ``solve_batched``, ``mesh=``) and is checked against a
plain reference that shares no code with the library: the operator rebuilt
in SciPy float64 (``sp.kron`` of tridiagonals, or the generator's own CSR
for the power-law graph), the true residual ``||b - A x|| / ||b||`` computed
from it on the host in float64, and, where iteration counts are compared,
a NumPy float64 loop of the same method.

The script needs a GPU: with any other device, or without ``nvidia-smi``, it
exits non-zero before any phase runs.  It prints the GPU's name and power
limit first, one line per solve with its times, and as its last line
``{"ok": true, "device": {...}}`` — only when every phase passed.  A failed
phase prints its traceback to stderr and makes the exit code non-zero.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np
import scipy.sparse as sp

ROOT = pathlib.Path(__file__).resolve().parent

# Tolerances, each with its reason.
TOL = 1e-5  # C1/C2/C3 true-residual bar (float32 working precision + defect correction)
# solve(restarts=) stops once its float32 on-device true residual is below
# the solve's tol.  That float32 estimate differs from the host float64 one
# by up to ~eps_f32 * ||A|| * ||x|| / ||b|| (about 2e-6 on C2's 3-D
# Laplacian), so the float32 solves aim at half the bar.
SOLVE_TOL = TOL / 2
TOL_F64 = 1e-8  # C1-f64: native float64 vectors and scalars
# C1-f64 iteration counts against the NumPy float64 loop: the GPU sums each
# reduction in another order than NumPy, so two float64 CG/MrR trajectories
# on a kappa~1e5 system drift apart at round-off level and may cross the
# tolerance a few iterations apart.
F64_ITER_MARGIN = (5, 0.02)  # max(5 iterations, 2 %)
# Sharded against one-GPU solves of the same float32 system: the psum of
# per-device partial dots changes the reduction order.  CG tracks closely;
# the adaptive solver's rollback decisions compare residuals and can flip.
MULTI_ITER_MARGIN = {"cg": (10, 0.05), "adaptivekskipmrr": (10, 0.25)}
# solve_batched has no defect-correction pass, so the batch solves to a
# recurred residual 5x below TOL; the margin covers the float32 drift of the
# recurred residual from the true one (and the atomics of the HYB tail
# scatter, whose summation order varies from run to run on the GPU).
BATCH_RECURRED_TOL = TOL / 5


class PhaseFailure(AssertionError):
    """A solve that ran but gave a wrong answer."""


# --------------------------------------------------------------------------
# Plain references (SciPy / NumPy float64, no library code)
# --------------------------------------------------------------------------


def _tridiag(n):
    return sp.diags(
        [-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1],
        format="csr",
    )


def laplace2d_ref(nx):
    """5-point Dirichlet Laplacian on an nx*nx grid, row-major: I⊗T + T⊗I."""
    T, I = _tridiag(nx), sp.identity(nx, format="csr")
    return (sp.kron(I, T, format="csr") + sp.kron(T, I, format="csr")).tocsr()


def laplace3d_ref(n):
    """7-point Dirichlet Laplacian on an n^3 grid: I⊗I⊗T + I⊗T⊗I + T⊗I⊗I."""
    T, I = _tridiag(n), sp.identity(n, format="csr")
    II = sp.identity(n * n, format="csr")
    return (
        sp.kron(II, T, format="csr")
        + sp.kron(sp.kron(I, T, format="csr"), I, format="csr")
        + sp.kron(T, II, format="csr")
    ).tocsr()


def true_residual(A_ref, b, x) -> float:
    b64 = np.asarray(b, np.float64)
    x64 = np.asarray(x, np.float64)
    return float(np.linalg.norm(b64 - A_ref @ x64) / np.linalg.norm(b64))


def check_true_residual(A_ref, b, x, tol, what) -> float:
    rel = true_residual(A_ref, b, x)
    if not rel < tol:  # also catches NaN
        raise PhaseFailure(f"{what}: true residual {rel:.3e} not below {tol:g}")
    return rel


def check_iterations(got, want, margin, what):
    slack = max(margin[0], int(np.ceil(margin[1] * want)))
    if abs(got - want) > slack:
        raise PhaseFailure(
            f"{what}: {got} iterations against {want} (allowed ±{slack})"
        )


def cg_ref(A, b, tol, maxiter):
    """Reference-semantics CG in float64 (v3/cpu/cg.py): residual checked
    before each update; returns the number of updates."""
    x = np.zeros_like(b)
    r = b - A @ x
    p = r.copy()
    gamma = r @ r
    b_norm = np.linalg.norm(b)
    i = 0
    while i < maxiter and np.sqrt(gamma) / b_norm >= tol:
        v = A @ p
        alpha = gamma / (p @ v)
        x += alpha * p
        r -= alpha * v
        gamma_n = r @ r
        p = r + (gamma_n / gamma) * p
        gamma = gamma_n
        i += 1
    return i


def mrr_ref(A, b, tol, maxiter):
    """Reference-semantics MrR in float64 (v3/cpu/mrr.py): one initial
    half-step, then residual checked before each update."""
    x = np.zeros_like(b)
    b_norm = np.linalg.norm(b)
    r = b - A @ x
    Ar = A @ r
    zeta = (r @ Ar) / (Ar @ Ar)
    y = zeta * Ar
    z = -zeta * r
    r = r - y
    x = x - z
    i = 1
    while i < maxiter and np.linalg.norm(r) / b_norm >= tol:
        Ar = A @ r
        gamma = (y @ Ar) / (y @ y)
        s = Ar - gamma * y
        zeta = (r @ s) / (s @ s)
        eta = -zeta * gamma
        y = eta * y + zeta * Ar
        z = eta * z - zeta * r
        r = r - y
        x = x - z
        i += 1
    return i


# --------------------------------------------------------------------------
# Device facts
# --------------------------------------------------------------------------


def parse_smi_line(line):
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> ``(name, power_limit)``."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), limit.strip()


def query_gpus():
    """Raw ``name, power.limit`` lines from nvidia-smi (a child process that
    never imports JAX).  Raises if the query fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no GPU")
    for ln in lines:
        parse_smi_line(ln)
    return lines


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _record(phase, what, info=None, **fields):
    rec = {"phase": phase, "solve": what}
    if info is not None:
        rec.update(
            iterations=int(info["iterations"]),
            compile_s=float(info.get("compile_time", 0.0)),
            exec_s=float(info["time"]),
        )
    rec.update(fields)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


# --------------------------------------------------------------------------
# Phases (sizes are arguments so that the tests run them tiny on the CPU)
# --------------------------------------------------------------------------

# C1-sweep settings per method.  The monomial k-skip family runs with
# power-of-two basis normalization and float64 scalars: in float32 its raw
# basis overflows on this kappa~1e5 operator.
C1_METHODS = {
    "cg": {},
    "mrr": {},
    "kskipcg": dict(k=4, basis_norm=True, scalar_dtype=np.float64),
    "kskipmrr": dict(k=4, basis_norm=True, scalar_dtype=np.float64),
    "adaptivekskipmrr": dict(k=8, basis_norm=True, scalar_dtype=np.float64),
    "cacg": dict(k=8),
    "camrr": dict(k=8),
    "pcg": dict(precond="jacobi"),
    "chronopoulos_gear": {},
    "gropp": {},
    "pipelined_cg": {},
}


def _rhs(n, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _solve_kwargs(A, kw):
    from krylov_tpu import precond

    kw = dict(kw)
    if kw.pop("precond", None) == "jacobi":
        kw["M"] = precond.jacobi(A)
    return kw


def phase_c1_sweep(nx=500, methods=tuple(C1_METHODS), maxiter=None, seed=0,
                   profile_dir=None):
    """``solve()`` of every method on the float32 2-D Laplacian, restarts=2."""
    import krylov_tpu
    from krylov_tpu.sparse.fixtures import laplace2d

    A = laplace2d(nx, dtype=np.float32, constant=True)
    A_ref = laplace2d_ref(nx)
    b = _rhs(A.shape[0], seed)
    maxiter = maxiter or 20 * nx
    recs = []
    for m in methods:
        kw = _solve_kwargs(A, C1_METHODS[m])
        x, info = krylov_tpu.solve(
            A, b, method=m, tol=SOLVE_TOL, maxiter=maxiter, restarts=2, **kw
        )
        rel = check_true_residual(A_ref, b, x, TOL, f"C1-sweep {m}")
        recs.append(_record("C1-sweep", m, info, n=A.shape[0], true_residual=rel))
    if profile_dir is not None:
        recs.append(profile_solve(A, b, "mrr", maxiter, profile_dir, "C1"))
    return recs


def phase_c1_f64(nx=500, methods=("cg", "mrr"), maxiter=None, seed=1):
    """float64 cg/mrr against the NumPy float64 loops of the same method."""
    import krylov_tpu
    from krylov_tpu.sparse.fixtures import laplace2d

    A = laplace2d(nx, dtype=np.float64, constant=True)
    A_ref = laplace2d_ref(nx)
    b = _rhs(A.shape[0], seed, np.float64)
    maxiter = maxiter or 20 * nx
    refs = {"cg": cg_ref, "mrr": mrr_ref}
    recs = []
    for m in methods:
        x, info = krylov_tpu.solve(A, b, method=m, tol=TOL_F64, maxiter=maxiter)
        want = refs[m](A_ref, b, TOL_F64, maxiter)
        check_iterations(info["iterations"], want, F64_ITER_MARGIN, f"C1-f64 {m}")
        rel = check_true_residual(A_ref, b, x, TOL_F64, f"C1-f64 {m}")
        recs.append(
            _record("C1-f64", m, info, n=A.shape[0], numpy_iterations=want,
                    true_residual=rel)
        )
    return recs


def phase_c1_leak(nx=500, maxiter=None, seed=2):
    """A jitted ``solve_device`` on a host-lazy container, then a host
    ``solve()`` on the same container: both must run and agree."""
    import jax
    import jax.numpy as jnp

    import krylov_tpu
    from krylov_tpu.sparse.fixtures import laplace2d

    A = laplace2d(nx, dtype=np.float32, constant=True)
    A_ref = laplace2d_ref(nx)
    b = _rhs(A.shape[0], seed)
    maxiter = maxiter or 20 * nx
    fn = jax.jit(
        lambda bi: krylov_tpu.solve_device(
            A, bi, method="mrr", tol=TOL, maxiter=maxiter
        )
    )
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(jnp.asarray(b)))
    t_jit = time.perf_counter() - t0
    x, info = krylov_tpu.solve(A, b, method="mrr", tol=TOL, maxiter=maxiter)
    if int(res.iterations) != info["iterations"]:
        raise PhaseFailure(
            f"C1-leak: jitted solve_device took {int(res.iterations)} "
            f"iterations, host solve() {info['iterations']}"
        )
    # Recurred convergence only (no defect correction here): the two
    # answers must agree with each other to float32 round-off.
    rel_jit = true_residual(A_ref, b, res.x)
    rel_host = true_residual(A_ref, b, x)
    if not abs(rel_jit - rel_host) <= 1e-3 * max(rel_jit, rel_host):
        raise PhaseFailure(
            f"C1-leak: true residuals differ: {rel_jit:.3e} vs {rel_host:.3e}"
        )
    return [
        _record("C1-leak", "mrr solve_device (jit)", None,
                iterations=int(res.iterations), compile_plus_exec_s=t_jit),
        _record("C1-leak", "mrr solve()", info, true_residual=rel_host),
    ]


C2_METHODS = {
    "cg": {},
    "adaptivekskipmrr": dict(k=8, basis_norm=True, scalar_dtype=np.float64),
}


def phase_c2(n=216, methods=tuple(C2_METHODS), maxiter=None, seed=3,
             profile_dir=None):
    """The 10M-row float32 3-D Laplacian: cg and adaptive k-skip MrR."""
    import krylov_tpu
    from krylov_tpu.sparse.fixtures import laplace3d

    A = laplace3d(n, dtype=np.float32, constant=True)
    A_ref = laplace3d_ref(n)
    b = _rhs(A.shape[0], seed)
    maxiter = maxiter or 20 * n
    recs = []
    for m in methods:
        x, info = krylov_tpu.solve(
            A, b, method=m, tol=SOLVE_TOL, maxiter=maxiter, restarts=2,
            **C2_METHODS[m],
        )
        rel = check_true_residual(A_ref, b, x, TOL, f"C2 {m}")
        recs.append(_record("C2", m, info, n=A.shape[0], true_residual=rel))
    if profile_dir is not None:
        recs.append(profile_solve(A, b, "cg", maxiter, profile_dir, "C2"))
    return recs


def phase_c3(n=2**20, solves=("single", "batched"), nrhs=8, maxiter=2000, seed=4):
    """The power-law graph through HYB: cg, and solve_batched with 8 RHS."""
    import jax

    import krylov_tpu
    from krylov_tpu.sparse.convert import to_hyb
    from krylov_tpu.sparse.fixtures import powerlaw_spd

    A_ref = powerlaw_spd(n, seed=0)  # the generator's own float64 CSR
    A = to_hyb(A_ref, dtype=np.float32)
    recs = []
    if "single" in solves:
        b = _rhs(n, seed)
        x, info = krylov_tpu.solve(
            A, b, method="cg", tol=SOLVE_TOL, maxiter=maxiter, restarts=2
        )
        rel = check_true_residual(A_ref, b, x, TOL, "C3 cg")
        recs.append(_record("C3", "cg", info, n=n, nnz=int(A_ref.nnz),
                            true_residual=rel))
    if "batched" in solves:
        B = np.random.default_rng(seed + 1).standard_normal((nrhs, n)).astype(
            np.float32
        )
        times = []
        for _ in range(2):  # first call compiles; the second is timed alone
            t0 = time.perf_counter()
            res = jax.block_until_ready(krylov_tpu.solve_batched(
                A, B, method="cg", tol=BATCH_RECURRED_TOL, maxiter=maxiter
            ))
            times.append(time.perf_counter() - t0)
        X = np.asarray(res.x)
        rels = [
            check_true_residual(A_ref, B[j], X[j], TOL, f"C3 batched rhs {j}")
            for j in range(nrhs)
        ]
        recs.append(_record(
            "C3", f"solve_batched cg x{nrhs}", None,
            iterations=[int(v) for v in np.asarray(res.iterations)],
            compile_plus_exec_s=times[0], exec_s=times[1],
            true_residual_max=max(rels),
        ))
    return recs


def profile_solve(A, b, method, maxiter, out_dir, phase, **kw):
    """Trace one warm ``solve()`` and reduce the first device's events to
    per-iteration device time and kernels per iteration."""
    import jax

    import krylov_tpu
    from krylov_tpu.diagnostics.profiling import device_events, per_iteration

    krylov_tpu.solve(A, b, method=method, tol=TOL, maxiter=maxiter, **kw)
    trace_dir = pathlib.Path(out_dir) / f"trace_{phase}_{method}"
    jax.profiler.start_trace(str(trace_dir))
    try:
        _, info = krylov_tpu.solve(A, b, method=method, tol=TOL,
                                   maxiter=maxiter, **kw)
    finally:
        jax.profiler.stop_trace()
    lines = device_events(str(trace_dir))
    dev0 = [k for k in lines if k.split(" | ")[0].endswith(":0")]
    events = [e for k in dev0 for e in lines[k]]
    stats = per_iteration(events, info["iterations"])
    stats["lines"] = {k: len(v) for k, v in lines.items()}
    top = {}
    for name, _, dur in events:
        top[name] = top.get(name, 0) + dur
    stats["top_events_us"] = {
        k: v / 1e3 for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:12]
    }
    return _record(f"{phase}-profile", method, info, **stats)


# --------------------------------------------------------------------------
# Four devices
# --------------------------------------------------------------------------


def _shard_devices(arr):
    return {s.device for s in arr.addressable_shards}


def check_operator_sharded(op, shardings, n_devices, what) -> int:
    """Every leaf of the operator must sit on ``n_devices`` distinct devices,
    each holding its own block of ``rows / n_devices`` whole rows; a leaf
    left replicated or on one device fails.  Returns the operator's bytes
    per device."""
    import jax

    leaves = jax.tree.leaves(op)
    shardings = jax.tree.leaves(shardings)
    if len(leaves) != len(shardings):
        raise PhaseFailure(f"{what}: {len(leaves)} operator leaves, "
                           f"{len(shardings)} shardings")
    per_device = 0
    for i, (leaf, sh) in enumerate(zip(leaves, shardings)):
        shape = tuple(leaf.shape)
        blocks = sh.devices_indices_map(shape)
        starts = {idx[0].indices(shape[0])[0] for idx in blocks.values()}
        block = (shape[0] // n_devices, *shape[1:])
        if (len(blocks) != n_devices or len(starts) != n_devices
                or tuple(sh.shard_shape(shape)) != block):
            raise PhaseFailure(
                f"{what}: operator leaf {i} {shape} has blocks "
                f"{tuple(sh.shard_shape(shape))} on {len(blocks)} devices, "
                f"want {block} on {n_devices}"
            )
        per_device += int(np.prod(block)) * leaf.dtype.itemsize
    return per_device


def _operator_bytes_per_device(A, b, mesh, method, maxiter, what):
    """Place the operator as the sharded solve does and check its blocks."""
    import jax

    from krylov_tpu.dist import plan_sharded

    _, args, _ = plan_sharded(A, b, np.zeros_like(b), tol=TOL, method=method,
                              maxiter=maxiter, mesh=mesh)
    return check_operator_sharded(args[0],
                                  jax.tree.map(lambda a: a.sharding, args[0]),
                                  mesh.devices.size, what)


def _compare_sharded(phase, what, A, A_ref, b, mesh, method, maxiter, kw):
    import krylov_tpu

    x1, i1 = krylov_tpu.solve(A, b, method=method, tol=TOL, maxiter=maxiter,
                              refine=2, **kw)
    x4, i4 = krylov_tpu.solve(A, b, method=method, tol=TOL, maxiter=maxiter,
                              refine=2, mesh=mesh, **kw)
    res = krylov_tpu.solve_device(A, b, method=method, tol=TOL,
                                  maxiter=maxiter, mesh=mesh, **kw)
    devs = _shard_devices(res.x)
    if len(devs) != mesh.devices.size:
        raise PhaseFailure(f"{phase} {what}: iterate on {len(devs)} devices")
    check_iterations(i4["iterations"], i1["iterations"],
                     MULTI_ITER_MARGIN[method], f"{phase} {what}")
    rel1 = check_true_residual(A_ref, b, x1, TOL, f"{phase} {what} one GPU")
    rel4 = check_true_residual(A_ref, b, x4, TOL, f"{phase} {what} sharded")
    return _record(phase, what, i4, n=A.shape[0],
                   iterations_one_device=i1["iterations"],
                   exec_s_one_device=i1["time"], true_residual=rel4,
                   true_residual_one_device=rel1, iterate_devices=len(devs))


def phase_multi(devices, n3d=216, n_graph=2**20,
                solves=("halo_cg", "halo_adaptive", "allgather_cg",
                        "allgather_batched"),
                nrhs=8, maxiter=None, seed=5, profile_dir=None):
    """Sharded C2 (ppermute halo path) and C3 (all_gather path) on a 1-D
    mesh over ``devices``, each against the one-device solve."""
    import jax

    import krylov_tpu
    from krylov_tpu.dist import make_mesh
    from krylov_tpu.sparse.convert import to_hyb
    from krylov_tpu.sparse.fixtures import laplace3d, powerlaw_spd

    mesh = make_mesh(devices)
    recs = []
    if {"halo_cg", "halo_adaptive"} & set(solves):
        A = laplace3d(n3d, dtype=np.float32, constant=True)
        A_ref = laplace3d_ref(n3d)
        b = _rhs(A.shape[0], seed)
        it = maxiter or 20 * n3d
        for key, m in (("halo_cg", "cg"), ("halo_adaptive", "adaptivekskipmrr")):
            if key in solves:
                recs.append(_compare_sharded("C2-multi", m, A, A_ref, b, mesh,
                                             m, it, C2_METHODS[m]))
        if profile_dir is not None:
            recs.append(profile_solve(A, b, "cg", it, profile_dir, "C2-multi",
                                      mesh=mesh))
        del A_ref
    if {"allgather_cg", "allgather_batched"} & set(solves):
        A_ref = powerlaw_spd(n_graph, seed=0)
        A = to_hyb(A_ref, dtype=np.float32)
        it = maxiter or 2000
        if "allgather_cg" in solves:
            b = _rhs(n_graph, seed + 1)
            rec = _compare_sharded("C3-multi", "cg", A, A_ref, b, mesh,
                                   "cg", it, {})
            rec["operator_bytes_per_device"] = _operator_bytes_per_device(
                A, b, mesh, "cg", it, "C3-multi cg")
            recs.append(rec)
        if "allgather_batched" in solves:
            B = np.random.default_rng(seed + 2).standard_normal(
                (nrhs, n_graph)).astype(np.float32)
            r1 = jax.block_until_ready(krylov_tpu.solve_batched(
                A, B, method="cg", tol=BATCH_RECURRED_TOL, maxiter=it))
            t0 = time.perf_counter()
            r4 = jax.block_until_ready(krylov_tpu.solve_batched(
                A, B, method="cg", tol=BATCH_RECURRED_TOL, maxiter=it,
                mesh=mesh))
            t4 = time.perf_counter() - t0
            devs = _shard_devices(r4.x)
            if len(devs) != mesh.devices.size:
                raise PhaseFailure(f"C3-multi batched: iterate on {len(devs)} devices")
            it1 = np.asarray(r1.iterations)
            it4 = np.asarray(r4.iterations)
            X4 = np.asarray(r4.x)
            rels = []
            for j in range(nrhs):
                check_iterations(int(it4[j]), int(it1[j]), MULTI_ITER_MARGIN["cg"],
                                 f"C3-multi batched rhs {j}")
                rels.append(check_true_residual(
                    A_ref, B[j], X4[j], TOL, f"C3-multi batched rhs {j}"))
            recs.append(_record(
                "C3-multi", f"solve_batched cg x{nrhs}", None,
                iterations=it4.tolist(), iterations_one_device=it1.tolist(),
                compile_plus_exec_s=t4, true_residual_max=max(rels),
                iterate_devices=len(devs),
                operator_bytes_per_device=_operator_bytes_per_device(
                    A, B, mesh, "cg", it, "C3-multi batched"),
            ))
    return recs


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def _run_phase(name, fn, card, failures):
    print(f"[chip_smoke] {name} ...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
        for rec in fn():
            print(json.dumps({**rec, "gpu": card}), flush=True)
    except Exception:
        traceback.print_exc()
        failures.append(name)
    print(f"[chip_smoke] {name} done in {time.perf_counter() - t0:.1f} s "
          f"({card})", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded phase on the first four GPUs")
    ap.add_argument("--out", type=pathlib.Path, default=ROOT / "traces",
                    help="directory for the profiler traces (default: "
                         "traces/ in the checkout)")
    args = ap.parse_args(argv)

    import jax

    import krylov_tpu  # noqa: F401  (fails here outside a checkout)

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, found {dev.platform!r} ({dev.device_kind})",
              file=sys.stderr)
        return 2
    smi = query_gpus()
    for line in smi:
        print(line, flush=True)
    name, limit = parse_smi_line(smi[0])
    card = f"{name}, power limit {limit}"

    from krylov_tpu.compile_cache import enable_compile_cache

    print(f"[chip_smoke] compile cache: {enable_compile_cache()}", file=sys.stderr)
    args.out.mkdir(parents=True, exist_ok=True)
    failures = []
    if args.multi:
        devices = jax.devices()[:4]
        if len(devices) < 4:
            print(f"chip_smoke --multi: needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        _run_phase("multi", lambda: phase_multi(devices, profile_dir=args.out),
                   card, failures)
    else:
        _run_phase("C1-sweep", lambda: phase_c1_sweep(profile_dir=args.out),
                   card, failures)
        _run_phase("C1-f64", phase_c1_f64, card, failures)
        _run_phase("C1-leak", phase_c1_leak, card, failures)
        _run_phase("C2", lambda: phase_c2(profile_dir=args.out), card, failures)
        _run_phase("C3", phase_c3, card, failures)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
