"""Command-line driver: ``python -m krylov_tpu``.

The reference was driven by external, never-committed shell scripts reading a
``condition.json`` next to each solver tree (gitignored — reference:
v1/threads/.gitignore:6, v3/cpu/.gitignore:6, .gitignore:1-19) plus
gitignored ``*.mtx/*.npy/*.npz`` matrices.  This module makes that workflow a
first-class, committed part of the framework: one driver, every method, every
matrix source, with the reference-style banner (reference: v3/common.py:2-23)
and results saved to disk.

Subcommands::

    python -m krylov_tpu solve --matrix A.mtx --method kskipmrr --k 4
    python -m krylov_tpu solve --config condition.json
    python -m krylov_tpu info  --matrix A.npz

``condition.json`` schema (all keys optional except the system source)::

    {
      "matrix":  "path.mtx" | "path.npz" | "path.npy"
                 | {"fixture": "laplace2d", "n": 512},
      "b":       "path.npy" | "ones" | "random",       // default "ones"
      "method":  "cg",                                  // any solve() method
      "k":        0,
      "tol":      1e-5,
      "maxiter":  null,
      "dtype":   "float32" | "float64",
      "refine":   0,
      "basis_norm": false,    // k-skip: pow2-normalized Krylov chains
      "scalar_dtype": null | "float64",   // wide scalar recurrences
      "precond": null | "jacobi" | "chebyshev",
      "mesh":     false,      // true => 1-D mesh over all devices
      "out":     "solution.npz"   // checkpoint.save() format
    }

CLI flags override config-file values.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

_FIXTURES = (
    "poisson1d", "laplace2d", "laplace3d", "random_spd_ell", "powerlaw_spd",
)


def _load_matrix(spec, dtype=None):
    """Matrix source -> Operator.  ``spec`` is a path or a fixture dict."""
    from krylov_tpu.sparse import fixtures, io

    if isinstance(spec, dict):
        name = spec.get("fixture")
        if name not in _FIXTURES:
            raise ValueError(
                f"unknown fixture {name!r}; available: {_FIXTURES}"
            )
        kwargs = {k: v for k, v in spec.items() if k != "fixture"}
        if dtype is not None:
            kwargs.setdefault("dtype", dtype)
        # "n" is the size parameter regardless of the fixture's own first
        # argument name (n for poisson1d, nx for laplace2d/3d)
        size = kwargs.pop("n", None)
        fn = getattr(fixtures, name)
        A = fn(size, **kwargs) if size is not None else fn(**kwargs)
        # powerlaw_spd returns scipy CSR; coerce to the best container
        # (HybMatrix on its skewed row distribution).
        from krylov_tpu.sparse.formats import as_operator

        return as_operator(A, dtype=dtype)
    path = str(spec)
    if path.endswith(".mtx") or path.endswith(".mtx.gz"):
        return io.load_mtx(path, dtype=dtype)
    if path.endswith(".npz"):
        return io.load_npz(path, dtype=dtype)
    if path.endswith(".npy"):
        return io.load_npy(path, dtype=dtype)
    raise ValueError(f"unrecognized matrix file type: {path!r}")


def _load_rhs(spec, n: int, dtype) -> np.ndarray:
    if spec in (None, "ones"):
        return np.ones(n, dtype=dtype)
    if spec == "random":
        return np.random.default_rng(0).standard_normal(n).astype(dtype)
    b = np.load(str(spec))
    if b.shape != (n,):
        raise ValueError(f"b from {spec!r} has shape {b.shape}, need ({n},)")
    return b.astype(dtype)


def _make_precond(name: Optional[str], A):
    if name in (None, "", "none"):
        return None
    from krylov_tpu import precond

    if name == "jacobi":
        return precond.jacobi(A)
    if name == "chebyshev":
        return precond.chebyshev(A)
    raise ValueError(f"unknown preconditioner {name!r}")


def _cmd_solve(args) -> int:
    import krylov_tpu

    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    # CLI flags override config values
    for key in (
        "matrix", "b", "method", "k", "tol", "maxiter", "dtype",
        "refine", "precond", "out", "chunk_iters", "scalar_dtype",
    ):
        v = getattr(args, key, None)
        if v is not None:
            cfg[key] = v
    if args.mesh:
        cfg["mesh"] = True
    if args.basis_norm:
        cfg["basis_norm"] = True
    if args.fixture:
        cfg["matrix"] = {"fixture": args.fixture, "n": args.n}

    if "matrix" not in cfg:
        print("error: no matrix given (--matrix/--fixture or config)",
              file=sys.stderr)
        return 2

    dtype = np.dtype(cfg.get("dtype", "float32"))
    scalar_dtype = cfg.get("scalar_dtype")
    if scalar_dtype is not None:
        # Config-file values bypass argparse's choices=; validate the same
        # way so a typo ("f64") or non-float dtype fails with a clean error.
        if str(scalar_dtype) not in ("float32", "float64"):
            print(
                f"error: scalar_dtype must be 'float32' or 'float64', "
                f"got {scalar_dtype!r}",
                file=sys.stderr,
            )
            return 2
        scalar_dtype = np.dtype(scalar_dtype)
    if dtype == np.float64 or scalar_dtype == np.float64:
        # Without x64, JAX silently downcasts to float32 while the banner
        # and checkpoint would still claim a float64 solve ran.
        import jax

        jax.config.update("jax_enable_x64", True)
    A = _load_matrix(cfg["matrix"], dtype=dtype)
    b = _load_rhs(cfg.get("b"), A.shape[0], dtype)
    M = _make_precond(cfg.get("precond"), A)

    mesh = None
    if cfg.get("mesh"):
        from krylov_tpu.dist import make_mesh

        mesh = make_mesh()

    x, info = krylov_tpu.solve(
        A,
        b,
        method=cfg.get("method", "cg"),
        tol=float(cfg.get("tol", 1e-5)),
        maxiter=cfg.get("maxiter"),
        k=int(cfg.get("k", 0)),
        M=M,
        mesh=mesh,
        refine=int(cfg.get("refine", 0)),
        scalar_dtype=scalar_dtype,
        basis_norm=bool(cfg.get("basis_norm", False)),
        chunk_iters=(
            int(cfg["chunk_iters"]) if cfg.get("chunk_iters") else None
        ),
        verbose=not args.quiet,
    )

    out = cfg.get("out")
    if out:
        from krylov_tpu import checkpoint

        checkpoint.save(
            out,
            x,
            info,
            method=cfg.get("method", "cg"),
            tol=float(cfg.get("tol", 1e-5)),
        )
        if not args.quiet:
            print(f"solution -> {out}")
    return 0 if info["converged"] else 1


def _cmd_info(args) -> int:
    from krylov_tpu.sparse import convert

    A = _load_matrix(
        {"fixture": args.fixture, "n": args.n} if args.fixture
        else args.matrix
    )
    n = A.shape[0]
    report = {
        "shape": list(A.shape),
        "container": type(A).__name__,
        "dtype": str(np.dtype(A.dtype)),
        "nnz": int(A.nnz),
        "nnz_per_row": round(A.nnz / n, 3),
    }
    from krylov_tpu.sparse.formats import DiaMatrix, EllMatrix, StencilMatrix

    if isinstance(A, StencilMatrix):
        report["grid"] = list(A.grid)
        report["stencil_points"] = len(A.stencil)
    elif isinstance(A, DiaMatrix):
        report["diagonals"] = len(A.offsets)
        report["bandwidth"] = int(max(abs(o) for o in A.offsets))
    elif isinstance(A, EllMatrix):
        report["ell_width"] = int(A.data.shape[1])
    print(json.dumps(report, indent=2))
    return 0


def _add_matrix_args(p):
    p.add_argument("--matrix", help=".mtx/.npz/.npy matrix file")
    p.add_argument(
        "--fixture", choices=_FIXTURES, help="built-in test operator"
    )
    p.add_argument(
        "--n", type=int, default=64,
        help="fixture size parameter (default 64)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m krylov_tpu",
        description="parallel Krylov solver driver",
    )
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("solve", help="solve an SPD system A x = b")
    _add_matrix_args(s)
    s.add_argument("--config", help="condition.json driver config")
    s.add_argument("--b", help="'ones' | 'random' | path.npy")
    s.add_argument("--method", help="cg/mrr/kskipcg/kskipmrr/... (see docs)")
    s.add_argument("--k", type=int, help="k for k-skip methods")
    s.add_argument("--tol", type=float, help="relative residual tolerance")
    s.add_argument("--maxiter", type=int)
    s.add_argument("--dtype", choices=["float32", "float64"])
    s.add_argument("--refine", type=int,
                   help="mixed-precision refinement steps")
    s.add_argument("--basis-norm", dest="basis_norm", action="store_true",
                   help="k-skip: pow2-normalized Krylov chains (float32 "
                        "stability on ill-conditioned systems)")
    s.add_argument("--scalar-dtype", dest="scalar_dtype",
                   choices=["float32", "float64"],
                   help="dtype for scalar recurrences")
    s.add_argument("--chunk-iters", dest="chunk_iters", type=int,
                   help="bound each device dispatch to this many iterations "
                   "(exact state carry for cg/mrr; warm restart otherwise)")
    s.add_argument("--precond", choices=["none", "jacobi", "chebyshev"])
    s.add_argument("--mesh", action="store_true",
                   help="row-partition over all devices")
    s.add_argument("--out", help="save solution + info (.npz)")
    s.add_argument("--quiet", action="store_true")
    s.set_defaults(fn=_cmd_solve)

    i = sub.add_parser("info", help="analyze a matrix / container choice")
    _add_matrix_args(i)
    i.set_defaults(fn=_cmd_info)
    return p


def main(argv=None) -> int:
    from krylov_tpu.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
