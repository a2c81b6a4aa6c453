"""``chip_smoke.py --multi`` at a tiny size on 4 of the 8 virtual CPU
devices: each sharded solve against the one-device solve, with the iterate
spread over all 4 devices and the operator's row blocks on 4 devices."""

import pathlib
import sys

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P, SingleDeviceSharding

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize(
    "solve", ["halo_cg", "halo_adaptive", "allgather_cg", "allgather_batched"]
)
def test_phase_multi(solve):
    (rec,) = chip_smoke.phase_multi(
        jax.devices()[:4], n3d=8, n_graph=1024, solves=(solve,), nrhs=3
    )
    assert rec["iterate_devices"] == 4
    key = "true_residual_max" if solve == "allgather_batched" else "true_residual"
    assert rec[key] < chip_smoke.TOL
    if solve.startswith("allgather"):
        assert rec["operator_bytes_per_device"] > 0


def _hyb_plan(n=1024):
    from krylov_tpu.dist import make_mesh, plan_sharded
    from krylov_tpu.sparse.convert import to_hyb
    from krylov_tpu.sparse.fixtures import powerlaw_spd

    mesh = make_mesh(jax.devices()[:4])
    A = to_hyb(powerlaw_spd(n, seed=0), dtype=np.float32)
    b = np.ones(n, np.float32)
    _, args, _ = plan_sharded(A, b, np.zeros_like(b), tol=1e-5, method="cg",
                              maxiter=10, mesh=mesh)
    return mesh, args[0], jax.tree.map(lambda a: a.sharding, args[0])


def test_operator_placement_is_row_blocks():
    _, op, shardings = _hyb_plan()
    got = chip_smoke.check_operator_sharded(op, shardings, 4, "hyb")
    assert got == sum(leaf.nbytes for leaf in jax.tree.leaves(op)) // 4


@pytest.mark.parametrize("layout", ["replicated", "one_device"])
def test_operator_placement_check_rejects(layout):
    mesh, op, _ = _hyb_plan()
    if layout == "replicated":
        wrong = jax.tree.map(lambda _: NamedSharding(mesh, P()), op)
    else:
        wrong = jax.tree.map(lambda _: SingleDeviceSharding(jax.devices()[0]), op)
    with pytest.raises(chip_smoke.PhaseFailure, match="operator leaf 0"):
        chip_smoke.check_operator_sharded(op, wrong, 4, "hyb")
