from krylov_tpu.dist.mesh import make_mesh, row_axis
from krylov_tpu.dist.spmv import ShardedOperator, shard_operator
from krylov_tpu.dist.solve import plan_sharded, solve_sharded

__all__ = [
    "make_mesh",
    "row_axis",
    "ShardedOperator",
    "shard_operator",
    "plan_sharded",
    "solve_sharded",
]
