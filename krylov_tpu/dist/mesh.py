"""Device mesh construction for row-partitioned solves.

The reference's two-level topology — MPI processes across nodes × CUDA-P2P
GPUs within a node (reference: v3/gpu/mpi/common.py:46-171, hardcoded
cluster maps at v2/gpu/mpi/common.py:199-216) — collapses into a single
1-D logical mesh over all devices: XLA routes the collectives over the
devices' own links (NVLink within a GPU host) and the network across hosts,
so the library needs exactly one axis (``"rows"``) for the 1-D row
partition of the matrix.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

ROW_AXIS = "rows"


def row_axis() -> str:
    return ROW_AXIS


def make_mesh(devices: Optional[Sequence] = None, axis: str = ROW_AXIS) -> Mesh:
    """1-D mesh over the given (default: all) devices.

    Device order follows ``jax.devices()``, which enumerates hosts
    contiguously — so a 1-D row partition keeps neighbor halo exchanges
    within a host and sends only block-boundary traffic across hosts.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis,))
