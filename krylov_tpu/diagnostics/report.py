"""Run reporting: banner + summary, and the info dict assembly.

Equivalent of the reference's reporting layer (reference: v3/common.py:2-23
``_start``/``_finish``), kept out of the jitted path: the kernels return
fixed-shape traces, and this module turns them into the reference-compatible
``info`` dict with host-side slicing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def start_banner(method_name: str, k: Optional[int] = None) -> None:
    print("# " + "=" * 16 + " INFO " + "=" * 16 + " #")
    print(f"Method:\t\t{method_name}")
    if k is not None:
        print(f"Initial_k:\t{k}")


def finish_banner(
    elapsed_time: float,
    converged: bool,
    num_of_iter: int,
    final_residual: float,
    final_k: Optional[int] = None,
) -> None:
    print(f"Time:\t\t{elapsed_time} s")
    print(f"Status:\t\t{'converged' if converged else 'diverged'}")
    print(f"Iteration:\t{num_of_iter} times")
    print(f"Final_Residual:\t{final_residual}")
    if final_k is not None:
        print(f"Final_k:\t{final_k}")
    print("# " + "=" * 38 + " #")


def build_info(result, elapsed_time: float) -> dict:
    """Reference-compatible info dict (reference: v3/cpu/cg.py:43-47,
    v3/cpu/adaptivekskipmrr.py:135-140), plus a couple of extras."""
    index = int(result.index)
    info = {
        "time": elapsed_time,
        "nosl": np.asarray(result.nosl_trace)[: index + 1],
        "residual": np.asarray(result.residual_trace)[: index + 1],
        "converged": bool(result.converged),
        "iterations": int(result.iterations),
    }
    if result.k_trace is not None:
        info["khistory"] = np.asarray(result.k_trace)[: index + 1]
    if result.final_k is not None:
        info["final_k"] = int(result.final_k)
    if result.true_residual is not None:
        # set by the restarts= device-side defect-correction path
        info["true_residual"] = float(result.true_residual)
    return info
