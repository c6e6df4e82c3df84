"""Hand-written CUDA kernels of the port and their build."""
from __future__ import annotations

from typing import Dict


def launch_counters() -> Dict[str, object]:
    """K1-K7's launch counters (:class:`repro_torch.kernels.build.LaunchCounter`),
    by kernel name.  Each wrapper ticks its counter where it launches its
    kernel on a card, and nowhere else."""
    from repro_torch.kernels.conv_pool.depthwise import K3_LAUNCHES
    from repro_torch.kernels.conv_pool.kernel import K1_LAUNCHES
    from repro_torch.kernels.flash.kernel import K5_LAUNCHES
    from repro_torch.kernels.wkv.kernel import K7_LAUNCHES
    from repro_torch.kernels.xent.kernel import K6_LAUNCHES
    from repro_torch.quant.kernel_q8 import K2_LAUNCHES, K4_LAUNCHES

    return {"K1": K1_LAUNCHES, "K2": K2_LAUNCHES, "K3": K3_LAUNCHES,
            "K4": K4_LAUNCHES, "K5": K5_LAUNCHES, "K6": K6_LAUNCHES,
            "K7": K7_LAUNCHES}


def launch_counts() -> Dict[str, int]:
    """The launches of K1-K7 this process has made, and its ``nvcc`` runs
    (``nvcc_runs``: 0 when every kernel it launched was already built).
    On the CPU every count is 0."""
    from repro_torch.kernels.build import NVCC_RUNS

    counts = {name: c.count for name, c in launch_counters().items()}
    counts["nvcc_runs"] = NVCC_RUNS.count
    return counts
