"""Roofline terms of one cell: compute, memory and collective seconds a card.

The port's counterpart of ``repro/launch/roofline.py``'s arithmetic:
:func:`model_flops`, :class:`Roofline` and :func:`derive`, computed as the
reference computes them.  Its constants are an NVIDIA H100 SXM's, the
datasheet's figures for "NVIDIA H100 80GB HBM3, 700 W" (not measurements;
a card set below 700 W runs slower):

    compute    = FLOPs / PEAK_FLOPS        (989e12 bf16 dense FLOP/s)
    memory     = HBM bytes / HBM_BW        (3.35e12 B/s)
    collective = collective bytes / LINK_BW (NVLink, 450e9 B/s one way)

:func:`derive` takes the peaks as arguments with these defaults, so it can
be held against the reference's terms at the reference's constants.

The reference reads its FLOPs, bytes and collective bytes off XLA's
compiled module (``cost_analysis()`` and a parser of the post-optimization
HLO text: ``_shape_bytes``, ``parse_collectives``,
``parse_collectives_scaled``).  PyTorch has no HLO and no compile, so that
parser has no counterpart here: ``repro_torch.launch.dryrun`` takes the
FLOPs from :func:`model_flops` divided over the cards (the reference's
``"lite"`` method), the bytes from the policy's placements and the
collective bytes from the formulas of the port's own sharded step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 SXM datasheet ("NVIDIA H100 80GB HBM3", 700 W): dense bf16
# tensor-core FLOP/s, HBM3 bytes/s, NVLink 4 bytes/s in one direction
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_BYTES = 80e9  # the card's memory, as the datasheet states it


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_per_chip: float
    useful_flops_ratio: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def derive(cost: dict, collectives: CollectiveStats, *, num_devices: int,
           model_flops_total: float, peak_flops: float = PEAK_FLOPS,
           hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> Roofline:
    """The three terms and the bottleneck from per-card ``cost``
    (``flops``, ``transcendentals`` folded 1:1 into compute, ``bytes
    accessed``) and collective bytes, as the reference derives them."""
    flops = float(cost.get("flops", 0.0))
    flops += float(cost.get("transcendentals", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = collectives.total_bytes
    compute_s = flops / peak_flops
    memory_s = hbm / hbm_bw
    collective_s = coll / link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    model_pc = model_flops_total / num_devices
    return Roofline(
        flops_per_chip=flops,
        hbm_bytes_per_chip=hbm,
        collective_bytes_per_chip=coll,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_per_chip=model_pc,
        useful_flops_ratio=(model_pc / flops) if flops else 0.0,
    )


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) for training, D the tokens;
    2·N_active·D for a prefill; 2·N_active·B for a decode step."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
