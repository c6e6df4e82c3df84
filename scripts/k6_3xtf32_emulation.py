"""K6's 3xTF32 numerics on the CPU, held to ``chip_smoke.py``'s K6 gate.

K6 (``src/repro_torch/csrc/xent_fwd.cu``) runs its logits on the tensor
cores: each f32 operand split into a TF32 high and low part, three TF32
products a slice of 8 along D, summed in f32.  This script runs that
arithmetic's model (``repro_torch.kernels.xent.ref.xent_3xtf32``) on every
row of ``chip_smoke.K6_CASES``, with ``chip_smoke.py``'s distributions and
targets (drawn here on the CPU, the card's draws being the card's own
generator's), on the first 64 tokens at the full D and V,
against the plain version (``seq_chunked_xent``, f32), and prints per case
the worst per-token |diff| in f32 epsilons of M = |x_n| max_v |w_v| and
whether every token is within the gate
K6_RTOL |plain| + K6_ATOL + K6_EPS_UNITS eps M.

    PYTHONPATH=src python scripts/k6_3xtf32_emulation.py [--tokens 64] [--truncate]

One JSON line per case, then a summary line with the worst share.  CPU
only; the Llama row (V 128,256, D 2,048) holds ~1 GB of f32 weights.
``--truncate`` also models the card's accumulation, which cuts each
tensor-core sum toward zero (in f64, ~3 minutes), twice: as K6 sums (a
fresh partial every 64 of D, added to the total in f32) and as one chain
over all of D, an order whose error on the card was ~12 eps of M.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def inputs(np, torch, seed, N, D, V, w_std, tokens, rows_per_draw=8192):
    """x, w and targets of ``chip_smoke._xent_inputs``' distributions, drawn
    on the CPU from ``seed`` (w in blocks of rows); the first ``tokens`` rows
    of x and targets."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32)
    w = torch.empty((V, D), dtype=torch.float32)
    for r0 in range(0, V, rows_per_draw):
        r1 = min(V, r0 + rows_per_draw)
        w[r0:r1] = torch.as_tensor(rng.standard_normal((r1 - r0, D)) * (w_std or D ** -0.5),
                                   dtype=torch.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    last_tile = (V - 1) // 128 * 128
    t[:3] = [0, V - 1, last_tile + (V - 1 - last_tile) // 2]
    n = min(N, tokens)
    return x[:n].contiguous(), w, torch.as_tensor(t[:n])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--truncate", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels.xent import ref

    eps = torch.finfo(torch.float32).eps
    worst = 0.0
    ok_all = True
    for ci, (N, D, V, cap, w_std) in enumerate(chip_smoke.K6_CASES):
        x, w, t = inputs(np, torch, 6000 + ci, N, D, V, w_std, args.tokens)
        with torch.no_grad():
            plain = ref.seq_chunked_xent(x[None], w, t[None], softcap=cap)[0]
            emu = ref.xent_3xtf32(x, w, t, softcap=cap)
        M = x.norm(dim=1) * w.norm(dim=1).max()
        diff = (emu - plain).abs()
        allowed = (chip_smoke.K6_RTOL * plain.abs() + chip_smoke.K6_ATOL
                   + chip_smoke.K6_EPS_UNITS * eps * M)
        share = float((diff / (eps * M)).max())
        ok = bool((diff <= allowed).all())
        worst, ok_all = max(worst, share), ok_all and ok
        row = {"case": [N, D, V, cap, w_std], "tokens": x.shape[0],
               "max_abs_err": float(diff.max()), "worst_eps_of_M": share, "within_gate": ok}
        if args.truncate:
            for name, stage in (("truncated", 64), ("truncated_one_chain", -(-D // 8) * 8)):
                with torch.no_grad():
                    got = ref.xent_3xtf32(x, w, t, softcap=cap, stage=stage, truncate=True)
                row[f"{name}_worst_eps_of_M"] = float(((got - plain).abs() / (eps * M)).max())
        print(json.dumps(row), flush=True)
    print(json.dumps({"worst_eps_of_M": worst, "all_within_gate": ok_all,
                      "gate": {"rtol": chip_smoke.K6_RTOL, "atol": chip_smoke.K6_ATOL,
                               "eps_units": chip_smoke.K6_EPS_UNITS},
                      "tensor_core_route_if_at_most": 4}), flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
