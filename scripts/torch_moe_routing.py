"""Where Mixtral-8x7B's kernel path and plain path part, on one card.

For each prompt of ``chip_smoke.py``'s Mixtral ``lm_engine`` cell (its 8
served layers, its seed, its prompts of 1 to 8,192 tokens), the prefill's
last-token logits on the kernel path (K5) against the plain path
(``chip_smoke.plain_kernels``), at the MoE's real capacity and under
``chip_smoke.lifted_capacity`` (each token group's capacity its token
count), and beside them, layer by layer, the share of tokens whose top-2
experts differ between the two paths, whether the last token's differ, and
the share of (token, expert) choices dropped past an expert's capacity on
the kernel path.  Prints one JSON line a (capacity, prompt), then the
card's ``nvidia-smi`` name and power limit.

    python3 scripts/torch_moe_routing.py [--out FILE]

Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ARCH = "mixtral-8x7b"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_moe_routing: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_phase(cs.Report(None))
    seed, _, max_seq, _, fixed, drawn, _ = cs.LM_ENGINES[ARCH]
    model, params = cs._lm_model(torch, ARCH, seed, num_layers=cs.LM_ENGINE_LAYERS[ARCH])
    lens = cs._prompt_lengths(np, fixed, drawn)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32) for n in lens]

    routed = []  # each route() call's (sorted top-2 experts, kept choices), in order
    real_route = moe.route

    def route(cfg, p, x, C, counts=None):
        r = real_route(cfg, p, x, C, counts)
        routed.append((r["onehot_e"].argmax(-1).sort(-1).values.cpu(), r["keep"].cpu()))
        return r

    def prefill(tokens):
        routed.clear()
        _, logits = model.prefill(params, tokens, max_seq)
        return logits, list(routed)

    lines = []
    moe.route = route
    try:
        for lifted in (False, True):
            for prompt in prompts:
                tokens = {"tokens": torch.as_tensor(prompt[None], device="cuda")}
                with cs.lifted_capacity() if lifted else contextlib.nullcontext():
                    lk, k_routes = prefill(tokens)
                    with cs.plain_kernels():
                        lp, p_routes = prefill(tokens)
                pairs = list(zip(k_routes, p_routes))
                lines.append({
                    "arch": ARCH, "layers": model.cfg.num_layers, "prompt": len(prompt),
                    "capacity_lifted": lifted,
                    "max_abs": float((lk - lp).abs().max()),
                    "rel_rms": float((lk - lp).norm() / lp.norm()),
                    "tokens_routed_otherwise_by_layer": [
                        float((a != b).any(-1).float().mean()) for (a, _), (b, _) in pairs],
                    "last_token_routed_otherwise_by_layer": [
                        bool((a.flatten(0, -2)[-1] != b.flatten(0, -2)[-1]).any())
                        for (a, _), (b, _) in pairs],
                    "dropped_choice_share_by_layer": [
                        float((~keep).float().mean()) for _, keep in k_routes]})
                print(json.dumps(lines[-1]), flush=True)
    finally:
        moe.route = real_route
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
