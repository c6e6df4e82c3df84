"""Markdown tables from the dry run's records.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir build/dryrun]

The port's counterpart of ``repro/launch/report.py``: ``load`` and the
dry-run, roofline and planner tables over the records of
``repro_torch.launch.dryrun``.  The port's records come from the policy's
placements and the step's formulas, not a compile, so the dry-run table
shows the bytes a card holds and whether they fit 80 GB where the
reference shows compile seconds and XLA's memory analysis; the roofline
table drops the useful-FLOPs column (the "lite" FLOPs are the model's, so
it is 1 everywhere); the planner table sets the planner's activation arena
beside the state a card holds, where the reference sets it beside XLA's
temp allocation.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ARCH_ORDER = [
    "seamless-m4t-large-v2", "gemma3-1b", "llama3.2-1b", "llama3-8b",
    "nemotron-4-15b", "mixtral-8x7b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
    "recurrentgemma-9b", "rwkv6-7b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _gb(x):
    return f"{x / 2**30:.2f}"


def load(d: Path):
    recs = {}
    for p in Path(d).glob("*.json"):
        rec = json.loads(p.read_text())
        key = (rec["arch"], rec["shape"], "2x16x16" if rec.get("multi_pod") else "16x16")
        recs[key] = rec
    return recs


def _cells(recs, mesh=None):
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            if mesh is None:
                yield arch, shape
            elif (arch, shape, mesh) in recs:
                yield arch, shape, recs[(arch, shape, mesh)]


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh 16×16 | mesh 2×16×16 | GiB/card 16×16 "
        "(params+grads+opt+cache) | collectives a step (16×16) |",
        "|---|---|---|---|---|---|",
    ]
    for arch, shape in _cells(recs):
        sp = recs.get((arch, shape, "16x16"))
        mp = recs.get((arch, shape, "2x16x16"))
        if sp is None and mp is None:
            continue
        ref = sp or mp
        if ref.get("skipped"):
            lines.append(f"| {arch} | {shape} | SKIP | SKIP | — | {ref['reason'][:60]} |")
            continue

        def status(r):
            if r is None:
                return "—"
            if r.get("failed"):
                return "FAIL"
            if r.get("skipped"):
                return "SKIP"
            return f"{'fits' if r['fits_hbm'] else 'OVER'} {_gb(r['bytes_per_card']['total'])}"

        mem = coll = ""
        if sp and not sp.get("failed"):
            b = sp["bytes_per_card"]
            mem = "+".join(_gb(b[k]) for k in ("params", "grads", "opt_state", "cache"))
            c = sp["analysis"]["collectives"]["count_by_kind"]
            coll = " ".join(f"{k}:{v}" for k, v in sorted(c.items()))
        lines.append(f"| {arch} | {shape} | {status(sp)} | {status(mp)} | {mem} | {coll} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | bottleneck | roofline frac |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch, shape, rec in _cells(recs, "16x16"):
        if rec.get("skipped") or rec.get("failed"):
            continue
        r = rec["roofline"]
        dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
        frac = r["compute_s"] / dom if dom else 0.0
        lines.append(
            f"| {arch} | {shape} | {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | **{r['bottleneck']}** | {frac:.3f} |")
    return "\n".join(lines)


def planner_table(recs) -> str:
    """The paper's §3.2 planner at LM scale beside the state a card holds."""
    lines = [
        "| arch | shape | planner ping-pong (+remat carries) | state a card | planner / state |",
        "|---|---|---|---|---|",
    ]
    for arch, shape, rec in _cells(recs, "16x16"):
        if rec.get("skipped") or rec.get("failed"):
            continue
        est = rec["planner_estimate"]["total_bytes"]
        state = rec["bytes_per_card"]["total"]
        ratio = est / state if state else float("nan")
        lines.append(f"| {arch} | {shape} | {_gb(est)} GiB | {_gb(state)} GiB | {ratio:.2f}× |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    recs = load(Path(args.dir))
    print("## Dry-run matrix\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16×16, NVIDIA H100 SXM datasheet peaks)\n")
    print(roofline_table(recs))
    print("\n## Planner (paper §3.2) beside the state a card holds\n")
    print(planner_table(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
