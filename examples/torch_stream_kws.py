"""Streaming keyword spotting on the port: per-frame ring-buffer inference.

The production shape of DS-CNN KWS is one 10-dim MFCC frame every 20 ms,
not a batch of complete 49-frame windows.  This demo runs the streaming
deployment from DESIGN.md §13:

* plans the per-layer ring buffers (receptive-field growth along H decides
  each ring's height; the pool+FC head stays full-recompute),
* stands up a :class:`repro_torch.serve.cnn_engine.StreamServer` over the
  prepared int8 per-frame step (kernel K4 on the card, 12 launches an
  emission),
* pushes a synthetic utterance frame by frame through two concurrent
  streams, smoothing each stream's decision with a
  :class:`repro_torch.core.streaming.PosteriorSmoother` (Zhang et al.'s
  posterior smoothing: a single noisy emission cannot flip the label),
* verifies the final emission bit-for-bit against the full-window int8
  simulator on the same sliding window,
* ends with the static cost model: per-frame MACs vs full recompute.

    python examples/torch_stream_kws.py [--device cuda|cpu]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import nn, quantize, streaming
from repro_torch.core.graph import ds_cnn
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.obs import report
from repro_torch.serve.cnn_engine import StreamServer


def synthetic_mfcc(n_frames, seed, f=3.0):
    """A fake utterance: sine-modulated cepstral noise, (n, 1, 10)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)[:, None, None] / n_frames
    env = np.sin(np.pi * t) * np.cos(2 * np.pi * f * t)
    return np.asarray(env * rng.standard_normal((n_frames, 1, 10)), np.float32)


def ring_lines(splan):
    """The ring plan, one line a ring."""
    return [f"  ring {r.name:6s} {r.kind:16s} rows {r.rows:2d} "
            f"(+{r.top} top, +{r.bottom} bottom edge)  "
            f"advance {r.new_rows}/emission" for r in splan.rings]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    g = ds_cnn()
    params = nn.init_params(g.to_sequential(), torch.Generator().manual_seed(0), device=dev)
    calib = torch.as_tensor(np.random.default_rng(1).standard_normal((1, 49, 10)),
                            dtype=torch.float32, device=dev)
    qm = quantize.quantize_dag(g, params, calib)

    print("== ring plan (DESIGN.md §13) ==")
    splan = streaming.plan_streaming(g, io_dtype_bytes=1)
    print("\n".join(ring_lines(splan)))
    print(f"  head (full recompute)  : {' -> '.join(splan.head)}")
    print(f"  ring arena             : {splan.plan.arena_bytes} B int8 "
          f"(emit every {splan.emit_stride} frames)")

    print("\n== per-frame serving, two concurrent streams ==")
    srv = StreamServer.from_quantized(qm, device=dev)
    print(f"  per-frame step pre-warmed in {srv.prewarm_s * 1e3:.0f} ms")
    n_frames = 60
    utts = {"mic0": synthetic_mfcc(n_frames, seed=3, f=3.0),
            "mic1": synthetic_mfcc(n_frames, seed=5, f=7.0)}
    frames_q = {sid: quantize.quantize_input(qm, torch.from_numpy(u)).numpy()
                for sid, u in utts.items()}
    last = {}
    emissions = {sid: 0 for sid in utts}
    smoothers = {sid: streaming.PosteriorSmoother(window=3, mode="mean")
                 for sid in utts}
    label = {}
    for t in range(n_frames):
        for sid in utts:  # interleaved: one frame per stream per tick
            out = srv.push(sid, frames_q[sid][t])
            if out is not None:
                emissions[sid] += 1
                last[sid] = out
                label[sid] = smoothers[sid].update(out)
    for sid in utts:
        final = srv.close(sid)
        print(f"  {sid}: {n_frames} frames -> {emissions[sid]} emissions, "
              f"smoothed label {label[sid]} "
              f"(raw final argmax {int(np.argmax(final))}, "
              f"q8 logits {final.min()}..{final.max()})")

    # bit-exactness: final emission == full-window simulator on the same
    # sliding window (zeros prehistory ++ frames, last 49 rows)
    for sid in utts:
        hist = np.concatenate(
            [np.zeros((49,) + frames_q[sid].shape[1:], np.int8),
             frames_q[sid]])[-49:]
        window = np.transpose(hist, (1, 0, 2)).reshape(1, 49, 10)
        ref = quantize.simulate_int8_dag_forward(
            qm, torch.as_tensor(window, device=dev)).cpu().numpy()
        assert np.array_equal(last[sid], ref), sid
    print("  final emissions bit-exact vs full-window int8 simulator")

    print("\n== cost model ==")
    cost = report.streaming_report(g, splan)
    print(f"  full window : {cost['full_window_macs']:,} MACs")
    print(f"  streaming   : {cost['per_emission_macs']:,} MACs/emission "
          f"= {cost['per_frame_macs']:,} MACs/frame "
          f"({cost['per_frame_frac']:.1%} of full recompute)")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
