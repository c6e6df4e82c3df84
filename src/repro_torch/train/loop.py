"""Host training loop: checkpoint/restart, straggler stats, preemption drain.

The port's counterpart of ``repro/train/loop.py``.  Resume is bit-exact
(the data stream is a pure function of the step, the checkpoint holds the
params and the optimizer state), a preemption request saves and stops at
the end of the current step, and slow steps are logged.

The step time is the card's: after each train step the loop waits for the
device (``torch.cuda.synchronize`` when the params live on a card) before
it laps the timer, so a lap covers the step's device work and not only its
enqueueing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
from repro_torch.ft.resilience import PreemptionGuard, StepTimer, StragglerDetector
from repro_torch.tree import leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    async_ckpt: bool = True


@dataclasses.dataclass
class LoopState:
    step: int
    params: Any
    opt_state: Any


def _wait_for_device(tree) -> None:
    device = leaves(tree)[0].device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    cfg: LoopConfig,
    train_step: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
    init_state: Callable[[], LoopState],
    batch_at: Callable[[int], Dict[str, torch.Tensor]],
    *,
    guard: Optional[PreemptionGuard] = None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
) -> LoopState:
    """Run (or resume) training.  Returns the final state."""
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep, async_save=cfg.async_ckpt)
    straggler = StragglerDetector()
    state = init_state()

    if latest_step(cfg.ckpt_dir) is not None:
        step, tree = mgr.restore_latest({"params": state.params, "opt": state.opt_state})
        state = LoopState(step=step, params=tree["params"], opt_state=tree["opt"])
        print(f"[loop] resumed from step {step}", flush=True)

    timer = StepTimer()
    metrics_log: List[dict] = []
    step = state.step
    while step < cfg.total_steps:
        batch = batch_at(step)
        params, opt_state, metrics = train_step(state.params, state.opt_state, batch)
        state = LoopState(step=step + 1, params=params, opt_state=opt_state)
        step += 1

        _wait_for_device(state.params)
        dt = timer.lap()
        if straggler.observe(dt):
            print(f"[loop] straggler step {step}: {dt:.3f}s "
                  f"(median {straggler.median:.3f}s)", flush=True)
        if step % cfg.log_every == 0 or step == cfg.total_steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["step_time_s"] = dt
            metrics_log.append({"step": step, **m})
            if on_metrics:
                on_metrics(step, m)
            print(f"[loop] step {step}: " + " ".join(
                f"{k}={v:.4g}" for k, v in m.items()), flush=True)
        if step % cfg.ckpt_every == 0 or step == cfg.total_steps or (
            guard is not None and guard.preempted
        ):
            mgr.save(step, {"params": state.params, "opt": state.opt_state})
            if guard is not None and guard.preempted:
                print(f"[loop] preemption drain at step {step}", flush=True)
                break
    mgr.wait()
    return state
