"""Synthetic token pipeline: deterministic, host-sharded, restart-safe.

A numpy copy of ``repro/data/tokens.py`` (same stream, bit for bit): a
stationary Markov-ish token stream, a pure function of (seed, host_rank,
step), so checkpoint/restart resumes on the same batches.
:func:`device_batch` puts one step's batch on the device the trainer runs
on (``"cuda"`` by default; it raises without a card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_rank: int = 0
    seed: int = 0
    # synthetic structure: each token strongly predicts its successor
    determinism: float = 0.8

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _successor_table(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed ^ 0x5EED)
    return rng.permutation(vocab).astype(np.int32)


def batch_at_step(cfg: TokenPipelineConfig, step: int) -> Dict[str, np.ndarray]:
    """The (host-local) batch for a given global step — pure function."""
    succ = _successor_table(cfg.vocab_size, cfg.seed)
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_rank
    )
    B, S = cfg.local_batch, cfg.seq_len
    toks = np.empty((B, S + 1), np.int32)
    toks[:, 0] = rng.integers(0, cfg.vocab_size, B)
    noise = rng.random((B, S)) > cfg.determinism
    rand = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    for t in range(S):
        toks[:, t + 1] = np.where(noise[:, t], rand[:, t], succ[toks[:, t]])
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def iterate(cfg: TokenPipelineConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at_step(cfg, step)
        step += 1


def device_batch(cfg: TokenPipelineConfig, step: int, device="cuda") -> Dict[str, torch.Tensor]:
    """:func:`batch_at_step` as int32 tensors on ``device``."""
    dev = resolve(device)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch_at_step(cfg, step).items()}
