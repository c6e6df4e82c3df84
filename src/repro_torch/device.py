"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  A CUDA device on
a host without CUDA raises: the port never moves a caller's work to the CPU
on its own.  Callers that want the CPU (the tests) say so.  The ``meta``
device (shapes and dtypes, no storage) plans without allocating
(``repro_torch.launch.inputs``).
"""
from __future__ import annotations

import contextlib

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it is CUDA and
    there is no usable card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            f"pass device='cpu' explicitly to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or 'meta'")
    return dev


def current(device: torch.device):
    """A context in which ``device`` is the current card (a no-op off
    CUDA): the hand-written kernels launch on the current card, so work on
    another card of a mesh runs inside it."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
