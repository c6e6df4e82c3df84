"""The sharded train step on the recurrent families, on CPU meshes:
RecurrentGemma-9B (RG-LRU and local attention, two remainder layers) and
RWKV6-7B, reduced, f32 compute, held as ``tests/test_torch_sharded_train.py``
holds Llama-3.2-1B and Mixtral-8x7B (see its docstring): two steps of
``jit_train_step`` on ("data", "model") meshes (2, 2), (4, 1), (1, 4) and
(1, 2) against the reference's microbatched step and the port's unsharded
one, every leaf's placement and bytes after the steps.  Tensor parallel:
RWKV's time-mix on each model coordinate's heads (K7 on them) and its
channel-mix on its ``d_ff`` slice, the RG-LRU on its channels.  On (1, 3),
which divides neither the reduced RWKV's 4 heads nor its ``d_model`` of
64, the blocks run whole on the row's device, K7 on every head."""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import pytest

from test_torch_sharded_train import MESHES, check_sharded_step

from repro_torch.kernels.wkv import ops as wkv_ops

RECURRENT_MESHES = {**MESHES, "1x2": (1, 2)}


@pytest.mark.parametrize("mesh", sorted(RECURRENT_MESHES))
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_sharded_step_matches_the_reference_microbatched_step(arch, mesh):
    check_sharded_step(arch, RECURRENT_MESHES[mesh])


def test_heads_model_does_not_divide_run_whole(monkeypatch):
    heads = []
    real = wkv_ops.wkv
    monkeypatch.setattr(wkv_ops, "wkv", lambda r, *a, **k: heads.append(r.shape[2]) or
                        real(r, *a, **k))
    check_sharded_step("rwkv6-7b", (1, 3))
    assert heads and set(heads) == {4}
