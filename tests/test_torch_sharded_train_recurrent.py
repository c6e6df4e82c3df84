"""The sharded train step on the recurrent families, on CPU meshes:
RecurrentGemma-9B (RG-LRU and local attention, two remainder layers) and
RWKV6-7B, reduced, f32 compute, held as ``tests/test_torch_sharded_train.py``
holds Llama-3.2-1B and Mixtral-8x7B (see its docstring): two steps of
``jit_train_step`` on ("data", "model") meshes (2, 2), (4, 1) and (1, 4)
against the reference's microbatched step and the port's unsharded one,
every leaf's placement and bytes after the steps."""
import pytest

from test_torch_sharded_train import MESHES, check_sharded_step


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_sharded_step_matches_the_reference_microbatched_step(arch, mesh):
    check_sharded_step(arch, MESHES[mesh])
