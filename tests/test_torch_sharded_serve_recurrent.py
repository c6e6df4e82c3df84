"""The sharded serving steps on the recurrent families, on CPU meshes:
RecurrentGemma-9B (its local attention's cache split on length, its
``rglru`` blocks computed whole, two remainder layers) and RWKV6-7B
(computed whole, K7's plain version in the prefill), reduced, f32 compute,
held as ``tests/test_torch_sharded_serve.py`` holds the attention families
(see its docstring): a prefill and 4 decode steps on (1, 1), (2, 1),
(1, 2), (2, 2) and (1, 4) against the reference's jitted steps (1e-4) and
the port's unsharded path (1e-5, bit-equal on (1, 1)), the cache and
``next_tok`` placed by the reference's specs."""
import pytest

from test_torch_sharded_serve import MESHES, check_sharded_serving


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_sharded_steps_match_the_reference_and_the_unsharded_path(arch, mesh):
    check_sharded_serving(arch, MESHES[mesh])
