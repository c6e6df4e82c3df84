"""GPipe over a mesh axis (``repro_torch.train.pipeline``), on CPU meshes.

The port of ``tests/test_pipeline.py``'s 2-stage case (D 16, M 4, B 3, two
tanh dense layers a stage, a 2-device "pod" mesh; the reference runs it in
a subprocess of 2 forced host devices) and a 3-stage case with M 5, each
over one CPU repeated along the axis: the pipelined outputs against
``jax.vmap`` of the reference's sequential composition at 1e-5, and the
gradients of sum(y^2) with respect to every stage's params against
``jax.grad`` of the same composition at 1e-5.  The stage params sit on
their stage's coordinate; on a mesh with a second axis the stages run at
its index 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.train.pipeline import pipeline_forward, stack_stage_params
from repro_torch.tree import leaves

D = 16
TOL = 1e-5


def _stage_np(p, x):  # the reference test's stage: two dense layers
    h = jnp.tanh(x @ p["w1"])
    return jnp.tanh(h @ p["w2"])


def _stage_torch(p, x):
    return torch.tanh(torch.tanh(x @ p["w1"]) @ p["w2"])


def _case(stages, M, B, seed=0):
    rng = np.random.default_rng(seed)
    params = [{"w1": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
               "w2": (rng.standard_normal((D, D)) * 0.3).astype(np.float32)}
              for _ in range(stages)]
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return params, xs


def _ref(params, xs):
    def seq(ps, x):
        for p in ps:
            x = _stage_np(p, x)
        return x

    y = jax.vmap(functools.partial(seq, params))(xs)
    grads = jax.grad(lambda ps: jnp.sum(jax.vmap(functools.partial(seq, ps))(xs) ** 2))(params)
    return np.asarray(y), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("stages,M,B,mesh_shape,axes", [
    (2, 4, 3, (2,), ("pod",)),
    (3, 5, 3, (3,), ("pod",)),
    (2, 4, 3, (2, 2), ("pod", "data")),
])
def test_pipeline_matches_the_sequential_composition(stages, M, B, mesh_shape, axes):
    params_np, xs = _case(stages, M, B)
    want_y, want_g = _ref(params_np, xs)
    mesh = make_mesh(mesh_shape, axes, device="cpu")
    stacked = stack_stage_params([{k: torch.as_tensor(v) for k, v in p.items()}
                                  for p in params_np])
    for leaf in leaves(stacked):
        leaf.requires_grad_(True)
    y = pipeline_forward(_stage_torch, mesh, axis="pod")(stacked, torch.as_tensor(xs))
    assert y.shape == (M, B, D) and y.device == mesh.device((0,) * len(mesh_shape))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=TOL, atol=TOL)
    (y ** 2).sum().backward()
    for s in range(stages):
        for k in ("w1", "w2"):
            np.testing.assert_allclose(stacked[k].grad[s].numpy(), want_g[s][k],
                                       rtol=TOL, atol=TOL, err_msg=f"stage {s} {k}")


def test_pipeline_schedule_runs_m_plus_p_minus_1_ticks():
    """Stage s runs microbatch t - s at tick t: each stage sees every
    microbatch once, in order, and the last stage's first output comes at
    tick P - 1."""
    seen = []

    def stage(p, x):
        seen.append((int(p["id"]), int(x[0, 0])))
        return x + 100 * (p["id"] + 1)

    mesh = make_mesh((3,), ("pod",), device="cpu")
    xs = torch.arange(4, dtype=torch.float32).reshape(4, 1, 1)
    stacked = stack_stage_params([{"id": torch.tensor(float(i))} for i in range(3)])
    y = pipeline_forward(stage, mesh)(stacked, xs)
    assert y.flatten().tolist() == [600.0, 601.0, 602.0, 603.0]
    assert [s for s, _ in seen] == [0, 0, 1, 0, 1, 2, 0, 1, 2, 1, 2, 2]


def test_pipeline_needs_the_axis():
    with pytest.raises(ValueError, match="axis"):
        pipeline_forward(_stage_torch, make_mesh((2,), ("data",), device="cpu"))
