"""Rounding readings of the port's training numerics, printed.

Not a test module: a script the limits of ``chip_smoke.py``'s
``sharded_train`` and the tolerances of the sharded train tests were read
from.  Run it from the repo root on a CPU:

    PYTHONPATH=src:tests python tests/torch_precision_readings.py [arch ...]

(default ``rwkv6-7b``).  For each reduced config it prints:

* ``f64``: each f32 gradient leaf's largest error, over the leaf's largest
  |value|, against the port's own gradient computed in f64 throughout (every
  ``.float()`` and f32 constant of the port lifted to f64 for that run), for
  the reference (``jax.grad`` at f32) and the port at f32, on the first
  batch of ``tests/test_torch_sharded_train.py``; the worst and the median
  leaf of each;
* ``bf16 noise``: at seeds 0-2, each leaf's first-step gradient at bf16
  compute against the f32 one, ``|g_bf16 - g_f32| / |g_f32|`` in the
  2-norm, the noisiest leaves;
* ``gaps``: at seeds 0-2, ``tests/test_torch_tp_train.py``'s readings:
  3 steps on a (2, 2) mesh against the 2-microbatch step, in bf16 (the
  largest loss gap, the largest and the median leaf-norm gap, the five
  widest leaves) and in f32 (the largest loss and leaf-norm gaps);
* ``batch 1 split``: at seeds 0-2, ``tests/test_torch_seq_parallel.py``'s
  readings: 3 steps at batch 1 x 128 with the sequence split over the data
  rows of (2, 1) and (2, 2) against the unsharded step, in bf16 (the
  largest loss gap, the largest and the median leaf-norm gap), which
  ``chip_smoke.py``'s ``SEQ_SPLIT_LIMITS`` come from.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_seq_parallel as sp
import test_torch_sharded_train as st
import test_torch_tp_train as tpt
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.data import tokens as tok
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten_with_paths, leaves, tree_map, unflatten_like

_FACTORIES = ("zeros", "ones", "full", "empty", "arange", "tensor", "as_tensor")


@contextlib.contextmanager
def _all_f64():
    """Within: ``Tensor.float()`` gives f64 and a tensor made as f32 is made
    as f64, so a model that casts to f32 on purpose computes in f64."""
    real_float = torch.Tensor.float
    made = {n: getattr(torch, n) for n in _FACTORIES}

    def widened(make):
        def f(*args, **kwargs):
            if kwargs.get("dtype") is torch.float32:
                kwargs["dtype"] = torch.float64
            return make(*args, **kwargs)
        return f

    torch.Tensor.float = lambda self, *a, **k: self.double()
    for name, make in made.items():
        setattr(torch, name, widened(make))
    try:
        yield
    finally:
        torch.Tensor.float = real_float
        for name, make in made.items():
            setattr(torch, name, make)


def _port_grads(arch, dtype):
    """The port's gradient on ``st._setup``'s first batch at ``dtype``
    (compute and params), reference layout, numpy f64."""
    cfg = dataclasses.replace(st._cfgs(arch)[1], compute_dtype=dtype, param_dtype=dtype)
    model = Model(cfg, xent_impl="seq_chunked", xent_seq_chunk=8, rwkv_chunk=8)
    rparams, batches = st._setup(arch)
    params = tree_map(lambda x: x.to(getattr(torch, dtype)).requires_grad_(True),
                      convert.lm_params_from_numpy(rparams, cfg, device="cpu"))
    loss, _ = model.train_loss(params, st._torch_batch(batches[0]))
    grads = torch.autograd.grad(loss, leaves(params))
    grads = unflatten_like(params, [g.detach().double() for g in grads])
    return convert.lm_params_to_numpy(grads, cfg)


def f64_errors(arch):
    rparams, batches = st._setup(arch)
    ref = st._ref_model(arch)
    ref_g = jax.grad(lambda p: ref.train_loss(p, jax.tree.map(jnp.asarray, batches[0]))[0])(
        jax.tree.map(jnp.asarray, rparams))
    with _all_f64():
        truth = _port_grads(arch, "float64")
    port_g = _port_grads(arch, "float32")
    for name, g in (("reference f32", ref_g), ("port f32", port_g)):
        errs = sorted(
            (float(np.abs(np.asarray(x, np.float64) - w).max() / np.abs(w).max()),
             jax.tree_util.keystr(path))
            for (path, w), (_, x) in zip(jax.tree_util.tree_flatten_with_path(truth)[0],
                                         jax.tree_util.tree_flatten_with_path(g)[0]))
        print(f"{arch} f64: {name}: worst {errs[-1][0]:.3g} at {errs[-1][1]}, "
              f"median {np.median([e for e, _ in errs]):.3g}")


def bf16_noise(arch, seed):
    def grads(dtype):
        cfg = dataclasses.replace(base.get_reduced_config(arch), compute_dtype=dtype)
        model = Model(cfg, xent_impl="chunked", remat=True)
        params = model.init_params(torch.Generator().manual_seed(seed), device="cpu")
        pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                                       seed=seed)
        ps = [x.requires_grad_(True) for x in leaves(params)]
        loss, _ = model.train_loss(params, tok.device_batch(pipe, 0, "cpu"))
        names = ["/".join(map(str, path)) for path, _ in flatten_with_paths(params)]
        return [g.double() for g in torch.autograd.grad(loss, ps)], names

    (g32, names), (g16, _) = grads("float32"), grads("bfloat16")
    noise = sorted(((float((a - b).norm() / b.norm()), n) for a, b, n in zip(g16, g32, names)),
                   reverse=True)
    print(f"{arch} bf16 noise, seed {seed}: " + ", ".join(f"{n} {e:.3g}" for e, n in noise[:4]))


def gaps(arch, seed):
    losses, norms, _ = tpt._bf16_gaps(arch, seed)
    cfg = base.get_reduced_config(arch)
    params = Model(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    names = [f"{kind} {'/'.join(map(str, path))}" for kind in ("param", "m", "v")
             for path, _ in flatten_with_paths(params)]
    widest = sorted(zip(norms, names), reverse=True)[:5]
    f32 = [tpt._run(arch, seed, "float32", sharded) for sharded in (True, False)]
    print(f"{arch} gaps, seed {seed}: bf16 loss {max(losses):.3g}, leaf norms max "
          f"{max(norms):.3g} median {np.median(norms):.3g} (widest "
          + ", ".join(f"{n} {g:.3g}" for g, n in widest) + "); f32 loss "
          f"{max(tpt._rel(f32[0][0], f32[1][0])):.3g}, leaf norms "
          f"{max(tpt._rel(f32[0][1], f32[1][1])):.3g}")


def split_gaps(arch, seed):
    out = []
    for sizes in ((2, 1), (2, 2)):
        losses, norms = sp.bf16_gaps(arch, seed, sizes)
        out.append(f"{sizes} loss {max(losses):.3g}, leaf norms max {max(norms):.3g} "
                   f"median {np.median(norms):.3g}")
    print(f"{arch} batch 1 split, seed {seed}: " + "; ".join(out))


if __name__ == "__main__":
    for arch in sys.argv[1:] or ["rwkv6-7b"]:
        f64_errors(arch)
        for seed in range(3):
            bf16_noise(arch, seed)
        for seed in range(3):
            gaps(arch, seed)
        for seed in range(3):
            split_gaps(arch, seed)
