"""The sharded serving steps on the recurrent families, on CPU meshes:
RecurrentGemma-9B (its local attention's cache split on length, its
``rglru`` blocks on each model coordinate's channels, two remainder
layers) and RWKV6-7B (each coordinate's heads, K7's plain version in the
prefill), reduced, f32 compute, held as ``tests/test_torch_sharded_serve.py``
holds the attention families (see its docstring): a prefill and 4 decode
steps on (1, 1), (2, 1), (1, 2), (2, 2) and (1, 4) against the
reference's jitted steps (1e-4) and the port's unsharded path (1e-5,
bit-equal on (1, 1)), the cache and ``next_tok`` placed by the reference's
specs.  Also: on (2, 2), each coordinate's block of the recurrent state
(RWKV's ``s``, the RG-LRU's ``h`` and ``conv``) after the steps equals
the unsharded state's slice, no weight or state leaf split on ``"model"``
is gathered or read across blocks, and K7 runs once an RWKV layer a
coordinate a data row in the prefill on that coordinate's heads (none in
a decode step); and on (1, 3), which divides neither the heads nor the
width, the blocks run whole on the row's device and still match."""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import numpy as np
import pytest
import torch

from test_torch_sharded_serve import (B, MESHES, PORT_TOL, S, STEPS, _close, _model,
                                      _reference, _torch, check_sharded_serving,
                                      run_unsharded, sharded_steps)

from repro_torch import convert
from repro_torch.ft.resilience import reshard_tree
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.models import griffin
from repro_torch.sharding import placement as pl
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.tree import flatten_with_paths

STATE = ("s", "h", "conv")  # the recurrent state leaves the policy splits on "model"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_sharded_steps_match_the_reference_and_the_unsharded_path(arch, mesh):
    check_sharded_serving(arch, MESHES[mesh])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_recurrent_state_on_each_coordinates_blocks(arch, monkeypatch):
    rparams, inputs, _, fed = _reference(arch)
    model = _model(arch)
    cfg = model.cfg
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    _, _, u_cache = run_unsharded(model, params, inputs, fed)
    _, prefill, decode = sharded_steps(model, (2, 2))
    placed = reshard_tree(params, prefill.param_shardings)
    split = {id(x): "/".join(map(str, p)) for p, x in flatten_with_paths(placed)
             if tp.split_dim(x) is not None and ("/tm/" in "/".join(map(str, p)) + "/"
                                                 or "/rec/" in "/".join(map(str, p)))}
    across, k7, widths = [], [], []
    real_gather, real_read, real_wkv, real_rec = (pl.gather, pl.read_region, wkv_ops.wkv,
                                                  griffin.recurrence)
    monkeypatch.setattr(pl, "gather", lambda x, *a, **k: across.append(x) or
                        real_gather(x, *a, **k))
    monkeypatch.setattr(pl, "read_region", lambda x, *a, **k: across.append(x) or
                        real_read(x, *a, **k))
    monkeypatch.setattr(wkv_ops, "wkv", lambda r, *a, **k: k7.append(tuple(r.shape)) or
                        real_wkv(r, *a, **k))
    monkeypatch.setattr(griffin, "recurrence", lambda c, p, g, xf_all, xf, *a, **k: (
        widths.append(tuple(xf.shape))) or real_rec(c, p, g, xf_all, xf, *a, **k))
    cache, _ = prefill(placed, _torch(inputs))
    n_rwkv = sum(kind == "rwkv" for kind in cfg.blocks())
    n_rec = sum(kind == "rglru" for kind in cfg.blocks())
    rows, coords = 2, 2
    H, hd = cfg.d_model // max(cfg.rwkv_head_dim, 1), cfg.rwkv_head_dim
    assert k7 == [(B // rows, S, H // coords, hd)] * (n_rwkv * coords * rows)
    assert widths == [(B // rows, S, cfg.lru_width // coords)] * (n_rec * coords * rows)
    k7.clear()
    for step, tok in enumerate(fed):
        pos = pl.place(torch.full((B,), S + step, dtype=torch.int32), decode.pos_sharding)
        _, _, cache = decode(placed, cache, torch.as_tensor(tok), pos)
    assert k7 == []  # a decode step runs wkv_step
    state = {id(layer[k]) for layer in cache for k in STATE if k in layer
             and tp.split_dim(layer[k]) is not None}
    assert state and not any(id(x) in state or id(x) in split for x in across)
    checked = 0
    for layer, want in zip(cache, u_cache):
        for name in STATE:
            if name not in layer:
                continue
            x = layer[name]
            for c in x.sharding.mesh.coords():
                region = x.region_at(c)
                assert region[-1 if name != "s" else 1] != (0, x.shape[-1 if name != "s" else 1])
                _close(x.shard(c), want[name][pl.slices_within(region, ((0, d) for d in
                                                                        x.shape))], PORT_TOL)
                checked += 1
    assert checked == (n_rwkv + 2 * n_rec) * rows * coords


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_width_model_does_not_divide_runs_whole(arch, monkeypatch):
    """(1, 3): the reduced RWKV's 4 heads of 16 and RecurrentGemma's width
    of 64 do not split over 3, so the blocks run whole on the row's device
    (K7 on every head, ``griffin.recurrence`` on the whole width) and still
    match the reference and the unsharded path."""
    k7, widths = [], []
    real_wkv, real_rec = wkv_ops.wkv, griffin.recurrence
    monkeypatch.setattr(wkv_ops, "wkv", lambda r, *a, **k: k7.append(tuple(r.shape)) or
                        real_wkv(r, *a, **k))
    monkeypatch.setattr(griffin, "recurrence", lambda c, p, g, xf_all, xf, *a, **k: (
        widths.append(xf.shape[-1])) or real_rec(c, p, g, xf_all, xf, *a, **k))
    check_sharded_serving(arch, (1, 3))
    cfg = _model(arch).cfg
    if arch == "rwkv6-7b":
        H = cfg.d_model // cfg.rwkv_head_dim
        assert H % 3 and (B, S, H, cfg.rwkv_head_dim) in k7
        assert all(s[2] == H for s in k7)
    else:
        assert cfg.lru_width % 3 and widths and set(widths) == {cfg.lru_width}
