"""The port's training substrate: token pipeline, checkpoints, loop, launcher.

* The token pipeline gives the reference's batches, bit for bit, host
  sharding included.
* Checkpoints round-trip the port's trees (dicts, lists, the AdamW
  NamedTuple, f32 / bf16 / int32 leaves) onto the target's device and
  dtype, keep the last k, wait for async writes and refuse a shape
  mismatch.
* A run preempted mid-way and resumed ends bit-exact with an uninterrupted
  one (the counterpart of ``tests/test_substrate.py``'s test).
* ``repro_torch.launch.train --device cpu`` runs.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import numpy as np
import pytest
import torch

from repro.data import tokens as ref_tok
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokens as tok
from repro_torch.ft.resilience import PreemptionGuard, StepTimer, StragglerDetector
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, LoopState, run
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.tree import leaves


@pytest.mark.parametrize("hosts", [1, 2])
def test_token_pipeline_matches_reference(hosts):
    for rank in range(hosts):
        kw = dict(vocab_size=97, seq_len=24, global_batch=4, num_hosts=hosts,
                  host_rank=rank, seed=3)
        pipe, ref_pipe = tok.TokenPipelineConfig(**kw), ref_tok.TokenPipelineConfig(**kw)
        for step in (0, 1, 17):
            got, want = tok.batch_at_step(pipe, step), ref_tok.batch_at_step(ref_pipe, step)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        it = tok.iterate(pipe, start_step=5)
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ref_tok.batch_at_step(ref_pipe, 5)["tokens"])


def test_device_batch_is_the_pipeline_on_a_device():
    pipe = tok.TokenPipelineConfig(vocab_size=50, seq_len=8, global_batch=2)
    b = tok.device_batch(pipe, 4, "cpu")
    assert b["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(b["targets"].numpy(), tok.batch_at_step(pipe, 4)["targets"])


def _tree():
    g = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn(6, 4, generator=g),
              "layers": [{"w": torch.randn(3, generator=g)},
                         {"w": torch.randn(3, generator=g).to(torch.bfloat16)}]}
    return {"params": params, "opt": opt.init_state(params)}


def _zeros_like(tree):
    from repro_torch.tree import tree_map

    return tree_map(torch.zeros_like, tree)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 5, tree)
    step, out = ckpt.restore(tmp_path, _zeros_like(tree))
    assert step == 5
    assert isinstance(out["opt"], opt.AdamWState)
    for a, b in zip(leaves(out), leaves(tree)):
        assert a.dtype == b.dtype and a.device == b.device
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.zeros(2)})
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step-00000003", "step-00000004"]
    assert ckpt.latest_step(tmp_path / "missing") is None


def test_async_save_waits(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep=1, async_save=True)
    tree = {"a": torch.ones(128, 128)}
    mgr.save(1, tree)
    tree["a"].zero_()  # the host copy was taken at save
    mgr.wait()
    _, out = ckpt.restore(tmp_path, {"a": torch.zeros(128, 128)})
    assert float(out["a"].sum()) == 128 * 128


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="checkpoint"):
        ckpt.restore(tmp_path, {"a": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", {"a": torch.zeros(2)})


def _tiny_cfg(vocab=128):
    return ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
        num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=vocab,
        block_pattern=("attn",), mlp_act="swiglu", norm="rmsnorm",
        tie_embeddings=True, compute_dtype="float32")


def _loop_setup(tmp_path, total_steps):
    cfg = _tiny_cfg()
    model = Model(cfg, xent_impl="naive")
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    step = make_train_step(model, TrainStepConfig(adamw=opt.AdamWConfig(
        lr_peak=1e-3, warmup_steps=2, total_steps=total_steps)))

    def init_state():
        params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
        return LoopState(step=0, params=params, opt_state=opt.init_state(params))

    lcfg = LoopConfig(total_steps=total_steps, ckpt_dir=str(tmp_path), ckpt_every=5,
                      log_every=100, async_ckpt=False)
    return lcfg, step, init_state, lambda s: tok.device_batch(pipe, s, "cpu")


def test_preemption_resume_bit_exact(tmp_path):
    lcfg, step, init_state, batch_at = _loop_setup(tmp_path / "a", 12)
    final = run(lcfg, step, init_state, batch_at)

    lcfg2, step2, init2, batch2 = _loop_setup(tmp_path / "b", 12)
    guard = PreemptionGuard(signals=())
    calls = {"n": 0}

    def counting_batch(s):
        calls["n"] += 1
        if calls["n"] == 5:
            guard.request()
        return batch2(s)

    mid = run(lcfg2, step2, init2, counting_batch, guard=guard)
    assert mid.step == 5
    resumed = run(lcfg2, step2, init2, batch2)
    assert resumed.step == 12
    for a, b in zip(leaves(final.params), leaves(resumed.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(leaves(final.opt_state), leaves(resumed.opt_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_straggler_detector_and_timer():
    d = StragglerDetector(window=20, factor=2.0, min_samples=4)
    for _ in range(10):
        assert not d.observe(1.0)
    assert d.observe(5.0)
    assert d.observe_many([1.0, 1.1, 0.9, 4.0]) == [3]
    assert d.median == 1.0
    timer = StepTimer()
    assert timer.lap() >= 0.0


def test_launch_train_on_cpu_runs_two_steps(tmp_path, capsys):
    state = launch_train.main(["--arch", "llama3.2-1b", "--steps", "2", "--batch", "2",
                               "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert state.step == 2
    assert ckpt.latest_step(tmp_path) == 2
    out = capsys.readouterr().out
    assert "[loop] step 2:" in out and "loss=" in out
