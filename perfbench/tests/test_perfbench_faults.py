"""``correct`` comes out false when the timed path is broken underneath: the
int4 control in the program's place, an answer altered where it is
produced, half of each batch left out, the exchange between the mesh's
devices left out, and each layer kind left unapplied.  The harness's look
for a card is skipped; the rest of a run is driven on the CPU at a small
batch."""
import time

import pytest
import torch

from perfbench import harness
from perfbench.control import readings

CPU = torch.device("cpu")


def cell(name="kws_int8.bulk", batch=16):
    c = harness.resolve(harness.load_bench(), name)
    c.traffic = dict(c.traffic, batch=batch, input_pool_batches=2, warmup_batches=1)
    return c


def run(c, devices=(CPU,), timed=None, seed=2**31 + 77):
    return harness.run_cell(c, seed, 0.15, False, list(devices), time.perf_counter(),
                            timed=timed)


def test_sound_run_is_correct():
    assert run(cell()).correct


def test_control_fails_and_the_program_passes():
    """The readings the limit is set from, at a test's size: the program
    reads 0 mismatched values, the control many."""
    c = cell()
    out = {(r["seed"], r["side"]): r for r in readings(c, [3, 4], 0.15, [CPU])}
    for seed in (3, 4):
        assert out[seed, "program"]["correct"]
        assert out[seed, "program"]["checks"]["mismatched_values"]["value"] == 0
        assert not out[seed, "control"]["correct"]
        assert out[seed, "control"]["checks"]["mismatched_values"]["value"] > 0


def test_control_in_the_programs_place_on_the_mesh_cell():
    c = cell("vww_int8.bulk_4chips", batch=8)
    assert not run(c, [CPU] * 4, timed=c.system.control).correct


def _wrap_executor(monkeypatch, change):
    from repro_torch.core import pingpong

    orig = pingpong.DagArenaExecutor.__call__

    def broken(self, params, x):
        return change(orig, self, params, x)

    monkeypatch.setattr(pingpong.DagArenaExecutor, "__call__", broken)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    def change(orig, self, params, x):
        y = orig(self, params, x)
        y[len(y) // 2, 0] = torch.where(y[len(y) // 2, 0] == 127, 126, y[len(y) // 2, 0] + 1)
        return y

    _wrap_executor(monkeypatch, change)
    r = run(cell())
    assert not r.correct and r.checks["mismatched_values"]["value"] >= 1


def test_half_of_each_batch_left_out(monkeypatch):
    def change(orig, self, params, x):
        y = orig(self, params, x[: len(x) // 2])
        return torch.cat([y, torch.zeros_like(y)])

    _wrap_executor(monkeypatch, change)
    assert not run(cell()).correct


def test_the_exchange_between_devices_left_out(monkeypatch):
    """The mesh's gather leaves out every shard but the first device's."""
    from repro_torch.sharding import policy

    orig = policy.DataParallelPolicy.wrap_batched

    def wrap_batched(self, fn):
        run_all = orig(self, fn)

        def run_home(reps, xs):
            y = run_all(reps, xs)
            k = len(y) // self.dp_size
            y[k:] = 0
            return y

        return run_home

    monkeypatch.setattr(policy.DataParallelPolicy, "wrap_batched", wrap_batched)
    c = cell("vww_int8.bulk_4chips", batch=8)
    r = run(c, [CPU] * 4)
    assert not r.correct


LAYER_KINDS = {
    "stem conv": lambda ly: type(ly).__name__ == "Conv2d" and ly.kernel_size != (1, 1),
    "depthwise (K4)": lambda ly: type(ly).__name__ == "DepthwiseConv2d",
    "pointwise (plain int8 ops)": lambda ly: type(ly).__name__ == "Conv2d"
    and ly.kernel_size == (1, 1),
    "fused head (K2)": lambda ly: type(ly).__name__ == "FusedConvPool",
    "fc": lambda ly: type(ly).__name__ == "Linear",
}


@pytest.mark.parametrize("kind", list(LAYER_KINDS))
@pytest.mark.parametrize("name,batch,n_dev", [("kws_int8.bulk", 16, 1),
                                              ("vww_int8.bulk_4chips", 8, 4)])
def test_a_layer_left_unapplied(monkeypatch, kind, name, batch, n_dev):
    """Each layer kind the window runs, its step returning with its output
    buffer as it was: the comparison covers every kind."""
    from repro_torch.quant import exec as qexec

    orig = qexec.apply_int8_node
    hits = []

    def broken(layer, p, xs, out=None, relu=False):
        if LAYER_KINDS[kind](layer) and out is not None:
            hits.append(layer.name)
            return out
        return orig(layer, p, xs, out=out, relu=relu)

    monkeypatch.setattr(qexec, "apply_int8_node", broken)
    r = run(cell(name, batch), [CPU] * n_dev)
    assert hits and not r.correct
