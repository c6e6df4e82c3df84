"""The plain int8 reference: hand-worked cases, and against the port at a
small batch on the CPU (the reference imports nothing of the port; this
test holds the two side by side)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import reference as R

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def kind():
    """The system kind both configurations name (``systems/int8_cnn.py``)."""
    from perfbench import harness

    return harness.load_module(CONFIGS.parents[1], "systems", "int8_cnn")


def net(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_requant_rounds_half_to_even_and_saturates():
    acc = torch.tensor([1, 3, 5, -1, -3, 300, -300, 254], dtype=torch.float64)
    got = R._requant(acc, torch.tensor(0.5, dtype=torch.float32), 127)
    assert got.tolist() == [0, 2, 2, 0, -2, 127, -128, 127]
    assert R._requant(acc, torch.tensor(0.5), 7).tolist() == [0, 2, 2, 0, -2, 7, -8, 7]


TINY = {"input_shape": [1, 2, 2], "num_classes": 1, "weights": {"bias_std": 0.0},
        "layers": [
            {"name": "c", "op": "conv", "cout": 1, "kernel": [1, 1], "stride": [1, 1],
             "padding": [0, 0], "relu": True},
            {"name": "fc", "op": "fc", "in": 4, "out": 1}]}


def tiny_weights():
    return {"c": {"w": torch.full((1, 1, 1, 1), 0.5), "b": torch.zeros(1)},
            "fc": {"w": torch.full((1, 4), 0.25), "b": torch.zeros(1)}}


def test_tiny_net_by_hand():
    """Calibrating on x = [1, -1, 0.5, 0]: input scale 1/127, conv scale
    0.5/127 (before its ReLU), fc scale 0.1875/127; weights quantize to 127;
    the conv's multiplier is 1/127, the fc's (0.5 * 0.25 / 0.1875) / 127."""
    calib = torch.tensor([[[[1.0, -1.0], [0.5, 0.0]]]])
    q = R.derive(TINY, tiny_weights(), calib)
    assert q.input_scale == pytest.approx(1 / 127)
    assert [ql.out_scale for ql in q.layers] == pytest.approx([0.5 / 127, 0.1875 / 127])
    assert [ql.w_q.flatten().tolist() for ql in q.layers] == [[127.0], [127.0] * 4]
    assert float(q.layers[0].m) == np.float32(1 / 127)
    assert float(q.layers[1].m) == np.float32(0.5 * 0.25 / 0.1875 / 127)
    x_q = R.quantize_input(calib, q.input_scale)
    assert x_q.flatten().tolist() == [127, -127, 64, 0]  # 63.5 rounds to even
    # conv: 127 * x_q * (1/127) -> x_q, ReLU -> [127, 0, 64, 0]; fc: 127 * 191 * m = 127.33
    assert R.forward(q, x_q).tolist() == [[127]]
    x2 = torch.tensor([[[[10, -20], [30, 40]]]], dtype=torch.int8)
    acc = 127 * (10 + 30 + 40)
    want = np.round(np.float32(acc) * np.float32(0.5 * 0.25 / 0.1875 / 127))
    assert R.forward(q, x2).tolist() == [[int(want)]]


def test_depthwise_scales_per_channel():
    net_dw = {"input_shape": [2, 3, 3], "num_classes": 2, "weights": {"bias_std": 0.0},
              "layers": [{"name": "d", "op": "dw", "kernel": [1, 1], "stride": [1, 1],
                          "padding": [0, 0], "relu": False},
                         {"name": "fc", "op": "fc", "in": 18, "out": 2}]}
    w = {"d": {"w": torch.tensor([2.0, 0.5]).view(2, 1, 1, 1), "b": torch.tensor([1.0, 1.0])},
         "fc": {"w": torch.eye(2, 18), "b": torch.zeros(2)}}
    calib = torch.ones(1, 2, 3, 3)
    q = R.derive(net_dw, w, calib)
    ws = np.array([2.0, 0.5], np.float32) / np.float32(127)
    assert q.layers[0].w_q.flatten().tolist() == [127.0, 127.0]
    want_b = np.round(np.array([1.0, 1.0], np.float32) / (np.float32(1 / 127) * ws))
    assert q.layers[0].b_q.tolist() == want_b.tolist()
    assert q.layers[0].m.dtype == torch.float32 and q.layers[0].m.shape == (2,)


@pytest.mark.parametrize("name,n", [("ds_cnn_kws_int8", 24), ("mobilenet_v1_025_vww_int8", 6)])
@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_reference_matches_the_port_bit_for_bit(name, n, seed):
    cfg = net(name)
    g = torch.Generator().manual_seed(seed)
    w = R.he_normal_weights(cfg, g, "cpu")
    calib = torch.randn((64, *cfg["input_shape"]), generator=g)
    x = torch.randn((n, *cfg["input_shape"]), generator=g)
    q = R.derive(cfg, w, calib)
    x_q = R.quantize_input(x, q.input_scale)
    want = R.forward(q, x_q)
    s = kind().build(cfg, kind().Data(w, calib, R.input_scale(calib)), [torch.device("cpu")], [])
    got = s.run(s.params, x_q)
    assert torch.equal(got, want)
    assert s.readings()["arena_bytes_off_plan"] == 0
    # the outputs are not degenerate: rows differ
    assert len({tuple(r) for r in want.tolist()}) > n // 2
    q4 = R.derive(cfg, w, calib, bits=4)
    ctrl = R.control_forward(q4, q, x_q)
    assert (ctrl != want).sum() > want.numel() // 4


def test_reference_matches_the_port_over_a_mesh_of_four():
    cfg = net("ds_cnn_kws_int8")
    g = torch.Generator().manual_seed(11)
    w = R.he_normal_weights(cfg, g, "cpu")
    calib = torch.randn((32, *cfg["input_shape"]), generator=g)
    x_q = R.quantize_input(torch.randn((16, *cfg["input_shape"]), generator=g),
                           R.input_scale(calib))
    s = kind().build(cfg, kind().Data(w, calib, R.input_scale(calib)), [torch.device("cpu")] * 4,
                     [])
    assert torch.equal(s.run(s.params, x_q), R.forward(R.derive(cfg, w, calib), x_q))
