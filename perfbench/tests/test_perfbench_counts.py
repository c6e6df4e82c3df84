"""The benchmark's frozen counts: MACs layer by layer, the kernels' bounds,
and which layers each kernel runs."""
import json
from pathlib import Path

import pytest

from perfbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def kind():
    """The system kind both configurations name (``systems/int8_cnn.py``)."""
    from perfbench import harness

    return harness.load_module(CONFIGS.parents[1], "systems", "int8_cnn")


def net(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


KWS_MACS = {"conv1": 64 * 1 * 10 * 4 * 25 * 5, "fc": 64 * 12,
            **{f"dw{i}": 64 * 9 * 25 * 5 for i in range(1, 5)},
            **{f"pw{i}": 64 * 64 * 25 * 5 for i in range(1, 5)}}

# MobileNet-V1 0.25 at 96x96: (channels in, channels out, map after the
# depthwise conv) for the 13 blocks.
VWW_BLOCKS = [(8, 16, 48), (16, 32, 24), (32, 32, 24), (32, 64, 12), (64, 64, 12),
              (64, 128, 6), (128, 128, 6), (128, 128, 6), (128, 128, 6), (128, 128, 6),
              (128, 128, 6), (128, 256, 3), (256, 256, 3)]
VWW_MACS = {"conv0": 8 * 3 * 9 * 48 * 48, "fc": 256 * 2,
            **{f"dw{i}": c * 9 * m * m for i, (c, _, m) in enumerate(VWW_BLOCKS, 1)},
            **{f"pw{i}": c * o * m * m for i, (c, o, m) in enumerate(VWW_BLOCKS, 1)}}


@pytest.mark.parametrize("name,want,total", [
    ("ds_cnn_kws_int8", KWS_MACS, 2_656_768),
    ("mobilenet_v1_025_vww_int8", VWW_MACS, 7_489_664),
])
def test_macs_layer_by_layer(name, want, total):
    n = net(name)
    got = {layer["name"]: counts.layer_macs(layer, shp) for layer, shp, _ in counts.layer_shapes(n)}
    assert got == want
    assert counts.macs_per_image(n) == total == n["macs_per_image"]


@pytest.mark.parametrize("name", ["ds_cnn_kws_int8", "mobilenet_v1_025_vww_int8"])
def test_macs_match_the_ports_layer_specs(name):
    """The frozen count against ``LayerSpec.macs`` of the graph the port runs."""
    g = kind().port_graph(net(name))
    shapes = g.shapes()
    port = sum(node.layer.macs(shapes[node.inputs[0]]) for node in g.nodes if node.inputs)
    assert port == counts.macs_per_image(net(name))


def test_kws_graph_is_the_ports_ds_cnn_kws():
    from repro_torch.core.graph import ds_cnn_kws

    want, got = ds_cnn_kws(), kind().port_graph(net("ds_cnn_kws_int8"))
    assert [(n.name, n.inputs, n.layer) for n in got.nodes] == \
        [(n.name, n.inputs, n.layer) for n in want.nodes]


def test_shapes_end_at_the_classes():
    for name, classes, last_map in (("ds_cnn_kws_int8", 12, (64, 25, 5)),
                                    ("mobilenet_v1_025_vww_int8", 2, (256, 3, 3))):
        shapes = counts.layer_shapes(net(name))
        assert shapes[-1][2] == (classes,)
        assert shapes[-2][1] == last_map  # the head's input
        assert shapes[-2][2] == (last_map[0], 1, 1)


def test_kernel_layers():
    k = counts.kernel_layers(net("ds_cnn_kws_int8"))
    assert [ly["name"] for ly, _ in k[counts.K4]] == ["dw1", "dw2", "dw3", "dw4"]
    assert [ly["name"] for ly, _ in k[counts.K2]] == ["pw4"]
    k = counts.kernel_layers(net("mobilenet_v1_025_vww_int8"))
    assert len(k[counts.K4]) == 13 and [ly["name"] for ly, _ in k[counts.K2]] == ["pw13"]


def test_bound_by_hand():
    """A depthwise 3x3 layer over 64x25x5 int8 maps, 1,000 images: bytes
    2 x 8,000 a image + 576 weights + 64 x 8 bias and multipliers; 2 x
    64 x 125 x (taps inside the input) operations; bytes bound it."""
    s, which = counts.bound_s(1000, 64, 25, 5, 64, 3, 1, 1, 1, 1, depthwise=True)
    nbytes = 1000 * 8000 * 2 + 64 * 9 + 64 * 8
    assert which == "bytes"
    assert s == pytest.approx(nbytes / counts.HBM_BYTES_PER_S, rel=1e-12)
    taps_h = sum(0 <= o - 1 + d < 25 for o in range(25) for d in range(3))  # 73
    taps_w = sum(0 <= o - 1 + d < 5 for o in range(5) for d in range(3))  # 13
    assert (taps_h, taps_w) == (73, 13)
    ops = 2 * 1000 * 64 * taps_h * taps_w
    assert ops / counts.PEAK_INT8_OPS_PER_S < s
    # A dense 1x1 conv at 256 -> 256 channels over 3x3 maps with the fused
    # 3x3 average pool: one output a channel an image.
    s, which = counts.bound_s(1000, 256, 3, 3, 256, 1, 1, 0, 3, 3)
    nbytes = 1000 * 256 * 9 + 256 * 256 + 1000 * 256 + 256 * 4
    assert s == pytest.approx(max(nbytes / counts.HBM_BYTES_PER_S,
                                  2 * 1000 * 256 * 256 * 9 / counts.PEAK_INT8_OPS_PER_S))


def test_kernel_bound_sums_layers():
    n = net("ds_cnn_kws_int8")
    one = counts.bound_s(8192, 64, 25, 5, 64, (3, 3), (1, 1), (1, 1), 1, 1, depthwise=True)[0]
    assert counts.kernel_bound_s(n, counts.K4, 8192) == pytest.approx(4 * one)
