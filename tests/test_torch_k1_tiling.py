"""K1's tiling (``kernel.k1_tiling``) and the K2-K4 tiling it leaves alone.

K1 launches one grid a call: (tiles of pooled rows, images, tiles of output
channels).  Here, on the main path's layers (LeNet-5's two steps, the
DS-CNN-KWS and MobileNet-V1 0.25 heads) at every bucket of the serving
ladder, the tiling must fit one CTA's shared memory (bf16 is widened to f32
as it is staged, so both dtypes need the same bytes), cover every output
once, and spread the DS-CNN-KWS head over at least 32 CTAs at one image.
K2-K4 share ``conv_pool_call`` and keep their own tiling, pinned here.
"""
import pytest

from repro_torch.core import fusion, schedule
from repro_torch.core.graph import (DAGGraph, _pair, cifar_testnet, ds_cnn_kws,
                                    lenet5, mobilenet_v1)
from repro_torch.kernels.conv_pool import depthwise
from repro_torch.kernels.conv_pool import kernel as launch
from repro_torch.quant import kernel_q8

BUCKETS = (1, 2, 4, 8, 16)


def _steps(fused):
    """(name, layer, (C, H, W)) of every kernel step of a fused graph."""
    if not isinstance(fused, DAGGraph):
        shapes = fused.shapes()
        return [(l.name, l, tuple(shapes[i - 1])) for i, l in enumerate(fused.layers)
                if l.kind == "FusedConvPool"]
    mat = schedule.materialize_dag(fused)
    return [(s.name, s.layer, tuple(s.in_shapes[0])) for s in mat.steps
            if s.layer.kind in ("FusedConvPool", "DepthwiseConv2d")]


def _geometry(layer, in_shape):
    """(depthwise, cin, H, W, cout, (kh, kw), geometry kwargs) of a step."""
    cin, H, W = in_shape
    if layer.kind == "DepthwiseConv2d":
        return (True, cin, H, W, cin, _pair(layer.kernel_size),
                dict(conv_stride=_pair(layer.stride), padding=_pair(layer.padding),
                     pool_k=(1, 1), pool_stride=(1, 1)))
    conv = layer.conv
    dw = conv.kind == "DepthwiseConv2d"
    return (dw, cin, H, W, conv.channels if dw else conv.out_channels,
            _pair(conv.kernel_size),
            dict(conv_stride=_pair(conv.stride), padding=_pair(conv.padding),
                 pool_k=_pair(layer.pool_kernel), pool_stride=_pair(layer.pool_stride)))


def _net_steps():
    nets = {"lenet5": fusion.fuse(lenet5()), "cifar": fusion.fuse(cifar_testnet()),
            "ds_cnn_kws": schedule.fuse_dag_priced(ds_cnn_kws()),
            "mobilenet": schedule.fuse_dag_priced(mobilenet_v1(0.25))}
    return {(net, name): _geometry(layer, shape)
            for net, fused in nets.items() for name, layer, shape in _steps(fused)}


STEPS = _net_steps()
# K1's steps on the main path: the f32 nets' dense FusedConvPool layers.
K1_STEPS = [key for key, g in STEPS.items() if not g[0] and key[0] != "cifar"]
KWS_HEAD = ("ds_cnn_kws", "pw4+pool")


def _grid(geom, n, rows, ct):
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    _, _, ph, _ = launch.output_hw(H, W, kh, kw, **kw_)
    return -(-ph // rows), n, -(-cout // ct)


def test_the_main_path_has_the_k1_steps_named_in_the_plan():
    assert sorted(K1_STEPS) == sorted([
        ("lenet5", "conv1+maxpool1"), ("lenet5", "conv2+maxpool2"), KWS_HEAD,
        ("mobilenet", "pw13+pool")])


@pytest.mark.parametrize("n", BUCKETS)
@pytest.mark.parametrize("step", K1_STEPS, ids=lambda s: f"{s[0]}/{s[1]}")
def test_k1_tiling_fits_and_covers_every_output_once(step, n):
    geom = STEPS[step]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct = launch.k1_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    assert launch.k1_smem_bytes(cin, H, W, kh, kw, rows=rows, ct=ct,
                                **kw_) <= launch.MAX_SMEM_BYTES
    gx, gy, gz = _grid(geom, n, rows, ct)
    _, _, ph, _ = launch.output_hw(H, W, kh, kw, **kw_)
    seen = {}
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                for p in range(bx * rows, min(bx * rows + rows, ph)):
                    for c in range(bz * ct, min(bz * ct + ct, cout)):
                        seen[by, p, c] = seen.get((by, p, c), 0) + 1
    assert len(seen) == n * ph * cout and set(seen.values()) == {1}
    # every tile holds at least one channel and one pooled row
    assert (gx - 1) * rows < ph and (gz - 1) * ct < cout


@pytest.mark.parametrize("n,want_ctas", [(1, 64), (16, 128)])
def test_k1_spreads_the_ds_cnn_kws_head_over_the_card(n, want_ctas):
    """The family's tiling launches 1-16 CTAs of 64 threads here; at one
    image K1's gives one CTA per output channel."""
    geom = STEPS[KWS_HEAD]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct = launch.k1_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    gx, gy, gz = _grid(geom, n, rows, ct)
    assert gx * gy * gz == want_ctas >= 32


def test_k1_splits_the_mobilenet_head_within_shared_memory():
    """256 x 256 f32 weights (262,144 B) exceed one CTA: channel tiles of 8
    at one image (32 CTAs), 29 at 16 (144 CTAs)."""
    _, cin, H, W, cout, (kh, kw), kw_ = STEPS[("mobilenet", "pw13+pool")]
    assert launch.k1_tiling(1, cin, H, W, cout, kh, kw, **kw_) == (1, 8)
    assert launch.k1_tiling(16, cin, H, W, cout, kh, kw, **kw_) == (1, 29)


@pytest.mark.parametrize("geom,n,want", [
    # a large image: rows tile past one CTA per SM, the input halo fits
    ((4, 128, 128, 8, (3, 3), dict(conv_stride=1, padding=0, pool_k=2,
                                   pool_stride=2)), 16, (8, 4)),
    # 1000 channels of 500 f32 taps: 66 channel tiles fill the card at one
    # image; at 16, 5 tiles of 200 (400 KB) halve to 10 tiles of 100
    ((500, 4, 4, 1000, (1, 1), dict(conv_stride=1, padding=0, pool_k=2,
                                    pool_stride=2)), 1, (1, 16)),
    ((500, 4, 4, 1000, (1, 1), dict(conv_stride=1, padding=0, pool_k=2,
                                    pool_stride=2)), 16, (1, 100)),
    # 32 KB of weights a channel beside a 128 KB input: shared memory, not
    # the warp of conv values (8 channels), sets the tile
    ((8192, 2, 2, 64, (1, 1), dict(conv_stride=1, padding=0, pool_k=2,
                                   pool_stride=2)), 1, (1, 2)),
])
def test_k1_tiling_off_the_main_path(geom, n, want):
    cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct = launch.k1_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    assert (rows, ct) == want
    assert launch.k1_smem_bytes(cin, H, W, kh, kw, rows=rows, ct=ct,
                                **kw_) <= launch.MAX_SMEM_BYTES


def test_k1_tiling_raises_when_one_channel_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        launch.k1_tiling(1, 60000, 1, 1, 4, 1, 1, conv_stride=1, padding=0,
                         pool_k=1, pool_stride=1)


# K2-K4's (pooled rows, channel tile) per CTA on the main path, as the
# family's tiling gives them, at N = 1 and 16: K2 on CIFAR's three steps and the two
# heads in int8, K3/K4 on every depthwise step.
FAMILY_PINNED = {
    ("cifar", "conv1+maxpool1"): (1, 32),
    ("cifar", "conv2+maxpool2"): (1, 16),
    ("cifar", "conv3+maxpool3"): (1, 32),
    KWS_HEAD: (1, 64),
    ("mobilenet", "pw13+pool"): (1, 256),
}


FAMILY_STEPS = sorted(key for key, g in STEPS.items() if key[0] != "lenet5")


@pytest.mark.parametrize("n", (1, 16))
@pytest.mark.parametrize("step", FAMILY_STEPS, ids=lambda s: f"{s[0]}/{s[1]}")
def test_k2_k4_tiling_is_unchanged(step, n):
    dw, cin, H, W, cout, (kh, kw), kw_ = STEPS[step]
    if dw:  # K3 (f32 taps) and K4 (int8 taps): one tile of every channel
        for elem in (4, 1):
            assert launch.family_tiling(n, 1, H, W, cout, kh, kw, **kw_,
                                        elem_bytes=elem) == (1, cout)
    else:  # K2
        assert launch.family_tiling(n, cin, H, W, cout, kh, kw, **kw_,
                                    elem_bytes=1) == FAMILY_PINNED[step]


def test_family_tiling_tiles_rows_past_the_target():
    """A large image at 16 images: K2's rows per CTA past 528 CTAs."""
    assert launch.family_tiling(16, 4, 128, 128, 8, 3, 3, conv_stride=1, padding=0,
                                pool_k=2, pool_stride=2, elem_bytes=1) == (2, 8)


@pytest.mark.parametrize("call,want", [
    (lambda: launch.conv_pool(_x(), _x((4, 4, 3, 3)), None), launch.k1_tiling),
    (lambda: kernel_q8.conv_pool_q8(_x(q8=True), _x((4, 4, 3, 3), True), None,
                                    multiplier=0.5), None),
    (lambda: depthwise.depthwise_conv_pool(_x(), _x((4, 1, 3, 3)), None), None),
    (lambda: kernel_q8.depthwise_conv_pool_q8(_x(q8=True), _x((4, 1, 3, 3), True),
                                              None, multiplier=0.5), None),
], ids=["K1", "K2", "K3", "K4"])
def test_only_k1_takes_the_new_tiling(monkeypatch, call, want):
    """K1's wrapper passes ``k1_tiling`` to the family's launcher; K2-K4
    pass none, so they keep ``family_tiling``."""
    seen = {}

    def record(*args, **kwargs):
        seen.update(kwargs)
        return None

    for mod in (launch, kernel_q8, depthwise):
        monkeypatch.setattr(mod, "conv_pool_call", record)
    call()
    assert seen.get("tiling") is want


def _x(shape=(1, 4, 8, 8), q8=False):
    import torch

    return torch.zeros(shape, dtype=torch.int8 if q8 else torch.float32)
