"""K1's tiling (``kernel.k1_tiling``), K2's (``kernel.k2_tiling``), and K3's
(``depthwise.k3_tiling``), which K4 takes too.

K1 launches one grid a call: (tiles of pooled rows, images, tiles of output
channels).  Here, on the main path's layers (LeNet-5's two steps, the
DS-CNN-KWS and MobileNet-V1 0.25 heads) at every bucket of the serving
ladder, the tiling must fit one CTA's shared memory (bf16 is widened to f32
as it is staged, so both dtypes need the same bytes), cover every output
once, and spread the DS-CNN-KWS head over at least 32 CTAs at one image.
K2-K4 share ``conv_pool_call``; K3 and K4 tile one output a thread over at
least one CTA per SM where the call has a warp of outputs for each; K2
takes its own ``k2_tiling`` (K1's, with int8 shares); the values of K2's and
K4's are pinned here.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import warnings

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
    rows, ct, cc = launch.k1_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    assert cc == cin  # the nets' layers stage every input channel at once
    assert launch.k1_smem_bytes(cin, H, W, kh, kw, rows=rows, ct=ct, cc=cc,
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
    """One tile of every channel would launch 1-16 CTAs of 64 threads here;
    at one image K1's tiling gives one CTA per output channel."""
    geom = STEPS[KWS_HEAD]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct, _ = launch.k1_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    gx, gy, gz = _grid(geom, n, rows, ct)
    assert gx * gy * gz == want_ctas >= 32


def test_k1_splits_the_mobilenet_head_within_shared_memory():
    """256 x 256 f32 weights (262,144 B) exceed one CTA: channel tiles of 8
    at one image (32 CTAs), 29 at 16 (144 CTAs)."""
    _, cin, H, W, cout, (kh, kw), kw_ = STEPS[("mobilenet", "pw13+pool")]
    assert launch.k1_tiling(1, cin, H, W, cout, kh, kw, **kw_) == (1, 8, 256)
    assert launch.k1_tiling(16, cin, H, W, cout, kh, kw, **kw_) == (1, 29, 256)


@pytest.mark.parametrize("geom,n,want", [
    # a large image: rows tile past one CTA per SM, the input halo fits
    ((4, 128, 128, 8, (3, 3), dict(conv_stride=1, padding=0, pool_k=2,
                                   pool_stride=2)), 16, (8, 4, 4)),
    # 1000 channels of 500 f32 taps: 66 channel tiles fill the card at one
    # image; at 16, 5 tiles of 200 (400 KB) halve to 10 tiles of 100
    ((500, 4, 4, 1000, (1, 1), dict(conv_stride=1, padding=0, pool_k=2,
                                    pool_stride=2)), 1, (1, 16, 500)),
    ((500, 4, 4, 1000, (1, 1), dict(conv_stride=1, padding=0, pool_k=2,
                                    pool_stride=2)), 16, (1, 100, 500)),
    # 32 KB of weights a channel beside a 128 KB input: shared memory, not
    # the warp of conv values (8 channels), sets the tile
    ((8192, 2, 2, 64, (1, 1), dict(conv_stride=1, padding=0, pool_k=2,
                                   pool_stride=2)), 1, (1, 2, 8192)),
])
def test_k1_tiling_off_the_main_path(geom, n, want):
    cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct, cc = launch.k1_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    assert (rows, ct, cc) == want
    assert launch.k1_smem_bytes(cin, H, W, kh, kw, rows=rows, ct=ct, cc=cc,
                                **kw_) <= launch.MAX_SMEM_BYTES


def test_k1_tiling_raises_when_one_channel_does_not_fit():
    """60,000 f32 weights of one output channel (240,000 B): no tile of the
    staged input can make room for them."""
    with pytest.raises(ValueError, match="shared memory"):
        launch.k1_tiling(1, 60000, 1, 1, 4, 1, 1, conv_stride=1, padding=0,
                         pool_k=1, pool_stride=1)


# Wide layers at large images, 64 output channels, 3x3 pad 1, max pool 2:
# one pooled row of every input channel, staged at once, exceeds a CTA's
# shared memory (238,976 B and 247,232 B), so K1 stages the input channels
# in chunks.  (cin, H, W, (rows, out channels, staged channels) at N = 1.)
WIDE = [(128, 112, 112, (1, 11, 64)), (256, 56, 56, (1, 7, 128))]
WIDE_GEOM = dict(conv_stride=1, padding=1, pool_k=2, pool_stride=2)


@pytest.mark.parametrize("n", BUCKETS)
@pytest.mark.parametrize("cin,H,W,want", WIDE, ids=["cin128@112", "cin256@56"])
def test_k1_tiling_chunks_the_input_channels_of_wide_layers(cin, H, W, want, n):
    """The tiling returns and fits; its output tiles cover every output
    once and its input chunks every input channel once; one whole chunk is
    more than the limit allows."""
    rows, ct, cc = launch.k1_tiling(n, cin, H, W, 64, 3, 3, **WIDE_GEOM)
    if n == 1:
        assert (rows, ct, cc) == want
    assert launch.k1_smem_bytes(cin, H, W, 3, 3, rows=1, ct=1, **WIDE_GEOM) \
        > launch.MAX_SMEM_BYTES
    assert launch.k1_smem_bytes(cin, H, W, 3, 3, rows=rows, ct=ct, cc=cc,
                                **WIDE_GEOM) <= launch.MAX_SMEM_BYTES
    chunks = [range(c0, min(c0 + cc, cin)) for c0 in range(0, cin, cc)]
    assert len(chunks) > 1 and sorted(c for ch in chunks for c in ch) == list(range(cin))
    geom = (False, cin, H, W, 64, (3, 3), WIDE_GEOM)
    gx, gy, gz = _grid(geom, n, rows, ct)
    _, _, ph, _ = launch.output_hw(H, W, 3, 3, **WIDE_GEOM)
    assert (gx - 1) * rows < ph <= gx * rows and (gz - 1) * ct < 64 <= gz * ct
    assert gy == n


@pytest.mark.parametrize("cin,H,W,want", WIDE, ids=["cin128@112", "cin256@56"])
def test_k1_chunked_input_keeps_one_launch(monkeypatch, cin, H, W, want):
    """A call whose input is staged in chunks is one kernel call, handed
    the tiling's three tile sizes: the chunks are restaged inside the CTA."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []

    class Kernel:  # stands in for the library's function: takes restype/argtypes
        def __call__(self, *args):
            calls.append([getattr(a, "value", a) for a in args])
            return 0

    lib = type("Lib", (), {"conv_pool_f32": Kernel()})()
    monkeypatch.setattr(launch.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    before = launch.K1_LAUNCHES.count
    # fake tensors' data pointers are 0, with a warning (once a process)
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        x = torch.empty(1, cin, H, W, device="cuda")
        w = torch.empty(64, cin, 3, 3, device="cuda")
        b = torch.empty(64, device="cuda")
        launch.conv_pool(x, w, b, padding=1)
    assert launch.K1_LAUNCHES.count - before == 1 and len(calls) == 1
    # (pointers, n, cin, h, w, cout, kh, kw, strides, paddings, pools, relu,
    # avg, rows, out channels, staged channels, batch strides, stream)
    assert calls[0][4:11] == [1, cin, H, W, 64, 3, 3]
    assert tuple(calls[0][21:24]) == want


# K2's (pooled rows, channel tile, staged input channels) per CTA on the
# main path, as k2_tiling gives them at N = 1 and 16: CIFAR's three steps
# and the two heads in int8.
K2_PINNED = {
    (("cifar", "conv1+maxpool1"), 1): (1, 3, 3),
    (("cifar", "conv1+maxpool1"), 16): (2, 16, 3),
    (("cifar", "conv2+maxpool2"), 1): (1, 1, 32),
    (("cifar", "conv2+maxpool2"), 16): (1, 8, 32),
    (("cifar", "conv3+maxpool3"), 1): (1, 2, 16),
    (("cifar", "conv3+maxpool3"), 16): (1, 8, 16),
    (KWS_HEAD, 1): (1, 1, 64),
    (KWS_HEAD, 16): (1, 7, 64),
    (("mobilenet", "pw13+pool"), 1): (1, 8, 256),
    (("mobilenet", "pw13+pool"), 16): (1, 26, 256),
}


# K4's tiling (K3's: pooled rows, channels) at N 1 and 16, by the depthwise
# step's (C, H, W, stride): one output a thread, so DS-CNN-KWS's 64 x 25 x 5
# runs on 256 CTAs at one image, MobileNet's 256 x 2 x 2 on 32.
K4_PINNED = {
    ((64, 25, 5, 1), 1): (7, 1), ((64, 25, 5, 1), 16): (25, 2),
    ((8, 32, 32, 1), 1): (1, 1), ((8, 32, 32, 1), 16): (8, 1),
    ((16, 32, 32, 2), 1): (2, 1), ((16, 32, 32, 2), 16): (16, 1),
    ((32, 16, 16, 1), 1): (2, 1), ((32, 16, 16, 1), 16): (16, 1),
    ((32, 16, 16, 2), 1): (4, 1), ((32, 16, 16, 2), 16): (8, 2),
    ((64, 8, 8, 1), 1): (4, 1), ((64, 8, 8, 1), 16): (8, 4),
    ((64, 8, 8, 2), 1): (4, 2), ((64, 8, 8, 2), 16): (4, 4),
    ((128, 4, 4, 1), 1): (4, 2), ((128, 4, 4, 1), 16): (4, 8),
    ((128, 4, 4, 2), 1): (2, 8), ((128, 4, 4, 2), 16): (2, 8),
    ((256, 2, 2, 1), 1): (2, 8), ((256, 2, 2, 1), 16): (2, 16),
}


def _k4_tiling():
    """The tiling K4's wrapper hands the launcher."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernel_q8, "conv_pool_call", lambda *a, **kw: seen.update(kw))
        kernel_q8.depthwise_conv_pool_q8(_x(q8=True), _x((4, 1, 3, 3), True), None,
                                         multiplier=0.5)
    return seen["tiling"]


FAMILY_STEPS = sorted(key for key, g in STEPS.items() if key[0] != "lenet5")
K2_STEPS = sorted(key for key in FAMILY_STEPS if not STEPS[key][0])


@pytest.mark.parametrize("n", (1, 16))
@pytest.mark.parametrize("step", FAMILY_STEPS, ids=lambda s: f"{s[0]}/{s[1]}")
def test_k2_k4_tiling_is_unchanged(step, n):
    """K4's tiling (K3's) and K2's own tiling are pinned."""
    dw, cin, H, W, cout, (kh, kw), kw_ = STEPS[step]
    if dw:  # K4, one output a thread
        key = (cout, H, W, kw_["conv_stride"][0])
        assert _k4_tiling()(n, 1, H, W, cout, kh, kw, **kw_) == K4_PINNED[key, n]
    else:  # K2
        assert launch.k2_tiling(n, cin, H, W, cout, kh, kw, **kw_) == K2_PINNED[step, n]


def _covers_once(geom, n, rows, ct):
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    _, _, ph, _ = launch.output_hw(H, W, kh, kw, **kw_)
    gx, gy, gz = _grid(geom, n, rows, ct)
    seen = {}
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                for p in range(bx * rows, min(bx * rows + rows, ph)):
                    for c in range(bz * ct, min(bz * ct + ct, cout)):
                        seen[by, p, c] = seen.get((by, p, c), 0) + 1
    return (len(seen) == n * ph * cout and set(seen.values()) == {1}
            and (gx - 1) * rows < ph and (gz - 1) * ct < cout)


@pytest.mark.parametrize("n", BUCKETS)
@pytest.mark.parametrize("step", K2_STEPS, ids=lambda s: f"{s[0]}/{s[1]}")
def test_k2_tiling_fits_and_covers_every_output_once(step, n):
    geom = STEPS[step]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct, cc = launch.k2_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    assert cc == cin  # the nets' layers stage every input channel at once
    assert launch.k2_smem_bytes(cin, H, W, kh, kw, rows=rows, ct=ct, cc=cc,
                                **kw_) <= launch.MAX_SMEM_BYTES
    assert _covers_once(geom, n, rows, ct)


@pytest.mark.parametrize("step,ctas", [(KWS_HEAD, 160), (("mobilenet", "pw13+pool"), 160)],
                         ids=["ds_cnn_kws", "mobilenet"])
def test_k2_spreads_the_int8_heads_over_the_card(step, ctas):
    """At 16 images K2's tiling splits the output channels of each int8
    head until every SM has a CTA (one tile of every channel gave 16)."""
    geom = STEPS[step]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct, _ = launch.k2_tiling(16, cin, H, W, cout, kh, kw, **kw_)
    gx, gy, gz = _grid(geom, 16, rows, ct)
    assert gx * gy * gz == ctas >= launch.K1_TARGET_CTAS


# K1's two wide layers in int8 (one pooled row of every input channel is
# 60,192 / 60,320 B staged as int8, so K2 needs no chunks), and a wider one
# whose int8 staged input (238,496 B for one pooled row) K2 cuts into chunks
# of input channels, whole words of 4.  (cin, H, W, cout, chunked)
K2_WIDE = [(128, 112, 112, 64, False), (256, 56, 56, 64, False), (1024, 56, 56, 16, True)]


@pytest.mark.parametrize("n", BUCKETS)
@pytest.mark.parametrize("cin,H,W,cout,chunked", K2_WIDE,
                         ids=["cin128@112", "cin256@56", "cin1024@56"])
def test_k2_tiling_of_wide_layers_fits_in_one_launch(cin, H, W, cout, chunked, n):
    rows, ct, cc = launch.k2_tiling(n, cin, H, W, cout, 3, 3, **WIDE_GEOM)
    assert launch.k2_smem_bytes(cin, H, W, 3, 3, rows=rows, ct=ct, cc=cc,
                                **WIDE_GEOM) <= launch.MAX_SMEM_BYTES
    assert (launch.k2_smem_bytes(cin, H, W, 3, 3, rows=1, ct=1, **WIDE_GEOM)
            > launch.MAX_SMEM_BYTES) == chunked
    assert (cc < cin) == chunked
    if chunked:
        assert cc % 4 == 0
    chunks = [range(c0, min(c0 + cc, cin)) for c0 in range(0, cin, cc)]
    assert sorted(c for ch in chunks for c in ch) == list(range(cin))
    assert _covers_once((False, cin, H, W, cout, (3, 3), WIDE_GEOM), n, rows, ct)


def test_k2_chunked_input_keeps_one_launch(monkeypatch):
    """K2's call whose input is staged in chunks is one kernel call, handed
    k2_tiling's three tile sizes and then the requant multiplier."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []

    class Kernel:
        def __call__(self, *args):
            calls.append([getattr(a, "value", a) for a in args])
            return 0

    lib = type("Lib", (), {"conv_pool_q8": Kernel()})()
    monkeypatch.setattr(launch.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    before = kernel_q8.K2_LAUNCHES.count
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        x = torch.empty(1, 1024, 56, 56, dtype=torch.int8, device="cuda")
        w = torch.empty(16, 1024, 3, 3, dtype=torch.int8, device="cuda")
        kernel_q8.conv_pool_q8(x, w, None, multiplier=0.5, padding=1)
    assert kernel_q8.K2_LAUNCHES.count - before == 1 and len(calls) == 1
    assert calls[0][4:11] == [1, 1024, 56, 56, 16, 3, 3]
    assert tuple(calls[0][21:24]) == (1, 3, 512)
    assert calls[0][26] == pytest.approx(0.5)


# K3's depthwise steps on the main path (DS-CNN-KWS and MobileNet-V1 0.25).
K3_STEPS = sorted(key for key, g in STEPS.items()
                  if g[0] and key[0] in ("ds_cnn_kws", "mobilenet"))


def test_the_main_path_has_every_depthwise_step_3x3():
    """All 4 + 13 depthwise steps take K3's unrolled 3x3 case."""
    assert len(K3_STEPS) == 17
    assert {STEPS[k][5] for k in K3_STEPS} == {(3, 3)}


@pytest.mark.parametrize("n", BUCKETS)
@pytest.mark.parametrize("step", K3_STEPS, ids=lambda s: f"{s[0]}/{s[1]}")
def test_k3_tiling_gives_one_output_a_thread_over_the_card(step, n):
    """Each tile holds at most 256 outputs, one a thread; the tiles cover
    every output once; the grid reaches 132 CTAs, or else each tile keeps
    a warp of outputs."""
    geom = STEPS[step]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct = depthwise.k3_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    _, _, ph, pw = launch.output_hw(H, W, kh, kw, **kw_)
    assert rows * ct * pw <= depthwise.K3_MAX_THREADS
    gx, gy, gz = _grid(geom, n, rows, ct)
    assert (gx - 1) * rows < ph <= gx * rows and (gz - 1) * ct < cout <= gz * ct
    assert gx * gy * gz >= depthwise.K3_TARGET_CTAS or \
        rows * ct * pw >= depthwise.K3_MIN_OUTPUTS


@pytest.mark.parametrize("n,want,ctas", [(1, (7, 1), 256), (16, (25, 2), 512)])
def test_k3_spreads_the_ds_cnn_kws_depthwise_steps_over_the_card(n, want, ctas):
    """64 channels of 25 x 5: one pooled row of every channel a CTA would
    give one image 25 CTAs of 320 outputs on 256 threads; K3 splits
    channels, then rows."""
    geom = STEPS[("ds_cnn_kws", "dw1")]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct = depthwise.k3_tiling(n, cin, H, W, cout, kh, kw, **kw_)
    assert (rows, ct) == want
    gx, gy, gz = _grid(geom, n, rows, ct)
    assert gx * gy * gz == ctas


@pytest.mark.parametrize("n", BUCKETS)
@pytest.mark.parametrize("step", K3_STEPS, ids=lambda s: f"{s[0]}/{s[1]}")
def test_k4_tiling_gives_one_output_a_thread_over_the_card(step, n):
    """K4's tiling, as its wrapper passes it, at every depthwise step of the
    int8 engines and every bucket: at most 256 outputs a tile, every output
    covered once, and 132 CTAs, or else a warp of outputs a tile."""
    geom = STEPS[step]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct = _k4_tiling()(n, 1, H, W, cout, kh, kw, **kw_)
    _, _, _, pw = launch.output_hw(H, W, kh, kw, **kw_)
    assert rows * ct * pw <= depthwise.K3_MAX_THREADS
    assert _covers_once(geom, n, rows, ct)
    gx, gy, gz = _grid(geom, n, rows, ct)
    assert gx * gy * gz >= depthwise.K3_TARGET_CTAS or \
        rows * ct * pw >= depthwise.K3_MIN_OUTPUTS


@pytest.mark.parametrize("n,ctas", [(1, 256), (16, 512)])
def test_k4_spreads_the_ds_cnn_kws_depthwise_steps_over_the_card(n, ctas):
    """DS-CNN-KWS's int8 64 x 25 x 5 step: 256 CTAs at one image, where one
    pooled row of every channel a CTA gave 25."""
    geom = STEPS[("ds_cnn_kws", "dw1")]
    _, cin, H, W, cout, (kh, kw), kw_ = geom
    rows, ct = _k4_tiling()(n, 1, H, W, cout, kh, kw, **kw_)
    gx, gy, gz = _grid(geom, n, rows, ct)
    assert gx * gy * gz == ctas


@pytest.mark.parametrize("call,want", [
    (lambda: launch.conv_pool(_x(), _x((4, 4, 3, 3)), None), launch.k1_tiling),
    (lambda: kernel_q8.conv_pool_q8(_x(q8=True), _x((4, 4, 3, 3), True), None,
                                    multiplier=0.5), launch.k2_tiling),
    (lambda: depthwise.depthwise_conv_pool(_x(), _x((4, 1, 3, 3)), None),
     depthwise.k3_tiling),
    (lambda: kernel_q8.depthwise_conv_pool_q8(_x(q8=True), _x((4, 1, 3, 3), True),
                                              None, multiplier=0.5), depthwise.k3_tiling),
], ids=["K1", "K2", "K3", "K4"])
def test_only_k1_takes_the_new_tiling(monkeypatch, call, want):
    """K1's wrapper passes ``k1_tiling`` to the shared launcher, K2's
    ``k2_tiling``, and K3's and K4's ``k3_tiling``: each kernel its own."""
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
