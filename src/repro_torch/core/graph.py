"""Layer-graph IRs for the paper's deployment pipeline.

Framework-free copy of ``repro/core/graph.py`` (the JAX package is the
reference and is not imported): the port plans and runs the same IR.

The paper ("Efficient Neural Network Deployment for Microcontroller", Unlu 2020)
treats a network as a strictly sequential chain of layers, each producing one
output buffer consumed by the next layer — :class:`SequentialGraph`.  This
module is the IR that the fusion pass (`repro_torch.core.fusion`), the memory planner
(`repro_torch.core.planner`), the ping-pong executor (`repro_torch.core.pingpong`) and the
C exporter (`repro.core.export_c`) all operate on.

Beyond the paper's sequential case, :class:`DAGGraph` generalizes the IR to
directed acyclic graphs with explicit edges and multi-input join nodes
(:class:`Add`, :class:`Concat`), the workload class where the paper's "layer
manipulation i.e. operator reordering" lever actually pays off (Liberis & Lane
2019).  DAGs are planned by `repro.core.schedule` (operator-reordering arena
planner); sequential-only entry points validate their input through
:func:`as_sequential`, which normalizes chain-shaped DAGs and raises a clear
error on branching ones.

Sizes are expressed in *elements*; the planner multiplies by dtype width.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Shape = Tuple[int, ...]
IntPair = Tuple[int, int]


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _pair(v) -> IntPair:
    """Normalize an int-or-``(h, w)`` geometry argument to an ``(h, w)`` pair.

    The conv/pool layer family stores every ``kernel_size``/``stride``/
    ``padding`` as a per-axis pair; plain ints are accepted everywhere and
    normalized here, so ``Conv2d(kernel_size=5) == Conv2d(kernel_size=(5, 5))``
    (dataclass equality and ``spec_key`` hashing see the normalized form).
    """
    if isinstance(v, (tuple, list)):
        h, w = v
        return (int(h), int(w))
    return (int(v), int(v))


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Base class: a layer maps an input shape to an output shape."""

    name: str = dataclasses.field(default="", kw_only=True)

    def out_shape(self, in_shape: Shape) -> Shape:  # pragma: no cover - abstract
        raise NotImplementedError

    def out_shape_multi(self, in_shapes: Sequence[Shape]) -> Shape:
        """Output shape from *all* input shapes (DAG form).

        Single-input layers delegate to :meth:`out_shape`; join nodes
        (:class:`Add`, :class:`Concat`) override this.
        """
        if len(in_shapes) != 1:
            raise ValueError(
                f"{self.name or self.kind}: takes exactly one input, "
                f"got {len(in_shapes)}"
            )
        return self.out_shape(in_shapes[0])

    def param_count(self) -> int:
        return 0

    def weight_count(self) -> int:
        """Parameters excluding biases (the paper's §5 counting convention)."""
        return self.param_count()

    def macs(self, in_shape: Shape) -> int:
        """Multiply-accumulates for one inference at ``in_shape``.

        The static cost model behind ``obs/report.py``: compute-bearing
        layers (conv / depthwise / linear and their fused forms) override
        this; data-movement layers (pool, relu, flatten, joins) cost 0 MACs
        by the usual convention (CMSIS-NN / Zhang et al. count the same
        way).
        """
        return 0

    @property
    def kind(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Input(LayerSpec):
    """Pseudo-layer holding the network input buffer (paper counts it)."""

    shape: Shape = ()

    def out_shape(self, in_shape: Shape) -> Shape:
        return self.shape


@dataclasses.dataclass(frozen=True)
class Conv2d(LayerSpec):
    """2D convolution, CHW layout (paper uses PyTorch semantics).

    ``kernel_size``/``stride``/``padding`` are per-axis ``(h, w)`` pairs;
    plain ints are normalized to square pairs in ``__post_init__`` (so every
    pre-rectangular call site is unchanged, including dataclass equality).
    """

    in_channels: int = 0
    out_channels: int = 0
    kernel_size: "int | IntPair" = 1
    stride: "int | IntPair" = 1
    padding: "int | IntPair" = 0
    bias: bool = True

    def __post_init__(self) -> None:
        object.__setattr__(self, "kernel_size", _pair(self.kernel_size))
        object.__setattr__(self, "stride", _pair(self.stride))
        object.__setattr__(self, "padding", _pair(self.padding))

    def out_shape(self, in_shape: Shape) -> Shape:
        c, h, w = in_shape
        if c != self.in_channels:
            raise ValueError(
                f"{self.name or 'Conv2d'}: expected {self.in_channels} input "
                f"channels, got shape {in_shape}"
            )
        oh = (h + 2 * self.padding[0] - self.kernel_size[0]) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - self.kernel_size[1]) // self.stride[1] + 1
        return (self.out_channels, oh, ow)

    def param_count(self) -> int:
        n = self.weight_count()
        if self.bias:
            n += self.out_channels
        return n

    def weight_count(self) -> int:
        kh, kw = self.kernel_size
        return self.out_channels * self.in_channels * kh * kw

    def macs(self, in_shape: Shape) -> int:
        _, oh, ow = self.out_shape(in_shape)
        kh, kw = self.kernel_size
        return self.out_channels * oh * ow * self.in_channels * kh * kw


@dataclasses.dataclass(frozen=True)
class DepthwiseConv2d(LayerSpec):
    """Depthwise 2D convolution: one k×k filter per channel (groups = C).

    The MobileNet/DS-CNN building block (Howard et al. 2017; Zhang et al.
    2017 "Hello Edge"); CMSIS-NN ships it as
    ``arm_depthwise_separable_conv_HWC_q7``.  Weight layout is grouped OIHW
    ``(C, 1, k, k)`` — exactly PyTorch's ``Conv2d(C, C, k, groups=C)`` —
    so per-channel filters stack like ordinary conv weights under the scan
    executors.  Channel count is preserved by construction; the following
    1×1 :class:`Conv2d` supplies the cross-channel mixing (the separable
    pair).
    """

    channels: int = 0
    kernel_size: "int | IntPair" = 1
    stride: "int | IntPair" = 1
    padding: "int | IntPair" = 0
    bias: bool = True

    def __post_init__(self) -> None:
        object.__setattr__(self, "kernel_size", _pair(self.kernel_size))
        object.__setattr__(self, "stride", _pair(self.stride))
        object.__setattr__(self, "padding", _pair(self.padding))

    def out_shape(self, in_shape: Shape) -> Shape:
        c, h, w = in_shape
        if c != self.channels:
            raise ValueError(
                f"{self.name or 'DepthwiseConv2d'}: expected {self.channels} "
                f"input channels, got shape {in_shape}"
            )
        oh = (h + 2 * self.padding[0] - self.kernel_size[0]) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - self.kernel_size[1]) // self.stride[1] + 1
        return (self.channels, oh, ow)

    def param_count(self) -> int:
        n = self.weight_count()
        if self.bias:
            n += self.channels
        return n

    def weight_count(self) -> int:
        kh, kw = self.kernel_size
        return self.channels * kh * kw

    def macs(self, in_shape: Shape) -> int:
        _, oh, ow = self.out_shape(in_shape)
        kh, kw = self.kernel_size
        return self.channels * oh * ow * kh * kw


@dataclasses.dataclass(frozen=True)
class ReLU(LayerSpec):
    def out_shape(self, in_shape: Shape) -> Shape:
        return in_shape


@dataclasses.dataclass(frozen=True)
class MaxPool2d(LayerSpec):
    kernel_size: "int | IntPair" = 2
    stride: "int | IntPair" = 2
    padding: "int | IntPair" = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "kernel_size", _pair(self.kernel_size))
        object.__setattr__(self, "stride", _pair(self.stride))
        object.__setattr__(self, "padding", _pair(self.padding))

    def out_shape(self, in_shape: Shape) -> Shape:
        c, h, w = in_shape
        oh = (h + 2 * self.padding[0] - self.kernel_size[0]) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - self.kernel_size[1]) // self.stride[1] + 1
        return (c, oh, ow)


@dataclasses.dataclass(frozen=True)
class AvgPool2d(LayerSpec):
    """Average pooling with PyTorch's default semantics.

    Padding (when present) is **counted in the divisor**
    (``count_include_pad=True``, the PyTorch default): the window is
    zero-padded and every window divides by the full ``kh·kw`` regardless of
    how many taps were in bounds.  Under symmetric int8 quantization the
    zero point is 0, so zero padding is exact in the int8 domain too; the
    int8 backends sum the window in int32 and requantize once with the
    ``1/(kh·kw)`` divisor folded into the multiplier (CMSIS-NN style).
    """

    kernel_size: "int | IntPair" = 2
    stride: "int | IntPair" = 2
    padding: "int | IntPair" = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "kernel_size", _pair(self.kernel_size))
        object.__setattr__(self, "stride", _pair(self.stride))
        object.__setattr__(self, "padding", _pair(self.padding))

    def out_shape(self, in_shape: Shape) -> Shape:
        c, h, w = in_shape
        oh = (h + 2 * self.padding[0] - self.kernel_size[0]) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - self.kernel_size[1]) // self.stride[1] + 1
        return (c, oh, ow)


@dataclasses.dataclass(frozen=True)
class Flatten(LayerSpec):
    def out_shape(self, in_shape: Shape) -> Shape:
        return (_prod(in_shape),)


@dataclasses.dataclass(frozen=True)
class Linear(LayerSpec):
    in_features: int = 0
    out_features: int = 0
    bias: bool = True

    def out_shape(self, in_shape: Shape) -> Shape:
        if _prod(in_shape) != self.in_features:
            raise ValueError(
                f"{self.name or 'Linear'}: expected {self.in_features} inputs, "
                f"got shape {in_shape}"
            )
        return (self.out_features,)

    def param_count(self) -> int:
        n = self.in_features * self.out_features
        if self.bias:
            n += self.out_features
        return n

    def weight_count(self) -> int:
        return self.in_features * self.out_features

    def macs(self, in_shape: Shape) -> int:
        return self.in_features * self.out_features


@dataclasses.dataclass(frozen=True)
class FusedConvPool(LayerSpec):
    """Paper §3.1: conv + activation + max-pool fused in one pass (Algorithm 1).

    Produced by the fusion pass when ``pool.stride >= pool.kernel_size`` —
    the conv output is reduced *in flight*, so only the pooled output
    (``m*n/s²`` instead of ``m*n``) is ever buffered.

    ``line_buffer_rows`` supports the paper's §7 future-work extension: for
    ``stride < kernel_size`` the fusion still applies but needs a line buffer
    of ``kernel_size - stride`` pooled rows (accounted by the planner as
    scratch, not as an inter-layer buffer).

    ``conv`` may be a :class:`Conv2d` or a :class:`DepthwiseConv2d` — the
    fused loop structure is identical, only the per-tap accumulation
    differs.  ``pool_padding`` exists solely to make the fusion pass's
    restriction explicit at construction time: the fused running-max loop
    assumes an unpadded pool (``fusion`` declines padded windows), so a
    hand-built ``FusedConvPool`` over a padded pool raises here instead of
    silently mis-shaping the arena plan (``out_shape`` would otherwise
    drop the padding the pool's ``out_shape`` honored).

    All pool geometry is per-axis (ints normalize to square pairs) and the
    eligibility conditions are per-axis too: the zero-scratch in-flight
    reduction needs ``stride >= kernel`` on **both** axes; the §7
    line-buffer form covers H-overlap (``sh < kh``, ``line_buffer_rows =
    kh - sh`` pooled rows of scratch), but a W-only overlap (``sh >= kh``
    while ``sw < kw``) has no line-buffer formulation — pooled columns
    would need partial running maxes across a row the single-pass loop has
    already written — so construction rejects it (the scalar check used to
    accept this case by conflating the axes).

    ``pool`` selects the reduction: ``"max"`` (Algorithm 1) or ``"avg"``
    (:class:`AvgPool2d` semantics).  A fused average pool accumulates the
    window **sum** in the accumulator domain and applies the divisor at
    requantization time — sum-then-requant is not requant-then-sum, so
    overlap would force re-reading accumulator values; fused ``"avg"``
    therefore requires ``stride >= kernel`` on both axes and no padding.
    """

    conv: Conv2d = None  # type: ignore[assignment]
    activation: str = "relu"
    pool_kernel: "int | IntPair" = 2
    pool_stride: "int | IntPair" = 2
    pool_padding: "int | IntPair" = 0
    line_buffer_rows: int = 0
    pool: str = "max"

    def __post_init__(self) -> None:
        object.__setattr__(self, "pool_kernel", _pair(self.pool_kernel))
        object.__setattr__(self, "pool_stride", _pair(self.pool_stride))
        object.__setattr__(self, "pool_padding", _pair(self.pool_padding))
        if not isinstance(self.conv, (Conv2d, DepthwiseConv2d)):
            raise TypeError(
                f"{self.name or 'FusedConvPool'}: conv must be Conv2d or "
                f"DepthwiseConv2d, got {self.conv!r}"
            )
        if self.pool not in ("max", "avg"):
            raise ValueError(
                f"{self.name or 'FusedConvPool'}: pool must be 'max' or "
                f"'avg', got {self.pool!r}"
            )
        if self.pool_padding != (0, 0):
            raise ValueError(
                f"{self.name or 'FusedConvPool'}: fused pooling does not "
                f"support pool padding (got {self.pool_padding}) — the fusion "
                f"pass declines padded pool windows; keep the pool as a "
                f"standalone layer"
            )
        (pkh, pkw), (psh, psw) = self.pool_kernel, self.pool_stride
        if min(pkh, pkw) < 1 or min(psh, psw) < 1:
            raise ValueError(
                f"{self.name or 'FusedConvPool'}: pool_kernel/pool_stride "
                f"must be >= 1"
            )
        if psw < pkw and psh >= pkh:
            raise ValueError(
                f"{self.name or 'FusedConvPool'}: W-only pool overlap "
                f"(stride {self.pool_stride} < kernel {self.pool_kernel} on "
                f"W but not H) has no line-buffer formulation — the fusion "
                f"pass declines this window; keep the pool standalone"
            )
        if self.pool == "avg" and (psh < pkh or psw < pkw):
            raise ValueError(
                f"{self.name or 'FusedConvPool'}: fused average pooling "
                f"requires stride >= kernel on both axes (sum-then-requant "
                f"cannot line-buffer overlapping windows); got kernel "
                f"{self.pool_kernel}, stride {self.pool_stride}"
            )

    def out_shape(self, in_shape: Shape) -> Shape:
        conv_out = self.conv.out_shape(in_shape)
        c, h, w = conv_out
        oh = (h - self.pool_kernel[0]) // self.pool_stride[0] + 1
        ow = (w - self.pool_kernel[1]) // self.pool_stride[1] + 1
        return (c, oh, ow)

    def conv_out_shape(self, in_shape: Shape) -> Shape:
        return self.conv.out_shape(in_shape)

    def scratch_elements(self, in_shape: Shape) -> int:
        """Extra scratch needed beyond the output buffer (paper §7 case)."""
        if self.line_buffer_rows == 0:
            return 0
        oc, _, ow_conv = self.conv.out_shape(in_shape)
        return self.line_buffer_rows * ow_conv * oc

    def param_count(self) -> int:
        return self.conv.param_count()

    def macs(self, in_shape: Shape) -> int:
        """Fusion changes where the conv output lives, not how many taps are
        computed — identical to the unfused conv's MACs."""
        return self.conv.macs(in_shape)


@dataclasses.dataclass(frozen=True)
class FusedLinear(LayerSpec):
    """Linear + activation fused (no interim pre-activation buffer)."""

    linear: Linear = None  # type: ignore[assignment]
    activation: str = "relu"

    def out_shape(self, in_shape: Shape) -> Shape:
        return self.linear.out_shape(in_shape)

    def param_count(self) -> int:
        return self.linear.param_count()

    def macs(self, in_shape: Shape) -> int:
        return self.linear.macs(in_shape)


@dataclasses.dataclass(frozen=True)
class OpaqueLayer(LayerSpec):
    """Escape hatch for arbitrary layers (used to plan LM blocks: the planner
    only needs output sizes, which is exactly the paper's abstraction)."""

    out_fn: Callable[[Shape], Shape] = None  # type: ignore[assignment]
    params: int = 0
    scratch: int = 0

    def out_shape(self, in_shape: Shape) -> Shape:
        return self.out_fn(in_shape)

    def param_count(self) -> int:
        return self.params


@dataclasses.dataclass(frozen=True)
class Add(LayerSpec):
    """Elementwise sum of two or more equal-shape inputs (residual join)."""

    def out_shape(self, in_shape: Shape) -> Shape:
        raise TypeError(f"{self.name or 'Add'} is multi-input; use out_shape_multi")

    def out_shape_multi(self, in_shapes: Sequence[Shape]) -> Shape:
        if len(in_shapes) < 2:
            raise ValueError(f"{self.name or 'Add'}: needs >= 2 inputs")
        first = in_shapes[0]
        if any(tuple(s) != tuple(first) for s in in_shapes[1:]):
            raise ValueError(
                f"{self.name or 'Add'}: all inputs must share one shape, "
                f"got {list(in_shapes)}"
            )
        return tuple(first)


@dataclasses.dataclass(frozen=True)
class Concat(LayerSpec):
    """Concatenation of two or more inputs along one (negative) axis.

    ``axis`` is counted from the *end* of the unbatched shape so the same
    spec applies batched and unbatched: ``-3`` is the channel axis in CHW
    (the default), ``-1`` concatenates flat vectors.  The C emitter requires
    the axis to be the leading (slowest-varying) axis of the unbatched
    layout, which makes the concat a pair of contiguous copies.
    """

    axis: int = -3

    def out_shape(self, in_shape: Shape) -> Shape:
        raise TypeError(f"{self.name or 'Concat'} is multi-input; use out_shape_multi")

    def out_shape_multi(self, in_shapes: Sequence[Shape]) -> Shape:
        if len(in_shapes) < 2:
            raise ValueError(f"{self.name or 'Concat'}: needs >= 2 inputs")
        if self.axis >= 0:
            raise ValueError(f"{self.name or 'Concat'}: axis must be negative (from end)")
        first = tuple(in_shapes[0])
        ax = len(first) + self.axis
        if ax < 0:
            raise ValueError(f"{self.name or 'Concat'}: axis {self.axis} out of range for {first}")
        for s in in_shapes[1:]:
            s = tuple(s)
            if len(s) != len(first) or s[:ax] != first[:ax] or s[ax + 1:] != first[ax + 1:]:
                raise ValueError(
                    f"{self.name or 'Concat'}: shapes must agree off axis "
                    f"{self.axis}, got {list(in_shapes)}"
                )
        total = sum(int(s[ax]) for s in in_shapes)
        return first[:ax] + (total,) + first[ax + 1:]


# Layers whose output physically aliases their input buffer (zero-copy views /
# elementwise in-place ops).  The planner assigns them no new buffer.
_INPLACE_KINDS = ("ReLU", "Flatten")


def spec_key(layer: LayerSpec) -> LayerSpec:
    """Layer identity modulo names — equal keys ⇒ identical specs.

    Two layers with equal spec keys have the same kind and hyper-parameters
    (hence identical parameter shapes): their weights stack along a new
    leading axis and they can share one compiled dispatch.  This is the
    isomorphism test the segment compiler (`repro_torch.core.segments`) uses both
    along chains (stacked ``lax.scan`` runs) and across branches (batched
    isomorphic-branch scans).  The key is itself a frozen dataclass, so it
    hashes — segment grouping can bucket layers by ``hash(spec_key(l))``.
    """
    stripped = dataclasses.replace(layer, name="")
    inner = getattr(stripped, "conv", None)
    if inner is not None:
        stripped = dataclasses.replace(stripped, conv=dataclasses.replace(inner, name=""))
    inner = getattr(stripped, "linear", None)
    if inner is not None:
        stripped = dataclasses.replace(stripped, linear=dataclasses.replace(inner, name=""))
    return stripped


@dataclasses.dataclass
class SequentialGraph:
    """A strictly sequential network: ``layers[0]`` must be :class:`Input`."""

    layers: list

    def __post_init__(self) -> None:
        if not self.layers or not isinstance(self.layers[0], Input):
            raise ValueError("SequentialGraph must start with an Input layer")

    # -- structural queries --------------------------------------------------
    def shapes(self) -> list:
        """Output shape of every layer, including the input pseudo-layer."""
        out = []
        cur: Shape = ()
        for layer in self.layers:
            cur = layer.out_shape(cur)
            out.append(cur)
        return out

    def materialized_layers(self) -> list:
        """(layer, out_shape) for layers that own a distinct buffer.

        ReLU / Flatten are views over their input (the paper folds ReLU into
        the conv layer: "ReLU layer can be part of the convolution layer, so
        there is no additional memory needed for it").
        """
        out = []
        for layer, shape in zip(self.layers, self.shapes()):
            if layer.kind in _INPLACE_KINDS:
                continue
            out.append((layer, shape))
        return out

    def buffer_sizes(self) -> list:
        """Element count of every materialized inter-layer buffer, in order.

        This is the list the paper calls ``L`` in §3.2.
        """
        return [_prod(s) for _, s in self.materialized_layers()]

    def param_count(self) -> int:
        return sum(layer.param_count() for layer in self.layers)

    def weight_count(self) -> int:
        """Bias-free parameter count (paper's §5 convention)."""
        return sum(layer.weight_count() for layer in self.layers)

    def param_bytes(self, dtype_bytes: int = 4) -> int:
        return self.param_count() * dtype_bytes

    def validate(self) -> None:
        self.shapes()  # raises on any shape mismatch


@dataclasses.dataclass(frozen=True)
class Node:
    """One DAG vertex: a layer plus the names of its producer nodes."""

    layer: LayerSpec
    inputs: Tuple[str, ...] = ()

    @property
    def name(self) -> str:
        return self.layer.name or self.layer.kind


@dataclasses.dataclass
class DAGGraph:
    """A directed acyclic layer graph with explicit edges.

    ``nodes`` must be listed in a topological order (every node's inputs
    appear earlier in the list) — that listing order is the *naive* schedule
    the reorder search in `repro.core.schedule` improves on.  Exactly one
    :class:`Input` node (first), unique non-empty node names, and a single
    output node (``output`` or, by default, the last listed node).
    """

    nodes: List[Node]
    output: Optional[str] = None

    def __post_init__(self) -> None:
        if not self.nodes or not isinstance(self.nodes[0].layer, Input):
            raise ValueError("DAGGraph must start with an Input node")
        seen: Dict[str, Node] = {}
        for node in self.nodes:
            if not isinstance(node, Node):
                raise TypeError(f"DAGGraph nodes must be Node, got {node!r}")
            if isinstance(node.layer, Input) and node is not self.nodes[0]:
                raise ValueError("DAGGraph supports exactly one Input node")
            if node.name in seen:
                raise ValueError(f"duplicate node name {node.name!r}")
            if isinstance(node.layer, Input) and node.inputs:
                raise ValueError("Input node takes no inputs")
            if not isinstance(node.layer, Input) and not node.inputs:
                raise ValueError(f"node {node.name!r} has no inputs")
            for src in node.inputs:
                if src not in seen:
                    raise ValueError(
                        f"node {node.name!r} reads {src!r} which is not defined "
                        f"earlier — nodes must be listed topologically"
                    )
            seen[node.name] = node
        if self.output is None:
            self.output = self.nodes[-1].name
        elif self.output not in seen:
            raise ValueError(f"output node {self.output!r} not in graph")

    # -- structural queries --------------------------------------------------
    @property
    def layers(self) -> list:
        """The node layers in listing order (shared accounting with
        :class:`SequentialGraph`: ``init_params``/``param_count`` etc. iterate
        ``graph.layers``)."""
        return [n.layer for n in self.nodes]

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def shapes(self) -> Dict[str, Shape]:
        """Output shape of every node, keyed by node name."""
        out: Dict[str, Shape] = {}
        for node in self.nodes:
            if isinstance(node.layer, Input):
                out[node.name] = tuple(node.layer.shape)
            else:
                out[node.name] = node.layer.out_shape_multi(
                    [out[src] for src in node.inputs]
                )
        return out

    def consumers(self) -> Dict[str, Tuple[str, ...]]:
        """name -> names of the nodes that read it, in listing order."""
        out: Dict[str, List[str]] = {n.name: [] for n in self.nodes}
        for node in self.nodes:
            for src in node.inputs:
                out[src].append(node.name)
        return {k: tuple(v) for k, v in out.items()}

    def param_count(self) -> int:
        return sum(layer.param_count() for layer in self.layers)

    def weight_count(self) -> int:
        return sum(layer.weight_count() for layer in self.layers)

    def param_bytes(self, dtype_bytes: int = 4) -> int:
        return self.param_count() * dtype_bytes

    def validate(self) -> None:
        shapes = self.shapes()  # raises on shape mismatch
        cons = self.consumers()
        dangling = [
            n for n, c in cons.items()
            if not c and n != self.output
        ]
        if dangling:
            raise ValueError(f"nodes {dangling} have no consumer and are not the output")
        del shapes

    # -- chain interop -------------------------------------------------------
    def is_chain(self) -> bool:
        """True iff the DAG is a single sequential chain in listing order."""
        for i, node in enumerate(self.nodes[1:], start=1):
            if node.inputs != (self.nodes[i - 1].name,):
                return False
        return self.output == self.nodes[-1].name

    def to_sequential(self) -> SequentialGraph:
        if not self.is_chain():
            raise ValueError(
                f"DAGGraph with joins/branches cannot convert to SequentialGraph"
            )
        return SequentialGraph([n.layer for n in self.nodes])

    @staticmethod
    def from_sequential(graph: SequentialGraph) -> "DAGGraph":
        """Lift a sequential chain into the DAG IR (names must be unique)."""
        nodes: List[Node] = []
        prev: Optional[str] = None
        for layer in graph.layers:
            node = Node(layer=layer, inputs=(prev,) if prev is not None else ())
            nodes.append(node)
            prev = node.name
        return DAGGraph(nodes)


def as_sequential(graph, *, caller: str) -> SequentialGraph:
    """Shared validation/normalization for sequential-only entry points.

    ``SequentialGraph`` passes through; a chain-shaped :class:`DAGGraph` is
    normalized via :meth:`DAGGraph.to_sequential`; a branching DAG raises a
    clear :class:`TypeError` pointing at the DAG planner instead of failing
    later with an opaque shape/attribute crash.
    """
    if isinstance(graph, SequentialGraph):
        return graph
    if isinstance(graph, DAGGraph):
        if graph.is_chain():
            return graph.to_sequential()
        raise TypeError(
            f"{caller}: got a branching DAGGraph — sequential-only paths "
            f"cannot plan/execute join nodes; use repro.core.schedule.plan_dag "
            f"and the DAG executors instead"
        )
    raise TypeError(
        f"{caller}: expected SequentialGraph (or chain DAGGraph), "
        f"got {type(graph).__name__}"
    )


def lenet5() -> SequentialGraph:
    """The paper's §3 LeNet-5 (exact PyTorch layout from the paper)."""
    return SequentialGraph(
        [
            Input(shape=(1, 32, 32), name="input"),
            Conv2d(1, 6, kernel_size=5, stride=1, name="conv1"),
            ReLU(name="relu1"),
            MaxPool2d(kernel_size=2, stride=2, name="maxpool1"),
            Conv2d(6, 16, kernel_size=5, stride=1, name="conv2"),
            ReLU(name="relu2"),
            MaxPool2d(kernel_size=2, stride=2, name="maxpool2"),
            Flatten(name="flatten"),
            Linear(400, 120, name="fc1"),
            ReLU(name="relu3"),
            Linear(120, 84, name="fc2"),
            ReLU(name="relu4"),
            Linear(84, 10, name="fc3"),
        ]
    )


def cifar_testnet() -> SequentialGraph:
    """The paper's §5 test network (CMSIS-NN comparison, int8)."""
    return SequentialGraph(
        [
            Input(shape=(3, 32, 32), name="input"),
            Conv2d(3, 32, kernel_size=5, stride=1, padding=2, name="conv1"),
            ReLU(name="relu1"),
            MaxPool2d(kernel_size=2, stride=2, name="maxpool1"),
            Conv2d(32, 16, kernel_size=5, stride=1, padding=2, name="conv2"),
            ReLU(name="relu2"),
            MaxPool2d(kernel_size=2, stride=2, name="maxpool2"),
            Conv2d(16, 32, kernel_size=5, stride=1, padding=2, name="conv3"),
            ReLU(name="relu3"),
            MaxPool2d(kernel_size=2, stride=2, name="maxpool3"),
            Flatten(name="flatten"),
            Linear(512, 10, name="fc1"),
        ]
    )


def ds_cnn() -> DAGGraph:
    """Zhang et al. (2017) "Hello Edge" DS-CNN — the keyword-spotting
    depthwise-separable CNN CMSIS-NN uses as its flagship benchmark —
    expressed in this repo's square-kernel layer family.

    Input is the standard KWS feature map: 49 MFCC frames × 10 cepstral
    coefficients, one channel.  A strided stem conv lifts to 64 channels,
    then four depthwise-separable blocks (3×3 :class:`DepthwiseConv2d` +
    ReLU, 1×1 pointwise :class:`Conv2d` + ReLU) at constant width, a final
    pool collapsing the 25×5 map, and the 12-way FC (10 keywords +
    silence + unknown).  Deviations from the paper's exact net (kept for
    plan-byte continuity — this builder's arena tables are pinned): the
    10×4 stem kernel is approximated as 5×5 and the average pool as a max
    pool; buffer sizes — what the planner tables measure — are unchanged.
    :func:`ds_cnn_kws` is the true Zhang et al. topology (rectangular
    ``(10, 4)`` stem, :class:`AvgPool2d` head) now that the layer family
    is per-axis.

    The net is a chain, so it exercises the sequential *and* DAG stacks:
    `repro.core.schedule.plan_dag` prices the two-bank ping-pong packing,
    and the last pointwise conv + ReLU + pool fuses to a zero-scratch
    :class:`FusedConvPool`.
    """
    nodes = [
        Node(Input(shape=(1, 49, 10), name="input")),
        Node(Conv2d(1, 64, kernel_size=5, stride=2, padding=2, name="conv1"),
             ("input",)),
        Node(ReLU(name="conv1_relu"), ("conv1",)),
    ]
    prev = "conv1_relu"
    for i in range(1, 5):
        dw, pw = f"dw{i}", f"pw{i}"
        nodes += [
            Node(DepthwiseConv2d(64, kernel_size=3, padding=1, name=dw), (prev,)),
            Node(ReLU(name=f"{dw}_relu"), (dw,)),
            Node(Conv2d(64, 64, kernel_size=1, name=pw), (f"{dw}_relu",)),
            Node(ReLU(name=f"{pw}_relu"), (pw,)),
        ]
        prev = f"{pw}_relu"
    nodes += [
        Node(MaxPool2d(kernel_size=5, stride=5, name="pool"), (prev,)),
        Node(Flatten(name="flatten"), ("pool",)),
        Node(Linear(320, 12, name="fc"), ("flatten",)),
    ]
    return DAGGraph(nodes)


def ds_cnn_kws() -> DAGGraph:
    """Zhang et al. (2017) "Hello Edge" DS-CNN in its **true** form.

    The exact keyword-spotting topology from the paper (Table 2, DS-CNN):
    a rectangular ``(10, 4)`` stride-``(2, 2)`` stem conv over the
    ``49 × 10`` MFCC map (``"same"``-style padding ``(5, 1)`` → a
    ``25 × 5`` map at 64 channels), four depthwise-separable blocks
    (3×3 :class:`DepthwiseConv2d` + ReLU, 1×1 pointwise + ReLU), an
    **average** pool collapsing the ``25 × 5`` map (:class:`AvgPool2d`,
    the head the square-kernel era approximated with a max pool), and the
    12-way FC.  The final pointwise conv + ReLU + avg-pool window fuses to
    a zero-scratch ``pool="avg"`` :class:`FusedConvPool` (stride = kernel
    on both axes).
    """
    nodes = [
        Node(Input(shape=(1, 49, 10), name="input")),
        Node(Conv2d(1, 64, kernel_size=(10, 4), stride=(2, 2),
                    padding=(5, 1), name="conv1"), ("input",)),
        Node(ReLU(name="conv1_relu"), ("conv1",)),
    ]
    prev = "conv1_relu"
    for i in range(1, 5):
        dw, pw = f"dw{i}", f"pw{i}"
        nodes += [
            Node(DepthwiseConv2d(64, kernel_size=3, padding=1, name=dw), (prev,)),
            Node(ReLU(name=f"{dw}_relu"), (dw,)),
            Node(Conv2d(64, 64, kernel_size=1, name=pw), (f"{dw}_relu",)),
            Node(ReLU(name=f"{pw}_relu"), (pw,)),
        ]
        prev = f"{pw}_relu"
    nodes += [
        Node(AvgPool2d(kernel_size=(25, 5), stride=(25, 5), name="pool"), (prev,)),
        Node(Flatten(name="flatten"), ("pool",)),
        Node(Linear(64, 12, name="fc"), ("flatten",)),
    ]
    return DAGGraph(nodes)


def mobilenet_v1(width: float = 0.25, num_classes: int = 10) -> DAGGraph:
    """MobileNet-V1 (Howard et al. 2017) at a width multiplier, MCU-sized.

    The standard MCU vision benchmark (CMSIS-NN, Lai et al. 1801.06601;
    the deep-compression line, Deutel et al. 2205.10369): a stride-2 3×3
    stem then the 13 depthwise-separable blocks, with the canonical
    channel ladder ``32→64→128→…→1024`` scaled by ``width`` and the four
    interior stride-2 **depthwise** convs — the workload that exercises
    ``DepthwiseConv2d(stride=2)`` end-to-end.  Input is ``(3, 64, 64)``
    (the 0.25× MCU deployments run reduced resolution), so the backbone
    ends at a ``2 × 2`` map collapsed by a global :class:`AvgPool2d`.
    """

    def ch(c: int) -> int:
        return max(8, int(c * width))

    nodes = [
        Node(Input(shape=(3, 64, 64), name="input")),
        Node(Conv2d(3, ch(32), kernel_size=3, stride=2, padding=1,
                    name="conv0"), ("input",)),
        Node(ReLU(name="conv0_relu"), ("conv0",)),
    ]
    prev = "conv0_relu"
    # (out_channels, depthwise stride) for the 13 separable blocks.
    ladder = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
              (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
              (1024, 2), (1024, 1)]
    in_ch = ch(32)
    for i, (c_out, s) in enumerate(ladder, start=1):
        dw, pw = f"dw{i}", f"pw{i}"
        out_ch = ch(c_out)
        nodes += [
            Node(DepthwiseConv2d(in_ch, kernel_size=3, stride=s, padding=1,
                                 name=dw), (prev,)),
            Node(ReLU(name=f"{dw}_relu"), (dw,)),
            Node(Conv2d(in_ch, out_ch, kernel_size=1, name=pw),
                 (f"{dw}_relu",)),
            Node(ReLU(name=f"{pw}_relu"), (pw,)),
        ]
        prev = f"{pw}_relu"
        in_ch = out_ch
    nodes += [
        Node(AvgPool2d(kernel_size=2, stride=2, name="pool"), (prev,)),
        Node(Flatten(name="flatten"), ("pool",)),
        Node(Linear(in_ch, num_classes, name="fc"), ("flatten",)),
    ]
    return DAGGraph(nodes)


def residual_cifar() -> DAGGraph:
    """A small branching CIFAR net: a Concat merge block + a two-tower
    residual block with *isomorphic* branches.

    This is the non-sequential workload (ROADMAP): a two-branch merge block
    whose *listing* order (projection branch first) is deliberately the
    memory-naive one — the wide branch's 16×16×16 intermediate then coexists
    with the projection output — so the reorder search in
    `repro.core.schedule` has a strict win to find (run the wide branch while
    only the block input is live, the fat-output projection last).

    The residual block runs two branches with identical specs (two
    conv+relu pairs each, weights independent): the segment compiler
    (`repro_torch.core.segments`) detects the isomorphism and compiles both
    branches into one ``lax.scan`` with a batched two-bank carry instead of
    per-branch dispatch — the DAG counterpart of the sequential
    stacked-weight scan.
    """
    nodes = [
        Node(Input(shape=(3, 32, 32), name="input")),
        # stem: conv+relu+pool (fuses to one FusedConvPool, (8,16,16))
        Node(Conv2d(3, 8, kernel_size=3, padding=1, name="conv0"), ("input",)),
        Node(ReLU(name="relu0"), ("conv0",)),
        Node(MaxPool2d(kernel_size=2, stride=2, name="pool0"), ("relu0",)),
        # merge block, naive listing: projection branch first
        Node(Conv2d(8, 12, kernel_size=1, name="proj"), ("pool0",)),
        Node(Conv2d(8, 16, kernel_size=3, padding=1, name="wide1"), ("pool0",)),
        Node(ReLU(name="wide1_relu"), ("wide1",)),
        Node(Conv2d(16, 4, kernel_size=3, padding=1, name="wide2"), ("wide1_relu",)),
        Node(Concat(axis=-3, name="cat"), ("proj", "wide2")),
        Node(MaxPool2d(kernel_size=2, stride=2, name="pool1"), ("cat",)),
    ]
    # residual block at (16,8,8): two isomorphic towers of two conv+relu
    # pairs, joined with the block input by a three-way Add.
    tails = []
    for tower in ("a", "b"):
        prev = "pool1"
        for depth in (1, 2):
            conv = f"res{depth}{tower}"
            nodes.append(
                Node(Conv2d(16, 16, kernel_size=3, padding=1, name=conv), (prev,))
            )
            nodes.append(Node(ReLU(name=f"{conv}_relu"), (conv,)))
            prev = f"{conv}_relu"
        tails.append(prev)
    nodes += [
        Node(Add(name="add"), (*tails, "pool1")),
        Node(ReLU(name="add_relu"), ("add",)),
        Node(Flatten(name="flatten"), ("add_relu",)),
        Node(Linear(1024, 10, name="fc"), ("flatten",)),
    ]
    return DAGGraph(nodes)
