"""Fusion pass: paper §3.1 (fused in-place max-pooling) + §7 extension.

Framework-free copy of ``repro/core/fusion.py``.

Detects ``Conv2d → ReLU → {Max,Avg}Pool2d`` windows and rewrites them into a
single :class:`~repro_torch.core.graph.FusedConvPool` layer.  The paper's condition
for the zero-extra-memory fusion is ``pool.stride >= pool.kernel_size`` **per
axis**: every pooling window is then mutually exclusive, so the running
reduction can be written straight to the (reduced) output line buffer and the
conv output is never materialized.

The paper's §7 future work — H-axis ``stride < kernel_size`` — is also
implemented for max pooling: pooling windows then overlap by ``kh - sh``
rows, which the fused loop handles by keeping a line buffer of that many
*pooled* rows.  The planner accounts that scratch; it is strictly smaller
than the conv output.  See :func:`_pool_window` for the exact per-axis
eligibility (W-only overlap and overlapping average windows are declined).

``Linear → ReLU`` windows fuse to :class:`FusedLinear` (the paper folds
activations into the producing layer: "ReLU layer can be part of the
convolution layer").
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.graph import (
    AvgPool2d,
    Conv2d,
    DAGGraph,
    DepthwiseConv2d,
    FusedConvPool,
    FusedLinear,
    Linear,
    MaxPool2d,
    Node,
    ReLU,
    SequentialGraph,
    as_sequential,
)

# Layers eligible as the conv of a fused conv+act+pool window: the fused
# running-max loop is identical for dense and depthwise convolutions.
_CONV_KINDS = (Conv2d, DepthwiseConv2d)

_ACTIVATIONS = {"ReLU": "relu"}

# Pool layers eligible as the tail of a fused window, and the FusedConvPool
# reduction mode each maps to.
_POOL_MODES = {"MaxPool2d": "max", "AvgPool2d": "avg"}


def _pool_window(pool_layer, allow_line_buffer: bool):
    """``(pool_mode, line_buffer_rows)`` if the pool window can fuse, else None.

    Eligibility is **per-axis** (the scalar ``stride >= kernel_size`` check
    conflated H and W):

    * ``stride >= kernel`` on both axes — the paper's zero-scratch in-flight
      reduction, any pool mode;
    * H-overlap (``sh < kh``, max-pool only, ``allow_line_buffer``) — the §7
      line buffer of ``kh - sh`` pooled rows;
    * W-only overlap (``sh >= kh`` while ``sw < kw``) — **declined**: pooled
      columns would need partial running maxes re-read from output the
      single-pass loop already wrote, and no line-buffer formulation exists;
    * average pools fuse only in the stride ≥ kernel form (the fused sum is
      requantized once per window — overlap would require re-reading
      accumulator values) and, like max, only unpadded.
    """
    mode = _POOL_MODES.get(pool_layer.kind)
    if mode is None or pool_layer.padding != (0, 0):
        return None
    (kh, kw), (sh, sw) = pool_layer.kernel_size, pool_layer.stride
    if sh >= kh and sw >= kw:
        return (mode, 0)
    if mode != "max" or sh >= kh or not allow_line_buffer:
        return None
    return (mode, kh - sh)


def fuse(graph: SequentialGraph, allow_line_buffer: bool = True) -> SequentialGraph:
    """Return a new graph with conv/act/pool and linear/act windows fused.

    Args:
      graph: the unfused sequential graph (chain-shaped DAGs are normalized;
        branching DAGs must go through :func:`fuse_dag`).
      allow_line_buffer: if True, also fuse pooling with ``stride <
        kernel_size`` using the §7 line-buffer scheme.  If False, only the
        paper's main ``stride >= kernel_size`` condition fuses (pure Alg. 1).
    """
    graph = as_sequential(graph, caller="fusion.fuse")
    layers = list(graph.layers)
    out: List = []
    i = 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        nxt2 = layers[i + 2] if i + 2 < len(layers) else None

        if (
            isinstance(layer, _CONV_KINDS)
            and nxt is not None
            and nxt.kind in _ACTIVATIONS
            and isinstance(nxt2, (MaxPool2d, AvgPool2d))
        ):
            window = _pool_window(nxt2, allow_line_buffer)
            if window is None:
                out.append(layer)
                i += 1
                continue
            mode, line_rows = window
            out.append(
                FusedConvPool(
                    conv=layer,
                    activation=_ACTIVATIONS[nxt.kind],
                    pool_kernel=nxt2.kernel_size,
                    pool_stride=nxt2.stride,
                    line_buffer_rows=line_rows,
                    name=f"{layer.name or 'conv'}+{nxt2.name or 'pool'}",
                    pool=mode,
                )
            )
            i += 3
            continue

        if isinstance(layer, Linear) and nxt is not None and nxt.kind in _ACTIVATIONS:
            out.append(
                FusedLinear(
                    linear=layer,
                    activation=_ACTIVATIONS[nxt.kind],
                    name=f"{layer.name or 'fc'}+{nxt.name or 'act'}",
                )
            )
            i += 2
            continue

        out.append(layer)
        i += 1

    fused = SequentialGraph(out)
    fused.validate()
    return fused


def _iter_dag_windows(graph: DAGGraph, allow_line_buffer: bool):
    """Yield every fuse-able window in ``graph``.

    A window is ``(head_node, fused_node, consumed_names, tail_name)``:
    ``head_node`` is the Conv2d/Linear the window starts at, ``fused_node``
    the replacement, ``consumed_names`` the swallowed member nodes and
    ``tail_name`` the window's last original node (whose consumers must be
    re-pointed at the fused node).  Shared by :func:`fuse_dag` (applies the
    windows) and :func:`fusion_candidates` (enumerates them for the
    schedule-priced fusion in `repro.core.schedule`).
    """
    cons = graph.consumers()
    nodes_by_name = {n.name: n for n in graph.nodes}

    def _sole_consumer(name: str, kinds):
        """The single consumer of ``name`` if its kind is in ``kinds``, else None."""
        c = cons[name]
        if len(c) != 1 or name == graph.output:
            return None
        node = nodes_by_name[c[0]]
        return node if node.layer.kind in kinds else None

    for node in graph.nodes:
        layer = node.layer
        if isinstance(layer, _CONV_KINDS):
            relu = _sole_consumer(node.name, ("ReLU",))
            pool = relu and _sole_consumer(relu.name, tuple(_POOL_MODES))
            if pool is None:
                continue
            window = _pool_window(pool.layer, allow_line_buffer)
            if window is None:
                continue
            mode, line_rows = window
            fused_name = f"{layer.name or 'conv'}+{pool.layer.name or 'pool'}"
            fused_node = Node(
                FusedConvPool(
                    conv=layer,
                    activation=_ACTIVATIONS[relu.layer.kind],
                    pool_kernel=pool.layer.kernel_size,
                    pool_stride=pool.layer.stride,
                    line_buffer_rows=line_rows,
                    name=fused_name,
                    pool=mode,
                ),
                node.inputs,
            )
            yield node, fused_node, (relu.name, pool.name), pool.name
        elif isinstance(layer, Linear):
            relu = _sole_consumer(node.name, ("ReLU",))
            if relu is None:
                continue
            fused_name = f"{layer.name or 'fc'}+{relu.layer.name or 'act'}"
            fused_node = Node(
                FusedLinear(
                    linear=layer,
                    activation=_ACTIVATIONS[relu.layer.kind],
                    name=fused_name,
                ),
                node.inputs,
            )
            yield node, fused_node, (relu.name,), relu.name


def fusion_candidates(
    graph: DAGGraph, allow_line_buffer: bool = True
) -> tuple:
    """``(head_name, line_buffer_rows)`` for every window :func:`fuse_dag`
    would fuse.

    The schedule-priced fusion (`repro.core.schedule.fuse_dag_priced`)
    enumerates these, prices the windows through the planner — only the
    ``line_buffer_rows > 0`` ones can fail to pay — and re-invokes
    :func:`fuse_dag` with a ``window_filter`` keeping the ones that do.
    """
    return tuple(
        (head.name, getattr(fused.layer, "line_buffer_rows", 0))
        for head, fused, *_ in _iter_dag_windows(graph, allow_line_buffer)
    )


def fuse_dag(
    graph: DAGGraph,
    allow_line_buffer: bool = True,
    window_filter=None,
) -> DAGGraph:
    """DAG counterpart of :func:`fuse`: fuse conv/act/pool and linear/act
    *chains* whose intermediate values have exactly one consumer.

    A window ``Conv2d → ReLU → MaxPool2d`` (or ``Linear → ReLU``) fuses only
    when each intermediate node is consumed solely by the next window member —
    a branch reading the pre-pool (or pre-activation) value keeps the window
    unfused, because fusion would destroy the value the branch needs.

    ``window_filter(head_name) -> bool``, when given, additionally restricts
    which candidate windows are applied — the hook the schedule-priced
    fusion uses to decline windows the memory plan says do not pay.
    """
    consumed: set = set()   # nodes swallowed into a fused window
    rename: Dict[str, str] = {}  # window-tail name -> fused node name
    fused_for: Dict[str, Node] = {}  # window-head name -> fused node

    for head, fused_node, members, tail in _iter_dag_windows(
        graph, allow_line_buffer
    ):
        if window_filter is not None and not window_filter(head.name):
            continue
        fused_for[head.name] = fused_node
        consumed.update(members)
        rename[tail] = fused_node.layer.name

    out: List[Node] = []
    for node in graph.nodes:
        if node.name in consumed:
            continue
        if node.name in fused_for:
            fused_node = fused_for[node.name]
            out.append(
                Node(fused_node.layer,
                     tuple(rename.get(s, s) for s in fused_node.inputs))
            )
            continue
        out.append(Node(node.layer, tuple(rename.get(s, s) for s in node.inputs)))
    fused = DAGGraph(out, output=rename.get(graph.output, graph.output))
    fused.validate()
    return fused


def rename_params(fused_graph, params: dict) -> dict:
    """Re-key ``params`` so fused layers find their conv/linear weights.

    A fused layer is named ``"{conv}+{pool}"`` / ``"{fc}+{act}"`` but carries
    the original layer's parameters; this maps each fused name to the inner
    layer's param dict (leaving existing keys untouched).  Works for both
    sequential graphs and DAGs (both expose ``.layers``).
    """
    out = dict(params)
    for layer in fused_graph.layers:
        name = layer.name or layer.kind
        if name in out:
            continue
        inner = getattr(layer, "conv", None) or getattr(layer, "linear", None)
        if inner is not None and inner.name in params:
            out[name] = params[inner.name]
    return out
