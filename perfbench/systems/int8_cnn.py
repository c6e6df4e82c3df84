"""The system kind ``int8_cnn``: a sequential conv / depthwise / FC network
of ``configs/<config>.json`` run by the port's int8 DAG path, and its plain
reference.

What both sides get, made from the seed on the first device: He-normal
f32 weights, an f32 calibration batch, and int8 input rows (standard
normal, quantized at the calibration batch's input scale).

The port, built through its public API:

* the graph: ``repro_torch.core.graph``'s layer classes, one node a layer
  of the configuration (a ReLU a node, a fused pool as the ``AvgPool2d``
  node the port's fusion folds into its conv);
* the model ``quantize_dag(schedule.fuse_dag_priced(graph), f32 params,
  calibration batch)``, the plan ``schedule.plan_dag(fused,
  io_dtype_bytes=1)``, the executor ``make_int8_executor(model, plan)``;
* on more than one device: ``DataParallelPolicy(make_data_mesh(n))``,
  ``wrap_batched`` around the executor and ``replicate`` of its params.

The reference is :mod:`perfbench.reference`, which derives the int8 model
again from the same f32 weights and calibration batch; the control is the
same model derived and run at int4 in the program's place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from perfbench import counts, reference
from perfbench.counts import pair

# What the metric readers read of this kind (see ``harness.Record``).
macs_per_image = counts.macs_per_image
kernel_bound_s = counts.kernel_bound_s


def runs_kernel(net: dict, kernel: str) -> bool:
    return bool(counts.kernel_layers(net).get(kernel))


@dataclasses.dataclass
class Data:
    weights: Dict[str, dict]  # layer -> {"w", "b"}: f32 CPU tensors
    calib: torch.Tensor  # f32 CPU calibration batch
    input_scale: float


def prepare(net: dict, gen: torch.Generator, device: torch.device) -> Data:
    """The weights and the calibration batch, drawn on ``device``."""
    if (net["weights"]["init"], net["inputs"]["dist"]) != ("he_normal", "normal"):
        raise ValueError(f"{net['name']}: int8_cnn draws He-normal weights and normal inputs")
    weights = {k: {n: t.cpu() for n, t in v.items()}
               for k, v in reference.he_normal_weights(net, gen, device).items()}
    calib = torch.randn((int(net["inputs"]["calibration_images"]), *net["input_shape"]),
                        generator=gen, device=device).cpu()
    return Data(weights=weights, calib=calib, input_scale=reference.input_scale(calib))


def out_shape(net: dict) -> tuple:
    return (int(net["num_classes"]),)


def inputs(net: dict, data: Data, rows: int, gen: torch.Generator,
           device: torch.device) -> torch.Tensor:
    """``rows`` int8 input rows drawn on ``device`` in blocks, held in
    pinned host memory when ``device`` is a card."""
    shape = tuple(net["input_shape"])
    pool = torch.empty((rows, *shape), dtype=torch.int8, pin_memory=device.type == "cuda")
    block = 4096
    for r in range(0, rows, block):
        n = min(block, rows - r)
        x = torch.randn((n, *shape), generator=gen, device=device)
        pool[r:r + n].copy_(reference.quantize_input(x, data.input_scale))
    return pool


def port_graph(net: dict):
    """The configuration as the port's unfused ``DAGGraph``."""
    from repro_torch.core.graph import (AvgPool2d, Conv2d, DAGGraph, DepthwiseConv2d,
                                        Flatten, Input, Linear, Node, ReLU)

    nodes = [Node(Input(shape=tuple(net["input_shape"]), name="input"))]
    prev, channels = "input", int(net["input_shape"][0])

    def add(layer, name):
        nonlocal prev
        nodes.append(Node(layer, (prev,)))
        prev = name

    for layer in net["layers"]:
        name, op = layer["name"], layer["op"]
        if op == "fc":
            add(Flatten(name="flatten"), "flatten")
            add(Linear(int(layer["in"]), int(layer["out"]), name=name), name)
            continue
        geom = dict(kernel_size=pair(layer["kernel"]), stride=pair(layer["stride"]),
                    padding=pair(layer["padding"]), name=name)
        if op == "dw":
            add(DepthwiseConv2d(channels, **geom), name)
        else:
            add(Conv2d(channels, int(layer["cout"]), **geom), name)
            channels = int(layer["cout"])
        if layer.get("relu"):
            add(ReLU(name=f"{name}_relu"), f"{name}_relu")
        if "pool" in layer:
            pool = layer["pool"]
            add(AvgPool2d(kernel_size=pair(pool["kernel"]), stride=pair(pool["stride"]),
                          name="pool"), "pool")
    return DAGGraph(nodes)


def port_params(fused, weights: Dict[str, dict]) -> Dict[str, dict]:
    """The benchmark's weights keyed as the fused graph's nodes are (a
    fused conv + pool node by its conv's layer)."""
    from repro_torch.core.graph import FusedConvPool

    out = {}
    for node in fused.nodes:
        layer = node.layer
        name = layer.conv.name if isinstance(layer, FusedConvPool) else node.name
        if name in weights:
            out[node.name] = dict(weights[name])
    return out


class BusySpans:
    """An executor that records a CUDA event pair around each call on the
    current stream of the current card (``wrap_batched`` makes a shard's
    card and stream current).  Its replicas, one a card, log to one list."""

    def __init__(self, fn, log: list, replicas: list):
        self.fn, self.log, self.replicas = fn, log, replicas
        replicas.append(self)

    def replica(self) -> "BusySpans":
        return BusySpans(self.fn.replica(), self.log, self.replicas)

    def __call__(self, params, x):
        if x.device.type != "cuda":
            return self.fn(params, x)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        y = self.fn(params, x)
        ev[1].record()
        self.log.append((x.device.index, ev[0], ev[1]))
        return y


@dataclasses.dataclass
class System:
    run: Callable  # (params, x) -> y on devices[0]
    params: object
    plan_arena_elems: int
    timed: list  # the executor, or on a mesh each card's replica in its BusySpans

    def executors(self) -> list:
        return [getattr(t, "fn", t) for t in self.timed]

    def readings(self) -> dict:
        """The arena one inference needs, from every arena the executors
        allocated: its second dimension times its element size, and how far
        its second dimension lies from the plan's ``arena_elems``."""
        arenas = [a for ex in self.executors() for a in ex.arenas.values()]
        if not arenas:
            return {"arena_bytes": 0, "arena_bytes_off_plan": -1}
        return {"arena_bytes": max(int(a.shape[1]) * a.element_size() for a in arenas),
                "arena_bytes_off_plan": max(abs(int(a.shape[1]) - self.plan_arena_elems)
                                            for a in arenas)}

    def checks(self, readings: dict) -> Dict[str, dict]:
        return {"arena_bytes_off_plan": {"value": readings["arena_bytes_off_plan"],
                                         "limit": 0, "rule": "=="}}

    def close(self) -> None:
        for ex in self.executors():
            ex.arenas.clear()
        self.timed.clear()
        self.params = None
        self.run = None


def build(net: dict, data: Data, devices: List[torch.device], spans: list) -> System:
    """The port's int8 path for ``net`` on ``devices`` (one, or a data mesh
    over them); on a mesh ``spans`` receives (card, start, end) CUDA events
    of each shard's executor call."""
    from repro_torch.core import quantize, schedule
    from repro_torch.quant.exec import make_int8_executor

    fused = schedule.fuse_dag_priced(port_graph(net))
    plan = schedule.plan_dag(fused, io_dtype_bytes=1)
    qm = quantize.quantize_dag(fused, port_params(fused, data.weights), data.calib)
    ex, params = make_int8_executor(qm, plan, device=devices[0])
    if len(devices) == 1:
        return System(run=ex, params=params, plan_arena_elems=int(plan.arena_elems),
                      timed=[ex])
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.sharding.policy import DataParallelPolicy

    replicas: List[BusySpans] = []
    pol = DataParallelPolicy(make_data_mesh(len(devices), device=devices[0].type))
    run = pol.wrap_batched(BusySpans(ex, spans, replicas))
    return System(run=run, params=pol.replicate(params),
                  plan_arena_elems=int(plan.arena_elems), timed=replicas)


def reference_fn(net: dict, data: Data, device: torch.device) -> Callable:
    """Rows of int8 inputs -> the plain reference's int8 outputs."""
    q8 = reference.derive(net, data.weights, data.calib).to(device)
    return lambda x: reference.forward(q8, x.to(device))


def control(net: dict, data: Data, device: torch.device) -> Callable:
    """The control in the program's place: ``(params, x) -> y``, the model
    derived and run at int4, outputs on the int8 output scale."""
    q8 = reference.derive(net, data.weights, data.calib).to(device)
    q4 = reference.derive(net, data.weights, data.calib, bits=4).to(device)
    return lambda params, x: reference.control_forward(q4, q8, x.to(device))
