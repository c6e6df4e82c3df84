"""PyTorch + CUDA port of the paper's deployment pipeline.

A second package beside ``repro`` (the JAX reference, which it never
imports).  It mirrors the reference's layout: ``core`` (IR, fusion, the
ping-pong and DAG planners, executors, quantization), ``kernels/conv_pool``
and ``quant`` (the fused conv+pool kernels, dense K1/K2 and depthwise K3/K4,
hand-written CUDA for Hopper under ``csrc``), ``obs`` and ``serve``.  Entry
points default to ``device="cuda"`` and raise without a card; the CPU runs
the kernels' plain versions only when the caller puts the tensors there.
"""
