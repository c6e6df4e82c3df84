"""The port's core: IR, fusion, planner, executors, quantization."""
