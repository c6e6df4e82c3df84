"""K6: the LM-head matmul fused with cross-entropy — the paper's "fuse the
consumer's reduction into the producer" applied to the LM loss: a running
(max, sumexp, target logit) per token over vocab tiles, so the (N, V)
logits never reach device memory.  ``ref`` holds the plain versions,
``kernel`` the CUDA launch, ``ops`` the device dispatch and the gradient."""
