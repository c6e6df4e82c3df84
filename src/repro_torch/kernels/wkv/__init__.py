"""K7: the chunked RWKV6 wkv forward from the zero state — the paper's
fused-reduction idea applied to the SSM hot spot: the per-chunk pair term
and the running state stay on chip; only the outputs and the final state
reach device memory.  ``ref`` is the plain version, ``kernel`` the CUDA
launch, ``ops`` the device dispatch and the chunk rule."""
