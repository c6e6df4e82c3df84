"""K5: online-softmax (flash) attention forward — the paper's fused in-place
reduction generalized to the softmax: the (S×T) score matrix is reduced
block by block with running (max, sum, acc) statistics and never reaches
device memory.  ``ref`` is the plain version, ``kernel`` the CUDA launch,
``ops`` the device dispatch."""
