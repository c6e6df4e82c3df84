"""K1: the fused dense conv + activation + pool kernel."""
