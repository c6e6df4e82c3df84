"""The LM substrate: norms, RoPE, MLP, GQA attention, RWKV6 and the
``transformer.Model`` that assembles them for serving."""
