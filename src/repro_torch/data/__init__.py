"""Synthetic data: the token pipeline (``tokens.py``) and the procedural
digit set (``mnist_synth.py``), the ports of ``repro/data/``."""
