"""Synthetic token pipeline (the port of ``repro/data/tokens.py``)."""
