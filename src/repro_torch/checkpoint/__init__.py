"""Checkpoints: npz + JSON manifest, atomic publish, async writes."""
