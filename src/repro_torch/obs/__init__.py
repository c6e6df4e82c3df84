"""Tracing and metrics (framework-free copies of the reference's)."""
