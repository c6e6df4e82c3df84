"""Fault tolerance: preemption drain, straggler detection, step timing."""
