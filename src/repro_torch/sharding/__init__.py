"""Placement of work over several devices."""
