"""Serving: the bucketed executor cache and the CNN engine."""
