"""Deterministic synthetic data (``repro/data``)."""
