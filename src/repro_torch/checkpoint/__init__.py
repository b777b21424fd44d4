"""Atomic checkpoints of parameters and optimizer state (``repro/checkpoint``)."""
