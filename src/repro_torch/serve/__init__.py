"""Batched serving."""
