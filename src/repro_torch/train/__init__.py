"""Training: AdamW and the training loop (``repro/train``)."""
