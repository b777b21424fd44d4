"""Decoder-only LMs as nn.Modules (dense and hybrid RG-LRU families)."""
