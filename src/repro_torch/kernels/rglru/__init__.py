"""RG-LRU diagonal scan: CUDA kernel, wrapper and plain twin."""
