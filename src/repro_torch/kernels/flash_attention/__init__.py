"""Flash attention: CUDA kernel, wrapper and plain twin."""
