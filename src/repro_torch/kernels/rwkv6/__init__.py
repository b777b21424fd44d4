"""RWKV-6 WKV recurrence: CUDA kernel, wrapper and plain twin."""
