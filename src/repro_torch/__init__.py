"""PyTorch + CUDA port of the LM substrate of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it (or JAX). Layout mirrors the reference:

  configs/   model configurations (plain data, copied)
  kernels/   hand-written CUDA kernels (``csrc/``), their wrappers (``ops``)
             and plain PyTorch twins (``ref``)
  models/    nn.Modules for the decoder-only LMs
  serve/     batched prefill + decode engine
  launch/    command-line serving entry point

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""
