"""PyTorch + CUDA port of ``repro`` (the BandPilot dispatcher and its LM
substrate) for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it (or JAX). Layout mirrors the reference:

  core/      the dispatcher: numpy layers copied, the surrogate and its
             trainer in PyTorch, the PTS descent as a CUDA graph
  configs/   model configurations (plain data, copied)
  kernels/   hand-written CUDA kernels (``csrc/``), their wrappers (``ops``)
             and plain PyTorch twins (``ref``)
  models/    nn.Modules for the decoder-only LMs
  serve/     batched prefill + decode engine
  launch/    command-line entry points (serve, train_lm, dispatch)

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""
