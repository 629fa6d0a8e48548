"""DFOGraph in PyTorch for one NVIDIA Hopper GPU.

The port of the JAX package ``repro`` (the reference, kept beside it).
Module names mirror the reference so each counterpart is easy to find;
the port imports torch and numpy only, never jax and never ``repro``.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.utils.resolve_device`); the hand-written CUDA kernels
live under ``repro_torch/kernels/csrc`` and are built with ``nvcc`` at
first use.
"""
