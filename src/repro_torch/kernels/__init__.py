"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built by
:mod:`repro_torch.kernels.build`), each beside its plain PyTorch version
and a launch counter."""
