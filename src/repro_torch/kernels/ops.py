"""The kernel entry point — the port of ``repro.kernels.ops``.

Same names, argument order, layouts (``[BH, S, D]``) and defaults as the
JAX package's wrappers, less ``interpret``.  Tensors stay on the device
they lie on: CUDA tensors reach the hand-written kernels
(``csrc/block_csr_spmv.cu``, ``csrc/flash_attention.cu``,
``csrc/gla_chunk.cu``), CPU tensors their plain PyTorch versions, so a
caller asks for the CPU by passing CPU tensors.  Arrays that are not
tensors (numpy, as the JAX wrappers accept) go to the GPU
(:func:`repro_torch.utils.resolve_device`); ``spmv``'s structure goes
wherever its vector lies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.csr_spmv import (  # noqa: F401
    block_csr_combine, block_csr_spmv, build_block_csr, build_tile_struct,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.gla_chunk import gla_chunked  # noqa: F401
from repro_torch.utils import resolve_device


def _tensor(a, device=None):
    """``a`` as a tensor: a tensor stays where it is, anything else goes
    to ``device``, the GPU unless one is named."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        resolve_device(device))


def spmv(graph_blocks: dict, x, *, tile: int) -> torch.Tensor:
    """Block-CSR SpMV over a prebuilt ``build_block_csr`` structure (its
    arrays numpy or tensors); they go to x's device."""
    x = _tensor(x).to(torch.float32)
    to = lambda a, dtype: _tensor(a, x.device).to(x.device, dtype)
    return block_csr_spmv(
        to(graph_blocks["tiles"], torch.float32),
        to(graph_blocks["tile_col"], torch.int32),
        to(graph_blocks["row_ptr"], torch.int32), x, tile=tile)


def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    q, k, v = (_tensor(a) for a in (q, k, v))
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


def gla(q, k, v, w, u=None, *, chunk=64, include_current=True):
    q, k, v, w = (_tensor(a) for a in (q, k, v, w))
    return gla_chunked(q, k, v, w, None if u is None else _tensor(u),
                       chunk=chunk, include_current=include_current)
