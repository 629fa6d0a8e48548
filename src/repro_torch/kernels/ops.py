"""The kernel entry point — the port of ``repro.kernels.ops``.

Same names, argument order, layouts (``[BH, S, D]``) and defaults as the
JAX package's wrappers, less ``interpret``.  Tensors stay on the device
they lie on: CUDA tensors reach the hand-written kernels
(``csrc/block_csr_spmv.cu``, ``csrc/flash_attention.cu``,
``csrc/gla_chunk.cu``), CPU tensors their plain PyTorch versions, so a
caller asks for the CPU by passing CPU tensors.  Arrays that are not
tensors (numpy, as the JAX wrappers accept) go to the GPU
(:func:`repro_torch.utils.resolve_device`); ``spmv``'s structure is
packed once and its packed form goes wherever its vector lies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import csr_spmv
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


PACKED_KEY = "packed"             # where spmv keeps a structure's packed form


def spmv(graph_blocks: dict, x, *, tile: int) -> torch.Tensor:
    """Block-CSR SpMV over a prebuilt ``build_block_csr`` structure (its
    arrays numpy or tensors), on x's device.  The first call packs the
    structure (:func:`csr_spmv.pack_block_csr`: numpy arrays on the CPU,
    tensors where they lie) and keeps the packed form in
    ``graph_blocks[PACKED_KEY]``, moved to x's device; later calls read
    only the packed form, so the structure must not change after the
    first call.  CUDA vectors launch the packed kernel, CPU vectors run
    its plain version."""
    x = _tensor(x).to(torch.float32)
    packed = graph_blocks.get(PACKED_KEY)
    if packed is None:
        t = lambda k: _tensor(graph_blocks[k], "cpu")
        packed = csr_spmv.pack_block_csr(t("tiles"), t("tile_col"),
                                         t("row_ptr"), tile=tile)
    elif packed["tile"] != tile:
        raise ValueError(f"the structure was packed for tile "
                         f"{packed['tile']}, not {tile}")
    if packed["pval"].device != x.device:
        packed = {k: v.to(x.device) if k in csr_spmv.PACKED_ARRAYS else v
                  for k, v in packed.items()}
    graph_blocks[PACKED_KEY] = packed
    return csr_spmv.block_csr_spmv_packed(packed, x)


def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    q, k, v = (_tensor(a) for a in (q, k, v))
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


def gla(q, k, v, w, u=None, *, chunk=64, include_current=True):
    q, k, v, w = (_tensor(a) for a in (q, k, v, w))
    return gla_chunked(q, k, v, w, None if u is None else _tensor(u),
                       chunk=chunk, include_current=include_current)
