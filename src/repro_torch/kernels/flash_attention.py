"""Flash attention — the port of ``repro.kernels.flash_attention``.

:func:`flash_attention` computes ``softmax(mask(softcap(q D^-1/2 k^T))) v``
with causal, sliding-window and tanh-softcap masking, in the JAX
package's layout: q [BH, Sq, D], k / v [BH, Skv, D], output [BH, Sq, D]
in ``q.dtype``.  On CUDA tensors it launches the hand-written kernel in
``csrc/flash_attention.cu`` (counted in ``flash_attention.launches``) or
raises; on CPU tensors it runs :func:`flash_attention_ref`, the plain
PyTorch version of the same function.

Source note.  The kernel replaces the Pallas TPU kernel
``flash_attention`` of ``src/repro/kernels/flash_attention.py``.  It is
bound by operations (~2,000 flops per byte at Gemma 2's widths).  Two
routes, picked by :func:`route` from the input type and the head dim:

* ``"tensor_core"`` — bf16 at D = 64, 128, 256 (the head dims of every
  full-width config): both products on the tensor cores through
  ``wgmma``, K and V brought in by TMA through a ring of shared-memory
  stages by a producer warp, P split into two bf16 terms for P·V so the
  result passes the bf16 check (``flash_attention_tc_launch``);
* ``"cuda_core"`` — float32 inputs (their 1e-5 check rules out TF32) and
  bf16 at D = 8, 16, 32: float32 FMAs on the CUDA cores, one block per 64
  query rows (``flash_attention_launch``).

Both skip key blocks that the mask hides from every row of a query block.
The designs are set out in the source.

The semantics follow the reference exactly: q is scaled before the
product, the softcap acts on the scaled scores, masked scores are the
finite -1e30 (so a row with no valid key is the mean of v), positions
count from 0 for q and kv alike (causal with Sq != Skv is not
end-aligned), and the JAX function's block sizes ``min(128, Sq)`` and
``min(128, Skv)`` must divide Sq and Skv.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import softcap_and_mask

KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # head dims the kernel takes
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)         # bf16 head dims on wgmma
_SOURCE = "flash_attention.cu"
_DTYPES = (torch.float32, torch.bfloat16)      # the kernel's input types
_REF_BLOCK = 128                               # query rows per plain step


def _check(q, k, v, window):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k and v must be [BH, S, D] tensors")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if k.shape != (bh, skv, d) or v.shape != (bh, skv, d):
        raise ValueError(f"k and v must be [{bh}, Skv, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    bq, bkv = min(128, sq), min(128, skv)
    if bq < 1 or bkv < 1 or sq % bq or skv % bkv:
        raise ValueError(f"the query block {bq} must divide Sq = {sq} and "
                         f"the key block {bkv} must divide Skv = {skv}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: [BH, Sq, D]; k/v: [BH, Skv, D].  Returns [BH, Sq, D] in
    ``q.dtype``.  CPU tensors run :func:`flash_attention_ref`; CUDA
    tensors launch the kernel or raise."""
    _check(q, k, v, window)
    kind = q.device.type
    if kind == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if kind != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {kind}")
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap)


flash_attention.launches = 0


def route(dtype, d: int) -> str:
    """The CUDA route for inputs of ``dtype`` and head dim ``d``:
    ``"tensor_core"`` for bf16 at :data:`TENSOR_CORE_HEAD_DIMS`, else
    ``"cuda_core"``."""
    return ("tensor_core" if dtype == torch.bfloat16
            and d in TENSOR_CORE_HEAD_DIMS else "cuda_core")


def _library():
    from repro_torch.kernels.build import load_library
    lib = load_library(_SOURCE)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ci] * 7 + [cf, cf] + [vp] * 5
        fn.restype = ci
        tc = lib.flash_attention_tc_launch
        tc.argtypes = [ci] * 6 + [cf, cf] + [vp] * 5
        tc.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, *, causal, window, softcap):
    bh, sq, d = q.shape
    skv = k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA attention kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, not {d}")
    dev = q.device
    for name, a in (("k", k), ("v", v)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, q on {dev}")
    # the kernel reads one type; other mixes run in float32
    work = q.dtype if (q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype
                       ) else torch.float32
    qw, kw, vw = (a.to(work).contiguous() for a in (q, k, v))
    for name, a in (("q", qw), ("k", kw), ("v", vw)):
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((bh, sq, d), dtype=work, device=dev)
    if bh == 0:
        return out.to(q.dtype)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (d, bh, sq, skv, int(bool(causal)), int(window),
                float(softcap), float(d ** -0.5), qw.data_ptr(),
                kw.data_ptr(), vw.data_ptr(), out.data_ptr(), stream)
        if route(work, d) == "tensor_core":
            code = lib.flash_attention_tc_launch(*args)
        else:
            code = lib.flash_attention_launch(_DTYPES.index(work), *args)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} "
                           f"(cudaError {code})")
    flash_attention.launches += 1
    return out if work == q.dtype else out.to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """Plain PyTorch version of :func:`flash_attention` (same arguments,
    same result, any device): float32 scores ``(q * D^-1/2) @ k^T`` of
    ``_REF_BLOCK`` query rows at a time ([BH, 128, Skv]), then
    :func:`~repro_torch.kernels.ref.softcap_and_mask` (the oracle's
    softcap and -1e30 mask), softmax, times v."""
    _check(q, k, v, window)
    bh, sq, d = q.shape
    kf, vf = k.float(), v.float()
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, _REF_BLOCK):
        qb = q[:, q0:q0 + _REF_BLOCK].float() * d ** -0.5
        s = softcap_and_mask(torch.bmm(qb, kf.transpose(1, 2)), q0,
                             causal=causal, window=window, softcap=softcap)
        out[:, q0:q0 + _REF_BLOCK] = torch.bmm(torch.softmax(s, dim=-1),
                                               vf).to(q.dtype)
    return out
