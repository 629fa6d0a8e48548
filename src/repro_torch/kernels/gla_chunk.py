"""Chunked gated linear attention — the port of ``repro.kernels.gla_chunk``
(the RWKV6 / Mamba2 hot loop).

:func:`gla_chunked` runs the recurrence

    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
    y_t = q_t S_t                          (include_current=True, Mamba2)
    y_t = q_t S_{t-1} + (q_t.(u*k_t)) v_t  (include_current=False, RWKV6)

a chunk at a time, in the JAX package's layout: q / k / w [BH, T, Dk],
v [BH, T, Dv], u [BH, Dk] or None; it returns y [BH, T, Dv] in
``q.dtype`` and the final state [BH, Dk, Dv] in float32.  On CUDA tensors
it launches the hand-written kernel in ``csrc/gla_chunk.cu`` (counted in
``gla_chunked.launches``) or raises; on CPU tensors it runs
:func:`gla_chunked_ref`, the plain PyTorch version of the same function.

Source note.  The kernels replace the Pallas TPU kernel ``gla_chunked``
of ``src/repro/kernels/gla_chunk.py``; :func:`route` picks one of two:

* ``"tensor_core"`` — bf16 q, k and v with a chunk that is a multiple of
  16: three kernels per call (the chunks' state increments, the
  recurrence over chunks, the outputs), every product on the tensor
  cores with its float32 operands split into bf16 hi + lo, the
  per-channel decay exponentials only inside the 16 x 16 diagonal blocks
  (``csrc/gla_chunk.cu``, ``tc``).  Bound by bytes.
* ``"cuda_core"`` — float32 inputs (or a chunk off the multiple of 16):
  one block per (batch, head) walks the chunks with the state in shared
  memory, as the TPU's sequential chunk axis did, all in float32 on the
  CUDA cores.  Bound by the intra-chunk term's L^2/2 * Dk exponentials.

Both form every decay difference before its exponential, and take the
exclusive log decay as the inclusive cumulative sum shifted one step
(``lq_t = lc_{t-1}``) where the reference takes ``lc - w``: the same value
with one rounding fewer.  ``gla_chunked.launches`` counts calls (one call
is one kernel on the CUDA-core route, three on the tensor-core route).
The wrapper pads Dk and Dv to multiples of 4 (CUDA cores) or to 64 (tensor
cores); zero columns change nothing and are cut off again.
"""
from __future__ import annotations

import ctypes

import torch

KERNEL_MAX_CHUNK = 128           # limits of the CUDA kernel
KERNEL_MAX_DIM = 64
TC_SUB = 16                      # sub-chunk of the tensor-core route
_SOURCE = "gla_chunk.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, w, u, chunk):
    if q.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, w must be [BH, T, Dk] and v [BH, T, Dv]")
    bh, t, dk = q.shape
    if k.shape != q.shape or w.shape != q.shape:
        raise ValueError(f"k and w must have q's shape {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(w.shape)}")
    if v.shape[:2] != (bh, t):
        raise ValueError(f"v must be [{bh}, {t}, Dv], got {tuple(v.shape)}")
    if u is not None and tuple(u.shape) != (bh, dk):
        raise ValueError(f"u must be [{bh}, {dk}], got {tuple(u.shape)}")
    if chunk < 1 or t % chunk:
        raise ValueError(f"the chunk {chunk} must divide T = {t}")


def gla_chunked(q, k, v, w, u=None, *, chunk: int = 64,
                include_current: bool = True):
    """q/k/w: [BH, T, Dk]; v: [BH, T, Dv]; u: [BH, Dk] bonus or None.
    Returns (y [BH, T, Dv] in q.dtype, final_state [BH, Dk, Dv] f32).
    CPU tensors run :func:`gla_chunked_ref`; CUDA tensors launch the
    kernel or raise."""
    _check(q, k, v, w, u, chunk)
    kind = q.device.type
    if kind == "cpu":
        return gla_chunked_ref(q, k, v, w, u, chunk=chunk,
                               include_current=include_current)
    if kind != "cuda":
        raise ValueError(f"gla_chunked runs on cpu or cuda, not {kind}")
    return _launch(q, k, v, w, u, chunk=chunk,
                   include_current=include_current)


gla_chunked.launches = 0


def route(dtype, chunk: int) -> str:
    """The kernel route a call takes: ``"tensor_core"`` for bf16 inputs
    with a chunk that is a multiple of 16, else ``"cuda_core"``."""
    return ("tensor_core" if dtype == torch.bfloat16 and chunk % TC_SUB == 0
            else "cuda_core")


def _library():
    from repro_torch.kernels.build import load_library
    lib = load_library(_SOURCE)
    fn = lib.gla_chunked_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci] * 7 + [vp] * 8
        fn.restype = ci
        lib.gla_chunked_tc_launch.argtypes = [ci] * 4 + [vp] * 11
        lib.gla_chunked_tc_launch.restype = ci
        lib.gla_chunked_tc_dim.restype = ci
        lib.gla_chunked_error_string.argtypes = [ci]
        lib.gla_chunked_error_string.restype = ctypes.c_char_p
        if lib.gla_chunked_tc_dim() != KERNEL_MAX_DIM:
            raise RuntimeError("gla_chunk.cu's tensor-core width does not "
                               "match kernels/gla_chunk.py")
    return lib


def _check_code(lib, code):
    if code != 0:
        msg = lib.gla_chunked_error_string(code).decode()
        raise RuntimeError(f"gla_chunked launch failed: {msg} "
                           f"(cudaError {code})")


def _pad_last(x, width):
    return x if x.shape[-1] == width else torch.nn.functional.pad(
        x, (0, width - x.shape[-1]))


def _launch(q, k, v, w, u, *, chunk, include_current):
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if chunk > KERNEL_MAX_CHUNK or dk > KERNEL_MAX_DIM or dv > KERNEL_MAX_DIM:
        raise ValueError(
            f"the CUDA GLA kernel takes chunks up to {KERNEL_MAX_CHUNK} and "
            f"Dk, Dv up to {KERNEL_MAX_DIM}; got chunk {chunk}, Dk {dk}, "
            f"Dv {dv}")
    dev = q.device
    for name, a in (("k", k), ("v", v), ("w", w), ("u", u)):
        if a is not None and a.device != dev:
            raise ValueError(f"{name} is on {a.device}, q on {dev}")
    work = q.dtype if (q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype
                       ) else torch.float32
    if route(work, chunk) == "tensor_core":
        y, state = _launch_tc(q, k, v, w, u, chunk=chunk,
                              include_current=include_current)
    else:
        y, state = _launch_cuda_core(q, k, v, w, u, work, chunk=chunk,
                                     include_current=include_current)
    gla_chunked.launches += 1
    if y.shape[-1] != dv:
        y = y[..., :dv].contiguous()
    if state.shape[1:] != (dk, dv):
        state = state[:, :dk, :dv].contiguous()
    return y.to(q.dtype), state


def _launch_cuda_core(q, k, v, w, u, work, *, chunk, include_current):
    bh, t, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    dkp, dvp = -(-dk // 4) * 4, -(-dv // 4) * 4
    qw, kw = (_pad_last(a.to(work), dkp).contiguous() for a in (q, k))
    vw = _pad_last(v.to(work), dvp).contiguous()
    ww = _pad_last(w.float(), dkp).contiguous()
    uw = None if u is None else _pad_last(u.float(), dkp).contiguous()
    y = torch.empty((bh, t, dvp), dtype=work, device=dev)
    state = torch.zeros((bh, dkp, dvp), dtype=torch.float32, device=dev)
    if bh and t:
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gla_chunked_launch(
                _DTYPES.index(work), bh, t, chunk, dkp, dvp,
                int(bool(include_current)), qw.data_ptr(), kw.data_ptr(),
                vw.data_ptr(), ww.data_ptr(),
                None if uw is None else uw.data_ptr(), y.data_ptr(),
                state.data_ptr(), stream)
        _check_code(lib, code)
    return y, state


def _aligned(x):
    """x contiguous and 16-byte aligned (the kernels copy rows in 16-byte
    pieces)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_tc(q, k, v, w, u, *, chunk, include_current):
    bh, t, _ = q.shape
    dev = q.device
    dp = KERNEL_MAX_DIM
    qw, kw, vw = (_aligned(_pad_last(a, dp)) for a in (q, k, v))
    ww = _aligned(_pad_last(w.float(), dp))
    uw = None if u is None else _pad_last(u.float(), dp).contiguous()
    y = torch.empty((bh, t, dp), dtype=torch.bfloat16, device=dev)
    state = torch.zeros((bh, dp, dp), dtype=torch.float32, device=dev)
    if bh and t:
        n_chunks = t // chunk
        ds = torch.empty((bh, n_chunks, dp, dp), dtype=torch.float32,
                         device=dev)
        llast = torch.empty((bh, n_chunks, dp), dtype=torch.float32,
                            device=dev)
        sprev = torch.empty((bh, n_chunks, 2, dp, dp), dtype=torch.bfloat16,
                            device=dev)
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gla_chunked_tc_launch(
                bh, t, chunk, int(bool(include_current)), qw.data_ptr(),
                kw.data_ptr(), vw.data_ptr(), ww.data_ptr(),
                None if uw is None else uw.data_ptr(), y.data_ptr(),
                state.data_ptr(), ds.data_ptr(), llast.data_ptr(),
                sprev.data_ptr(), stream)
        _check_code(lib, code)
    return y, state


def gla_chunked_ref(q, k, v, w, u=None, *, chunk: int = 64,
                    include_current: bool = True):
    """Plain PyTorch version of :func:`gla_chunked` (same arguments, same
    result, any device), a chunk at a time in float32 as the reference
    kernel computes one: the [BH, L, L, Dk] decay differences, masked to
    -inf above the diagonal (on it too unless ``include_current``), their
    exponentials, and the three products."""
    _check(q, k, v, w, u, chunk)
    bh, t, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    s = torch.zeros((bh, dk, dv), dtype=torch.float32, device=dev)
    y = torch.empty((bh, t, dv), dtype=q.dtype, device=dev)
    row = torch.arange(chunk, device=dev)
    tri = (row[:, None] >= row[None, :]) if include_current else \
        (row[:, None] > row[None, :])
    eye = row[:, None] == row[None, :]
    for c0 in range(0, t, chunk):
        qc, kc, vc, wc = (a[:, c0:c0 + chunk].float() for a in (q, k, v, w))
        lc = torch.cumsum(wc, dim=1)                  # inclusive
        lq = lc if include_current else torch.nn.functional.pad(
            lc[:, :-1], (0, 0, 1, 0))                 # lc shifted one step
        l_last = lc[:, -1:, :]                        # [BH, 1, Dk]
        yc = torch.bmm(qc * torch.exp(lq), s)
        diff = lq[:, :, None, :] - lc[:, None, :, :]  # [BH, L, L, Dk]
        diff = torch.where(tri[None, :, :, None], diff,
                           torch.tensor(float("-inf"), device=dev))
        a = (qc[:, :, None, :] * kc[:, None, :, :] * torch.exp(diff)).sum(-1)
        del diff
        if u is not None:
            diag = (qc * u.float()[:, None, :] * kc).sum(-1)   # [BH, L]
            a = a + torch.where(eye[None], diag[:, :, None], 0.0)
        y[:, c0:c0 + chunk] = (yc + torch.bmm(a, vc)).to(q.dtype)
        s = (torch.exp(l_last).transpose(1, 2) * s
             + torch.bmm((kc * torch.exp(l_last - lc)).transpose(1, 2), vc))
    return y, s
