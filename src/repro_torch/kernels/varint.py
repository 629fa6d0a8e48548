"""Varint/delta chunk decode on the device — the port of
``repro.kernels.varint`` (DESIGN.md §9, §10).

The host codec in :mod:`repro_torch.core.codec` decodes a compressed chunk
with three numpy bursts: LEB128 varint expansion, the interleaved
pair-delta cumsums and the per-run dst-residue restore.  These functions do
the same work on torch tensors, so a prefetched chunk goes bytes -> device
buffer -> decode -> combine without coming back to the host.

Scope: the **int32 value domain** (values < 2**31, <= 5 varint groups),
enough for every pair delta and dst residue the store encodes.  Results
are bit-equal to the host codec on that domain.

Two hand-written CUDA kernels carry the per-element work
(``csrc/varint.cu``):

* :func:`byte_stencil` — per byte, the LEB128 terminator flag and the value
  of the varint ending there (replaces the Pallas ``_byte_stencil``);
* :func:`blocked_scan` — inclusive int32 scan, ``add`` (wrapping) or
  running ``max`` seeded with 0 (replaces the Pallas ``blocked_scan``):
  one pass with decoupled look-back, so a call is one memset of its
  status words and one kernel, or the kernel alone within one tile.

Each wrapper launches its kernel on a CUDA tensor (and counts the launch
in ``.launches``) or raises; on a CPU tensor it runs the plain PyTorch
version beside it (:func:`byte_stencil_ref`, :func:`blocked_scan_ref`).

The OOC and serving paths decode a whole prefetch item in two launches of
:mod:`repro_torch.kernels.chunk_decode` instead of this per-chunk chain;
the functions here stay for a single stream's decode (the wire's gap
decode of a later slice) and as the reference the fused decode is held
against.
The rest — value placement, the pair-delta cumsums and the run restores —
is torch code around the scan, as in the reference.  The reference's
``.at[tgt].set/max(..., mode="drop")`` becomes a scatter into one extra
slot that is then cut off.

Every function sizes its buffers by its own input: there is no padding to
a per-store maximum (the reference padded so that one compiled program
served every chunk; eager PyTorch has nothing to recompile).

:func:`dst_delta_restore` differs from the reference on purpose.  The
reference forward-fills ``csum - res`` at run heads with a max-scan, which
is valid only while the int32 ``csum`` does not wrap; a chunk whose
residues sum to 2**31 or more (two chunks of R-MAT scale 21, seed 0, P = 8)
then decodes to wrong dst ids.  Here the run-head *position* is
forward-filled instead and the in-run sum is taken as
``csum[j] - csum[h] + res[h]`` in wrapping int32: the difference telescopes
to a sum smaller than the batch size, so it is exact even when ``csum``
wraps.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

SCAN_MODES = ("add", "max")
_SOURCE = "varint.cu"
_SCAN_TILE = 4096                 # elements per block of the scan kernel
_I64 = torch.int64
_I32 = torch.int32


# ---------------------------------------------------------------------------
# The CUDA library
# ---------------------------------------------------------------------------

def _library():
    from repro_torch.kernels.build import load_library
    lib = load_library(_SOURCE)
    if lib.blocked_scan_launch.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.blocked_scan_launch.argtypes = [ci, ll, vp, vp, vp, vp]
        lib.blocked_scan_launch.restype = ci
        lib.byte_stencil_launch.argtypes = [ll, vp, vp, vp, vp]
        lib.byte_stencil_launch.restype = ci
        lib.scan_tile_size.restype = ci
        lib.scan_scratch_words.argtypes = [ll]
        lib.scan_scratch_words.restype = ll
        lib.varint_error_string.argtypes = [ci]
        lib.varint_error_string.restype = ctypes.c_char_p
        if lib.scan_tile_size() != _SCAN_TILE:
            raise RuntimeError("varint.cu's scan tile does not match "
                               "kernels/varint.py")
    return lib


def _check_launch(lib, code, name):
    if code != 0:
        msg = lib.varint_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def _on_device(device):
    """The CUDA device context for ``device``, entered only when it is not
    the current device already.  The scan runs tens of thousands of times
    per OOC run at a few microseconds of device time each, so its host
    path is what a call costs: it skips the context where it can and
    takes the raw stream handle rather than building a Stream object."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check_1d(x, dtype, name):
    if x.dim() != 1 or x.dtype != dtype:
        raise ValueError(f"{name}: expected a 1-d {dtype} tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# blocked_scan
# ---------------------------------------------------------------------------

def scan_scratch_len(n: int) -> int:
    """64-bit scratch words the scan kernel needs for ``n`` elements: the
    tile counter and one status word per tile of the one level, or none
    when ``n`` fits in one tile (the library's ``scan_scratch_words``)."""
    tiles = -(-n // _SCAN_TILE)
    return tiles + 1 if tiles > 1 else 0


def blocked_scan(x: torch.Tensor, *, mode: str = "add") -> torch.Tensor:
    """Inclusive scan of an int32 vector.

    mode "add": cumulative sum, wrapping in int32; mode "max": running
    maximum seeded with 0 (so ``max(0, x[0..i])``).  A CUDA tensor
    launches the kernel (counted in ``blocked_scan.launches`` and
    ``blocked_scan.launches_by_mode``), after zeroing its status words on
    the same stream; a CPU tensor runs :func:`blocked_scan_ref`."""
    if mode not in SCAN_MODES:
        raise ValueError(f"unknown scan mode {mode!r}")
    _check_1d(x, _I32, "blocked_scan")
    kind = x.device.type
    if kind == "cpu":
        return blocked_scan_ref(x, mode=mode)
    if kind != "cuda":
        raise ValueError(f"blocked_scan runs on cpu or cuda, not {kind}")
    x = x.contiguous()
    n = x.numel()
    out = torch.empty_like(x)
    if n == 0:
        return out
    words = scan_scratch_len(n)
    scratch = (torch.empty(words, dtype=_I64, device=x.device) if words
               else None)
    lib = _library()
    with _on_device(x.device):
        code = lib.blocked_scan_launch(
            SCAN_MODES.index(mode), n, x.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch._C._cuda_getCurrentRawStream(x.device.index))
    _check_launch(lib, code, "blocked_scan")
    blocked_scan.launches += 1
    blocked_scan.launches_by_mode[mode] += 1
    return out


blocked_scan.launches = 0
blocked_scan.launches_by_mode = {m: 0 for m in SCAN_MODES}


def blocked_scan_ref(x: torch.Tensor, *, mode: str = "add") -> torch.Tensor:
    """Plain PyTorch version of :func:`blocked_scan` (any device).

    ``torch.cumsum`` of int32 returns int64 unless told otherwise, so the
    sum is taken in int64 and wrapped to int32 explicitly; the max mode is
    ``cummax`` clamped at the 0 seed."""
    if mode not in SCAN_MODES:
        raise ValueError(f"unknown scan mode {mode!r}")
    if x.numel() == 0:
        return x.to(_I32).clone()
    if mode == "add":
        c = torch.cumsum(x.to(torch.int64), 0)
        return (((c + 2**31) % 2**32) - 2**31).to(_I32)
    return torch.cummax(x.to(_I32), 0).values.clamp(min=0)


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    blocked_scan.launches = 0
    for m in SCAN_MODES:
        blocked_scan.launches_by_mode[m] = 0
    byte_stencil.launches = 0


# ---------------------------------------------------------------------------
# The LEB128 byte stencil and varint_decode
# ---------------------------------------------------------------------------

def byte_stencil(buf: torch.Tensor):
    """uint8 [N] byte stream -> (term [N] int32, val [N] int32): per byte,
    1 where it ends a varint, and the value of the varint ending there
    (garbage where it does not).  A CUDA tensor launches the kernel
    (counted in ``byte_stencil.launches``); a CPU tensor runs
    :func:`byte_stencil_ref`."""
    _check_1d(buf, torch.uint8, "byte_stencil")
    kind = buf.device.type
    if kind == "cpu":
        return byte_stencil_ref(buf)
    if kind != "cuda":
        raise ValueError(f"byte_stencil runs on cpu or cuda, not {kind}")
    buf = buf.contiguous()
    n = buf.numel()
    term = torch.empty(n, dtype=_I32, device=buf.device)
    val = torch.empty_like(term)
    if n == 0:
        return term, val
    lib = _library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        code = lib.byte_stencil_launch(n, buf.data_ptr(), term.data_ptr(),
                                       val.data_ptr(), stream)
    _check_launch(lib, code, "byte_stencil")
    byte_stencil.launches += 1
    return term, val


byte_stencil.launches = 0


def byte_stencil_ref(buf: torch.Tensor):
    """Plain PyTorch version of :func:`byte_stencil` (any device): the
    same 5-tap select, with uint32 wrapping emulated in int64."""
    b = buf.to(torch.int64)
    n = b.numel()
    is_term = (b & 0x80) == 0

    def back(x, d, fill):
        """x shifted d places later; the first d positions hold fill."""
        head = torch.full((min(d, n),), fill, dtype=x.dtype, device=x.device)
        return torch.cat([head, x[:max(n - d, 0)]])

    gpos = torch.full((n,), 4, dtype=torch.int64, device=b.device)
    for d in range(3, -1, -1):       # the smallest d with a terminator wins
        gpos = torch.where(back(is_term, d + 1, True),
                           torch.full_like(gpos, d), gpos)
    grp = b & 0x7F
    val = torch.zeros(n, dtype=torch.int64, device=b.device)
    for d in range(5):
        g = back(grp, d, 0)
        sh = 7 * (gpos - d).clamp(min=0)
        val = val + torch.where(d <= gpos, g << sh, torch.zeros_like(g))
    val = val & 0xFFFFFFFF
    val = torch.where(val >= 2**31, val - 2**32, val)
    return is_term.to(_I32), val.to(_I32)


def _scatter_drop(n: int, tgt: torch.Tensor, src, *, reduce=None):
    """``zeros(n).at[tgt].set/max(src, mode="drop")``: targets outside
    [0, n) land in one extra slot that is cut off."""
    tgt = torch.where((tgt >= 0) & (tgt < n), tgt.long(),
                      torch.full_like(tgt, n, dtype=torch.int64))
    out = torch.zeros(n + 1, dtype=_I32, device=tgt.device)
    if not isinstance(src, torch.Tensor):
        src = torch.full(tgt.shape, src, dtype=_I32, device=tgt.device)
    if reduce is None:
        out.scatter_(0, tgt, src.to(_I32))
    else:
        out.scatter_reduce_(0, tgt, src.to(_I32), reduce=reduce)
    return out[:n]


def varint_decode(buf: torch.Tensor, nbytes: int, *,
                  count: int) -> torch.Tensor:
    """Decode LEB128 varints (int32 domain) from a uint8 buffer.

    The live stream occupies ``buf[:nbytes]``; the rest is ignored.  When
    it holds fewer than ``count`` varints the tail of the result stays 0.
    Bit-equal to the host codec on values < 2**31.  Like the reference,
    this path does not validate the stream: corruption checks stay on the
    host read path, where the section CRCs are verified."""
    term, val = byte_stencil(buf)
    pos = torch.arange(buf.numel(), dtype=_I32, device=buf.device)
    live = (term > 0) & (pos < nbytes)
    li = live.to(_I32)
    vidx = blocked_scan(li, mode="add") - li
    tgt = torch.where(live & (vidx < count), vidx,
                      torch.full_like(vidx, count))
    return _scatter_drop(count, tgt, val)


# ---------------------------------------------------------------------------
# Delta restores (device twins of the codec's cumsum/repeat restores)
# ---------------------------------------------------------------------------

def pair_delta_restore(deltas: torch.Tensor):
    """Interleaved [ds0, di0, ds1, di1, ...] int32 deltas -> (src, idx)
    int32 cumulative arrays — the twin of ``codec.pair_delta_restore``."""
    v = deltas.reshape(-1, 2)
    return (blocked_scan(v[:, 0].contiguous(), mode="add"),
            blocked_scan(v[:, 1].contiguous(), mode="add"))


def expand_dcsr_index(srcs: torch.Tensor, starts: torch.Tensor, nnz: int,
                      n_e: int, *, out_len: int):
    """DCSR (src, start) runs -> per-edge (src [out_len], run-start mask
    [out_len]) by a scatter of the run heads and a running-max forward
    fill.  ``srcs`` is strictly increasing over the first ``nnz`` entries
    and ``starts[0] == 0``, so the max-scan reproduces numpy's
    ``repeat(srcs, runs)``."""
    ok = torch.arange(srcs.numel(), device=srcs.device) < nnz
    tgt = torch.where(ok, starts.long(), torch.full_like(starts, out_len,
                                                         dtype=torch.int64))
    src0 = _scatter_drop(out_len, tgt, torch.where(ok, srcs, 0),
                         reduce="amax")
    smask = _scatter_drop(out_len, tgt, 1)
    return _keep(blocked_scan(src0, mode="max"), smask, n_e)


def expand_csr_index(idx: torch.Tensor, v_src: int, n_e: int, *,
                     out_len: int):
    """CSR idx [V + 1] -> per-edge (src [out_len], run-start mask
    [out_len]).  Rows >= v_src are ignored; rows of zero degree place no
    run head."""
    r = torch.arange(idx.numel() - 1, dtype=_I32, device=idx.device)
    deg = idx[1:] - idx[:-1]
    ok = (r < v_src) & (deg > 0)
    tgt = torch.where(ok, idx[:-1].long(),
                      torch.full_like(r, out_len, dtype=torch.int64))
    src0 = _scatter_drop(out_len, tgt, torch.where(ok, r, 0),
                         reduce="amax")
    smask = _scatter_drop(out_len, tgt, 1)
    return _keep(blocked_scan(src0, mode="max"), smask, n_e)


def _keep(src, smask, n_e):
    keep = torch.arange(src.numel(), device=src.device) < n_e
    return torch.where(keep, src, 0), torch.where(keep, smask, 0)


def dst_delta_restore(res: torch.Tensor, start_mask: torch.Tensor, base: int,
                      n_e: int) -> torch.Tensor:
    """Residue stream + run-start mask -> dst int32, equal to
    ``codec.dst_delta_restore``.  The run head ``h`` of each position is
    forward-filled by a max-scan of the head positions, and
    ``csum[j] - csum[h] + res[h]`` is the in-run residue sum; in wrapping
    int32 it is exact even where ``csum`` wraps (see the module
    docstring).  Entries beyond ``n_e`` are zeroed."""
    n = res.numel()
    j = torch.arange(n, dtype=_I32, device=res.device)
    csum = blocked_scan(res, mode="add")
    head = blocked_scan(torch.where(start_mask > 0, j, 0), mode="max").long()
    dst = csum - csum[head] + res[head] + base
    return torch.where(j < n_e, dst, 0)
