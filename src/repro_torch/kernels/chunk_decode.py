"""The fused OOC chunk decode: one prefetch schedule item — the chunks of
one (destination partition, dst batch) — from its staged bytes to the
``BatchWork`` columns ``src``, ``part``, ``dst`` and ``data``, in at most
two kernel launches (``csrc/chunk_decode.cu``).

It replaces the per-chunk chain of :mod:`repro_torch.kernels.varint` on
the OOC and serving paths (a stencil, ~5 add scans and 2 max scans and
~20 torch ops per chunk, each staged from pageable memory), and with it the
Pallas TPU kernels ``_byte_stencil`` and ``blocked_scan`` of
``src/repro/kernels/varint.py`` there.  Results are bit-equal to the host
codec (``ChunkStore.decode_chunk``) on every representation.

**The staged item.**  :func:`plan_item` lays an item out in one byte
buffer, every region 16-byte aligned:

    [chunk table: int64 [n_chunks, 13]]  rep, part, n_e, nnz, v_src, base,
                                         out_off, pair_off, index_off,
                                         index_nb, res_off, res_nb,
                                         data_off (-1: elided)
    [section table: int64 [n_sections, 6]]  kind, byte_off, nbytes,
                                            first_tile, count, out_base
    [status: int4 aggregate [tiles], int4 prefix [tiles],
             uint32 flag [tiles], uint32 tile counter]   (zero)
    [per chunk: index bytes | residue bytes | float32 data]

A *section* is a varint stream the first launch decodes: a chunk's
delta-varint pair section (``REP_DCSR_DELTA``; ``2 nnz`` varints) or its
dst residues (``n_e`` varints).  :func:`write_item` fills a host buffer
(page-locked on the card's path), so one copy brings the whole item, its
zeroed look-back status included, to the device.

**The two launches.**
1. Over the sections' 4,096-byte tiles: the LEB128 5-tap select per byte
   (a 4-byte halo, bytes before the section count as terminators), then a
   scan *segmented* by section with decoupled look-back.  The carry is
   (varints so far, sum of even-index values, sum of odd-index values) on
   a pair section, giving ``srcs`` and run ``starts``, and (varints so
   far, wrapping int32 sum) on a residue section, giving ``csum``.
2. One thread per edge: its chunk and run by binary search (of ``starts``,
   or of the CSR row offsets, which skips rows of degree 0), so ``src``
   and the run head ``h``; then ``dst = base + csum[j] - csum[h - 1]``
   (0 for ``h = 0``) in wrapping int32 — the residues of one run summed,
   exact even where ``csum`` wraps (``varint`` module docstring) — and
   ``part``, and ``data`` (the staged float32 values, or 1).

:func:`decode_item` launches the kernels on a CUDA buffer (counted in
``decode_item.launches``, its calls in ``decode_item.calls``) or raises;
on a CPU buffer it runs :func:`decode_item_ref`, the plain PyTorch
version, which reads the same tables and decodes each chunk with the
plain stencil, cumulative sums and ``torch.searchsorted``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import varint as vk

# The store's representation codes (repro_torch.core.chunkstore).
REP_DCSR, REP_CSR, REP_DCSR_DELTA = 0, 1, 2
SEC_RESIDUE, SEC_PAIRS = 0, 1
TILE_BYTES = 4096                # bytes per tile of the first launch
CHUNK_FIELDS = ("rep", "part", "n_e", "nnz", "v_src", "base", "out_off",
                "pair_off", "index_off", "index_nb", "res_off", "res_nb",
                "data_off")
_C = {name: i for i, name in enumerate(CHUNK_FIELDS)}
SEC_FIELDS = ("kind", "byte_off", "nbytes", "first_tile", "count",
              "out_base")
# what chunk_decode_format reports of csrc/chunk_decode.cu
FORMAT = (TILE_BYTES, len(CHUNK_FIELDS), len(SEC_FIELDS), REP_DCSR, REP_CSR,
          REP_DCSR_DELTA, SEC_RESIDUE, SEC_PAIRS)
_ALIGN = 16
_SOURCE = "chunk_decode.cu"
_I32 = torch.int32
_I64 = torch.int64


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


@dataclasses.dataclass(frozen=True)
class ChunkBytes:
    """One chunk of an item as read from the store: its representation,
    source partition, edge and pair counts, source-partition size, the
    batch base ``k * batch_size``, and its index, dst-residue and float32
    data sections (``data`` None when the store elides values)."""
    rep: int
    part: int
    n_e: int
    nnz: int
    v_src: int
    base: int
    index: bytes
    residues: bytes
    data: bytes | None


@dataclasses.dataclass(frozen=True)
class ItemPlan:
    """Where everything of one staged item lies (byte offsets) and what
    the launches need to size their grids and outputs."""
    chunk_table: np.ndarray      # int64 [n_chunks, len(CHUNK_FIELDS)]
    sec_table: np.ndarray        # int64 [n_sections, len(SEC_FIELDS)]
    n_tiles: int
    n_edges: int
    n_pairs: int                 # srcs / starts slots of the pair sections
    chunk_off: int
    sec_off: int
    status_off: int
    nbytes: int

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_table)

    @property
    def n_sections(self) -> int:
        return len(self.sec_table)


def status_nbytes(n_tiles: int) -> int:
    """Bytes of the look-back status area: an int4 aggregate, an int4
    prefix and a uint32 flag per tile, and the tile counter."""
    return _align(36 * n_tiles + 4) if n_tiles else 0


def plan_item(chunks) -> ItemPlan:
    """Lay out an item of :class:`ChunkBytes` (module docstring)."""
    ct = np.zeros((len(chunks), len(CHUNK_FIELDS)), np.int64)
    secs = []                      # [kind, chunk, nbytes, first_tile, ...]
    out_off = pair_off = tiles = 0
    for i, c in enumerate(chunks):
        if not 0 <= c.n_e < 2**31 or 2 * c.nnz >= 2**31:
            raise ValueError(f"chunk {i}: {c.n_e} edges / {c.nnz} pairs "
                             "leave the int32 domain of the decode")
        ct[i, :8] = (c.rep, c.part, c.n_e, c.nnz, c.v_src, c.base, out_off,
                     pair_off)
        if c.rep == REP_DCSR_DELTA and len(c.index):
            secs.append([SEC_PAIRS, i, len(c.index), tiles, 2 * c.nnz,
                         pair_off])
            tiles += -(-len(c.index) // TILE_BYTES)
            pair_off += c.nnz
        if len(c.residues):
            secs.append([SEC_RESIDUE, i, len(c.residues), tiles, c.n_e,
                         out_off])
            tiles += -(-len(c.residues) // TILE_BYTES)
        out_off += c.n_e
    st = np.array(secs, np.int64).reshape(-1, len(SEC_FIELDS))
    sec_off = _align(ct.nbytes)
    status_off = sec_off + _align(st.nbytes)
    off = status_off + status_nbytes(tiles)
    for i, c in enumerate(chunks):
        ct[i, _C["index_off"]], ct[i, _C["index_nb"]] = off, len(c.index)
        off += _align(len(c.index))
        ct[i, _C["res_off"]], ct[i, _C["res_nb"]] = off, len(c.residues)
        off += _align(len(c.residues))
        ct[i, _C["data_off"]] = -1 if c.data is None else off
        off += 0 if c.data is None else _align(len(c.data))
    for s in st:                   # chunk number -> the section's bytes
        s[1] = ct[s[1], _C["index_off" if s[0] == SEC_PAIRS else "res_off"]]
    return ItemPlan(chunk_table=ct, sec_table=st, n_tiles=tiles,
                    n_edges=out_off, n_pairs=pair_off, chunk_off=0,
                    sec_off=sec_off, status_off=status_off, nbytes=off)


def write_item(plan: ItemPlan, chunks, buf: np.ndarray) -> None:
    """Fill ``buf`` (uint8, at least ``plan.nbytes``) with the staged item:
    the tables, the zeroed status area and every chunk's sections."""
    head = plan.status_off + status_nbytes(plan.n_tiles)
    buf[:head] = 0
    ct, st = plan.chunk_table, plan.sec_table
    buf[plan.chunk_off:plan.chunk_off + ct.nbytes] = ct.view(np.uint8).ravel()
    buf[plan.sec_off:plan.sec_off + st.nbytes] = st.view(np.uint8).ravel()
    for row, c in zip(ct, chunks):
        for off, raw in ((row[_C["index_off"]], c.index),
                         (row[_C["res_off"]], c.residues),
                         (row[_C["data_off"]], c.data)):
            if raw is not None and len(raw):
                buf[off:off + len(raw)] = np.frombuffer(raw, np.uint8)


# ---------------------------------------------------------------------------
# The wrapper and its CUDA library
# ---------------------------------------------------------------------------

def _library():
    from repro_torch.kernels.build import load_library
    lib = load_library(_SOURCE)
    fn = lib.chunk_decode_launch
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, ll, ci, ll, ci, ci, ll, ll] + [vp] * 7 + [vp]
        fn.restype = ci
        lib.chunk_decode_format.argtypes = [vp, ci]
        lib.chunk_decode_format.restype = ci
        lib.chunk_decode_error_string.argtypes = [ci]
        lib.chunk_decode_error_string.restype = ctypes.c_char_p
        out = (ci * len(FORMAT))()
        n = lib.chunk_decode_format(out, len(FORMAT))
        if n != len(FORMAT) or tuple(out) != FORMAT:
            raise RuntimeError(
                f"chunk_decode.cu's item format {tuple(out)[:n]} does not "
                f"match kernels/chunk_decode.py's {FORMAT}")
    return lib


def _outputs(n_edges, n_pairs, device):
    """One int32 buffer for (src, part, dst, data, csum, srcs, starts);
    the four columns are views of it (data reinterpreted as float32)."""
    buf = torch.empty(5 * n_edges + 2 * n_pairs, dtype=_I32, device=device)
    cols = buf[:5 * n_edges].view(5, n_edges)
    pairs = buf[5 * n_edges:].view(2, n_pairs)
    return cols, pairs


def decode_item(staged: torch.Tensor, plan: ItemPlan):
    """uint8 staged item (:func:`write_item`) -> (src, part, dst, data):
    int32, int32, int32, float32 [plan.n_edges], chunk after chunk.  A
    CUDA buffer launches the kernels on the current stream — at most two,
    counted in ``decode_item.launches`` — a CPU buffer runs
    :func:`decode_item_ref`; ``decode_item.calls`` counts both."""
    if staged.dim() != 1 or staged.dtype != torch.uint8 or \
            not staged.is_contiguous():
        raise ValueError("decode_item: expected a contiguous 1-d uint8 "
                         "staged buffer")
    if staged.data_ptr() % _ALIGN:
        raise ValueError(f"decode_item: the staged buffer must be "
                         f"{_ALIGN}-byte aligned (the kernels read its "
                         "regions in 16-byte words)")
    if staged.numel() < plan.nbytes:
        raise ValueError(f"decode_item: {staged.numel()} staged bytes, the "
                         f"plan needs {plan.nbytes}")
    kind = staged.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"decode_item runs on cpu or cuda, not {kind}")
    decode_item.calls += 1
    if kind == "cpu":
        return decode_item_ref(staged, plan)
    cols, pairs = _outputs(plan.n_edges, plan.n_pairs, staged.device)
    src, part, dst, data, csum = cols
    if plan.n_tiles or plan.n_edges:
        lib = _library()
        with vk._on_device(staged.device):
            code = lib.chunk_decode_launch(
                staged.data_ptr(), plan.chunk_off, plan.n_chunks,
                plan.sec_off, plan.n_sections, plan.n_tiles,
                plan.status_off, plan.n_edges, src.data_ptr(),
                part.data_ptr(), dst.data_ptr(), data.data_ptr(),
                csum.data_ptr(), pairs[0].data_ptr(), pairs[1].data_ptr(),
                torch._C._cuda_getCurrentRawStream(staged.device.index))
        if code != 0:
            msg = lib.chunk_decode_error_string(code).decode()
            raise RuntimeError(f"chunk_decode launch failed: {msg} "
                               f"(cudaError {code})")
        decode_item.launches += (plan.n_tiles > 0) + (plan.n_edges > 0)
    return src, part, dst, data.view(torch.float32)


decode_item.launches = 0
decode_item.calls = 0


def reset_launches() -> None:
    decode_item.launches = 0
    decode_item.calls = 0


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return (((x + 2**31) % 2**32) - 2**31).to(_I32)


def run_heads(offsets: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """For each position ``j``, the last run ``r`` with
    ``offsets[r] <= j`` — the kernel's binary search.  ``offsets`` are a
    chunk's run starts (DCSR) or its CSR row offsets without the last
    (rows of degree 0 share their offset with the next row, which the
    search then picks)."""
    return torch.searchsorted(offsets.to(_I64), j.to(_I64), right=True) - 1


def _varints_ref(buf: torch.Tensor, count: int) -> torch.Tensor:
    """The first ``count`` LEB128 values of a byte stream, int32: the
    plain stencil's values at its terminators."""
    term, val = vk.byte_stencil_ref(buf)
    return val[term > 0][:count]


def decode_item_ref(staged: torch.Tensor, plan: ItemPlan):
    """Plain PyTorch version of :func:`decode_item` (any device): the
    tables are read back from the staged bytes, and each chunk decoded
    with the plain stencil, wrapping cumulative sums and
    :func:`run_heads`."""
    dev = staged.device
    b = staged[:plan.nbytes]

    def table(off, rows, cols):
        return b[off:off + rows * cols * 8].view(_I64).view(rows, cols)

    ct = table(plan.chunk_off, plan.n_chunks, len(CHUNK_FIELDS)).tolist()
    cols = {name: [] for name in ("src", "part", "dst", "data")}
    for (rep, part, n_e, nnz, v_src, base, _, _, index_off, index_nb,
         res_off, res_nb, data_off) in ct:
        j = torch.arange(n_e, dtype=_I64, device=dev)
        index = b[index_off:index_off + index_nb]
        res = b[res_off:res_off + res_nb]
        csum = vk.blocked_scan_ref(_varints_ref(res, n_e))
        if rep == REP_CSR:
            idx = index.view(_I32)
            r = run_heads(idx[:v_src], j)
            src, head = r.to(_I32), idx.to(_I64)[r]
        elif rep in (REP_DCSR, REP_DCSR_DELTA):
            if rep == REP_DCSR:
                pairs = index.view(_I32)
                srcs, starts = pairs[0::2], pairs[1::2]
            else:
                pv = _varints_ref(index, 2 * nnz)
                srcs = vk.blocked_scan_ref(pv[0::2].contiguous())
                starts = vk.blocked_scan_ref(pv[1::2].contiguous())
            r = run_heads(starts, j)
            src, head = srcs[r], starts.to(_I64)[r]
        else:
            raise ValueError(f"unknown chunk representation {rep!r}")
        c64 = csum.to(_I64)
        before = torch.where(head > 0, c64[(head - 1).clamp(min=0)],
                             torch.zeros_like(head))
        cols["dst"].append(_wrap32(base + c64 - before))
        cols["src"].append(src.to(_I32))
        cols["part"].append(torch.full((n_e,), part, dtype=_I32, device=dev))
        cols["data"].append(
            torch.ones(n_e, dtype=torch.float32, device=dev) if data_off < 0
            else b[data_off:data_off + 4 * n_e].view(torch.float32).clone())
    out = []
    for name, dtype in (("src", _I32), ("part", _I32), ("dst", _I32),
                        ("data", torch.float32)):
        out.append(torch.cat(cols[name]) if cols[name]
                   else torch.empty(0, dtype=dtype, device=dev))
    return tuple(out)
