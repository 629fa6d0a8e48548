"""Block-CSR selective combine — the ProcessEdges phase-4 hot loop.

The (dst batch x src partition) adjacency of each destination partition is
tiled into dense T x T blocks, only nonempty tiles are stored, and phase 4
folds each row block's *live* tiles (those whose chunk received messages)
against the message vector.  :func:`block_csr_combine` does that for every
destination partition in one launch of the hand-written CUDA kernel in
``csrc/block_csr_combine.cu``.  On CPU tensors it runs
:func:`block_csr_combine_ref`, the plain PyTorch version of the same
function, which the tests hold against the JAX kernel.

Source note.  The kernel replaces the Pallas TPU kernel
``block_csr_combine`` of ``src/repro/kernels/csr_spmv.py`` (body
``_make_combine_kernel``).  On an H100 it is bound by bytes: per live
tile 2–3 tiles of 256 B (C, and V and/or B) plus 8 B of slot index and
64 B of gathered vector, and 64 B out per row — under 0.5 flop per byte.
R-MAT rows are very uneven (a hub row holds tens of thousands of live
tiles, most rows a few hundred, many none), so the work is split by live
slots, not rows, with Merrill and Garland's merge path (SC'16): the live
slots of all Q x R rows in row order and the rows' ends form one path,
and each unit (a warp) takes K items of it (:func:`combine_units`
computes the split from the prefix of ``row_cnt``, with a sorted search;
K is the library's compile-time constant).  A unit writes the rows it
covers whole straight to the outputs; a row that spans units leaves one
partial per unit in scratch the wrapper allocates, and a second kernel
folds them in unit order and writes the row.  No atomics, so a call is
deterministic; add modes accumulate in double (only the association
differs from the plain version), min/max are exact.  Within a unit the
slot indices of 32 slots come in one coalesced load and are broadcast by
shuffles, so a batch of tile loads is in flight at once, and tiles load
with a streaming hint.  One call launches the split's few torch ops and
the two kernels; its time follows the live tiles, plus the fixup's fold
of one partial per K tiles of a hub row.

:func:`block_csr_combine_mq` is the multi-query panel form (it replaces
the Pallas kernel ``block_csr_combine_mq`` of the same reference file,
body ``_make_combine_kernel_mq``): the same tiles folded against Q value
and presence columns, each tile read once for all of them.  It launches
the same CUDA kernel bodies, instantiated for 1, 2, 4, 8 or 16 columns,
over the same split (it depends on ``row_cnt`` alone), so each column is
bit-identical to a solo call on it; the wrapper pads the
panel to the next such width with dead columns (identity values, no
presence) and runs more than 16 columns in groups of 16.  Its plain
version :func:`block_csr_combine_mq_ref` is the solo plain version
column by column.

:func:`block_csr_spmv` is the standalone SpMV over a block-CSR
structure such as :func:`build_block_csr`'s padded layout (it replaces the
Pallas kernel ``block_csr_spmv`` of the same reference file, body
``_kernel``), reached through :func:`repro_torch.kernels.ops.spmv`.  The
padded layout is mostly zeros (padding slots, and ~1 edge in a tile's 64
cells on a sparse graph), so the kernel reads a packed form of the same
matrix, :func:`pack_block_csr`: only the live tiles and only their
occupied cells.  :func:`block_csr_spmv_packed` is the kernel's wrapper;
its CUDA kernel lives in its own source, ``csrc/block_csr_spmv.cu``, so
the combine's library does not change with it; its plain version is
:func:`block_csr_spmv_packed_ref`, and :func:`block_csr_spmv_ref` keeps
the dense definition as the tests' oracle.

The structure builders (:func:`build_tile_struct`, in torch on whatever
device its inputs lie; :func:`compact_live_tiles` and
:func:`build_block_csr`, numpy copied from the reference) give tile
structures bit-equal to JAX's.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

MODES = ("add", "add_b", "min", "max")
KERNEL_TILES = (8,)              # tile sizes the CUDA kernel is built for
_SOURCE = "block_csr_combine.cu"
_REF_CHUNK = 1 << 22             # live tiles per step of the plain version


# ---------------------------------------------------------------------------
# The standalone SpMV: wrapper, CUDA launch, plain version
# ---------------------------------------------------------------------------

SPMV_MAX_TILE = 32               # largest tile the SpMV kernel takes
_SPMV_SOURCE = "block_csr_spmv.cu"
_SPMV_REF_CELLS = 1 << 26        # tile cells per step of the plain versions
_PACK_CELLS = 1 << 26            # dense tile cells per step of the pack
_BYTE_BITS = 1 << torch.arange(8, dtype=torch.uint8)


def block_csr_spmv(tiles, tile_col, row_ptr, x, *, tile: int):
    """Block-CSR SpMV: ``out[r*T:(r+1)*T] = sum_s tiles[s] @
    x[tile_col[s]*T:(tile_col[s]+1)*T]`` over each row block's slots
    ``[row_ptr[r], row_ptr[r+1])``.

    tiles [n, T, T] f32; tile_col [n] i32 source block per slot; row_ptr
    [R+1] i32; x [C*T] f32 with every tile_col < C.  On
    :func:`build_block_csr`'s padded layout each row holds
    ``max_tiles_per_row`` slots, zero tiles included, so this is the JAX
    kernel's grid.  Returns out [R*T] f32.  Every call packs the
    structure (:func:`pack_block_csr`, one pack per call, on the inputs'
    device) and runs :func:`block_csr_spmv_packed` on the packed form: CPU
    tensors its plain version, CUDA tensors the kernel (counted in
    ``block_csr_spmv.launches``) or raise.  A caller that multiplies by
    one structure more than once packs it once and calls
    :func:`block_csr_spmv_packed`, as :func:`repro_torch.kernels.ops.spmv`
    does."""
    return block_csr_spmv_packed(
        pack_block_csr(tiles, tile_col, row_ptr, tile=tile), x)


block_csr_spmv.launches = 0


def pack_block_csr(tiles, tile_col, row_ptr, *, tile: int) -> dict:
    """The packed form of a block-CSR structure, on the device its inputs
    lie on: only the live tiles, in row order, and only their occupied
    cells.  A cell is occupied when the dense tile holds a nonzero there;
    a tile is live when any of its cells is.  Returns a dict of

    * ``prow`` [R+1] int64: each row block's first live tile;
    * ``pcol`` [L] int32: each live tile's source block;
    * ``pmask`` [L, W] int64: occupancy bits, W = ceil(T*T / 64); cell
      ``i*T + j`` is bit ``(i*T+j) % 64`` of word ``(i*T+j) // 64`` (bit
      63 makes the int64 negative; the kernel reads it unsigned);
    * ``pvoff`` [R+1] int64: each row block's first value;
    * ``pval`` [nnz] float32: the occupied cells' values, in (tile, cell)
      order;
    * ``tile``, ``n_rows``, and ``x_len``, the least length of x (the
      largest source block read, plus one, times T).

    With finite x the SpMV over the packed form is the same function.  One
    difference: a zero weight no longer meets x, so an explicit zero
    against an inf or NaN in x gives 0 where the dense product gives NaN.
    The dense tiles are read in steps of ``_PACK_CELLS`` cells, so the
    pack's temporaries stay a fraction of the packed form (a few hundred
    MB at 2^25 edges), whatever the dense structure's size."""
    t = tile
    if t < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    cells = t * t
    words = -(-cells // 64)
    dev = tiles.device
    n_rows = row_ptr.shape[0] - 1
    rp = row_ptr.to(dev, torch.int64)
    rp_host = rp.cpu()
    flat = tiles.reshape(-1, cells)
    lo, hi = int(rp_host[0]), int(rp_host[-1])
    prow = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    pvoff = torch.zeros_like(prow)
    n_live = torch.zeros((), dtype=torch.int64, device=dev)
    n_val = torch.zeros_like(n_live)
    cols, masks, vals = [], [], []
    step = max(1, _PACK_CELLS // cells)
    for s0 in range(lo, hi, step):
        s1 = min(hi, s0 + step)
        blk = flat[s0:s1]
        nz = blk != 0
        cnt = nz.sum(1)
        live = cnt > 0
        vals.append(blk[nz])
        cols.append(tile_col[s0:s1].to(dev, torch.int32)[live])
        nz = nz[live]
        bits = torch.zeros((nz.shape[0], words * 64), dtype=torch.uint8,
                           device=dev)
        bits[:, :cells] = nz
        live = live.long()
        masks.append((bits.view(-1, words * 8, 8) * _BYTE_BITS.to(dev)).sum(
            -1, dtype=torch.uint8).view(torch.int64))
        # the row boundaries in [s0, s1): the counts before them
        a = int(torch.searchsorted(rp_host, s0))
        b = int(torch.searchsorted(rp_host, s1))
        at = rp[a:b] - s0
        prow[a:b] = n_live + (torch.cumsum(live, 0) - live)[at]
        pvoff[a:b] = n_val + (torch.cumsum(cnt, 0) - cnt)[at]
        n_live = n_live + live.sum()
        n_val = n_val + cnt.sum()
    b = int(torch.searchsorted(rp_host, hi))    # boundaries at the end
    prow[b:] = n_live
    pvoff[b:] = n_val
    pcol = (torch.cat(cols) if cols
            else torch.zeros(0, dtype=torch.int32, device=dev))
    pmask = (torch.cat(masks) if masks
             else torch.zeros((0, words), dtype=torch.int64, device=dev))
    pval = (torch.cat(vals).to(torch.float32) if vals
            else torch.zeros(0, dtype=torch.float32, device=dev))
    pack_block_csr.calls += 1
    return dict(prow=prow, pcol=pcol, pmask=pmask, pvoff=pvoff, pval=pval,
                tile=t, n_rows=n_rows,
                x_len=(int(pcol.max()) + 1) * t if pcol.numel() else 0)


pack_block_csr.calls = 0
PACKED_ARRAYS = ("prow", "pcol", "pmask", "pvoff", "pval")


def block_csr_spmv_packed(packed: dict, x):
    """:func:`block_csr_spmv` over :func:`pack_block_csr`'s packed form.
    CPU tensors run :func:`block_csr_spmv_packed_ref`; CUDA tensors launch
    the kernel (counted in ``block_csr_spmv.launches``) or raise.  Returns
    out [R*T] f32."""
    tile = packed["tile"]
    if x.dim() != 1 or x.numel() % tile:
        raise ValueError(f"x must be a vector of whole tiles of {tile}, got "
                         f"shape {tuple(x.shape)}")
    if x.numel() < packed["x_len"]:
        raise ValueError(f"x holds {x.numel()} values; the structure reads "
                         f"{packed['x_len']}")
    kind = x.device.type
    if kind == "cpu":
        return block_csr_spmv_packed_ref(packed, x)
    if kind != "cuda":
        raise ValueError(f"block_csr_spmv runs on cpu or cuda, not {kind}")
    return _launch_spmv(packed, x)


def _spmv_library():
    from repro_torch.kernels.build import load_library
    lib = load_library(_SPMV_SOURCE)
    fn = lib.block_csr_spmv_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci] + [vp] * 8
        fn.restype = ci
        lib.block_csr_spmv_error_string.argtypes = [ci]
        lib.block_csr_spmv_error_string.restype = ctypes.c_char_p
    return lib


def _launch_spmv(packed, x):
    tile, n_rows = packed["tile"], packed["n_rows"]
    if tile > SPMV_MAX_TILE:
        raise ValueError(f"the CUDA SpMV kernel takes tiles up to "
                         f"{SPMV_MAX_TILE}, not {tile}")
    n_live = packed["pcol"].shape[0]
    words = -(-tile * tile // 64)
    dev = x.device
    shapes = {"prow": (torch.int64, (n_rows + 1,)),
              "pcol": (torch.int32, (n_live,)),
              "pmask": (torch.int64, (n_live, words)),
              "pvoff": (torch.int64, (n_rows + 1,)),
              "pval": (torch.float32, tuple(packed["pval"].shape)),
              "x": (torch.float32, tuple(x.shape))}
    for name, (dtype, shape) in shapes.items():
        a = x if name == "x" else packed[name]
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{a.dtype} {tuple(a.shape)} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(max(n_rows, 0) * tile, dtype=torch.float32,
                      device=dev)
    if n_rows < 1:
        return out
    lib = _spmv_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.block_csr_spmv_launch(
            tile, n_rows, *(packed[k].data_ptr() for k in PACKED_ARRAYS),
            x.data_ptr(), out.data_ptr(), stream)
    if code != 0:
        msg = lib.block_csr_spmv_error_string(code).decode()
        raise RuntimeError(f"block_csr_spmv launch failed: {msg} "
                           f"(cudaError {code})")
    block_csr_spmv.launches += 1
    return out


def block_csr_spmv_packed_ref(packed: dict, x):
    """Plain PyTorch version of :func:`block_csr_spmv_packed` (any tile
    size, any device): every occupied cell's product ``pval * x[pcol*T +
    j]`` taken in float64 and folded into its output row with
    ``index_add_``, as many live tiles at a time as hold
    ``_SPMV_REF_CELLS`` cells; the float64 sum is rounded to float32
    once."""
    t, n_rows = packed["tile"], packed["n_rows"]
    prow, pcol, pmask, pval = (packed[k] for k in
                               ("prow", "pcol", "pmask", "pval"))
    dev = x.device
    cells = t * t
    owner = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                    (prow[1:] - prow[:-1]))
    out = torch.zeros(n_rows * t, dtype=torch.float64, device=dev)
    byte_bits = _BYTE_BITS.to(dev)
    step = max(1, _SPMV_REF_CELLS // cells)
    v0 = 0
    for lo in range(0, pcol.numel(), step):
        m = pmask[lo:lo + step]
        bits = (m.view(torch.uint8)[..., None] & byte_bits) != 0
        tile_i, cell = bits.reshape(m.shape[0], -1)[:, :cells].nonzero(
            as_tuple=True)
        vals = pval[v0:v0 + cell.numel()].double()
        v0 += cell.numel()
        xv = x[pcol[lo:lo + step].long()[tile_i] * t + cell % t].double()
        out.index_add_(0, owner[lo:lo + step][tile_i] * t + cell // t,
                       vals * xv)
    return out.to(torch.float32)


def block_csr_spmv_ref(tiles, tile_col, row_ptr, x, *, tile: int):
    """The dense definition of :func:`block_csr_spmv` (same arguments,
    same result, any tile size, any device), the tests' oracle: every
    row's slots expanded into one flat list, their tile-vector products
    taken in float64 and folded into the rows with ``index_add_``, as many
    slots at a time as hold ``_SPMV_REF_CELLS`` tile cells; the float64
    sum is rounded to float32 once, as the kernel does."""
    t = tile
    dev = x.device
    n_rows = row_ptr.shape[0] - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    owner = torch.repeat_interleave(torch.arange(n_rows, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    slot = (row_ptr[:-1].long()[owner]
            + torch.arange(owner.numel(), device=dev) - first[owner])
    out = torch.zeros((n_rows, t), dtype=torch.float64, device=dev)
    lanes = torch.arange(t, device=dev)
    step = max(1, _SPMV_REF_CELLS // (t * t))
    for lo in range(0, owner.numel(), step):
        sl = slot[lo:lo + step]
        xb = x[tile_col[sl].long()[:, None] * t + lanes].double()
        out.index_add_(0, owner[lo:lo + step], torch.bmm(
            tiles[sl].double(), xb[:, :, None])[..., 0])
    return out.to(torch.float32).reshape(-1)


# ---------------------------------------------------------------------------
# The combine: wrapper, CUDA launch, plain version
# ---------------------------------------------------------------------------

def combine_units(row_cnt, n_slots: int, unit_slots: int):
    """The merge-path split of a combine call into units of ``unit_slots``
    items, on the device ``row_cnt`` lies on (CPU tensors too).

    The path holds the Q x R rows of ``row_cnt`` [Q, R] (flattened in row
    order, f = q * R + r) and their live slots (numbered 0.. in the same
    order): row f's slots are [row_end[f] - row_cnt[f], row_end[f]), and
    its end is the path item that follows its last slot.  Unit u takes
    items [u * K, (u + 1) * K) and starts at row ``unit_row[u]`` and slot
    ``unit_slot[u]`` (``unit_row[u] + unit_slot[u] = min(u * K, path
    length)``); it holds slots [unit_slot[u], unit_slot[u + 1]) and
    finishes rows [unit_row[u], unit_row[u + 1]).  Row f is the unit's own
    when it finishes there and starts at or after the unit's first slot;
    otherwise it spans units and the fixup folds it.

    The units are counted for the longest path the slot arrays allow
    (every one of the ``n_slots`` slots of each destination live), so no
    value is read back from the device; the units past the path are
    empty.  Returns (row_end [Q*R], unit_row [n_units + 1], unit_slot
    [n_units + 1]), int32.  Raises if that path reaches 2**31 items."""
    if unit_slots < 2:
        raise ValueError(f"a unit takes at least 2 items, not {unit_slots}")
    q_cnt, n_rows = row_cnt.shape
    most = q_cnt * (n_rows + n_slots)
    if most >= 2**31:
        raise ValueError(f"a combine call of {q_cnt * n_rows} rows and "
                         f"{q_cnt * n_slots} slots exceeds the kernel's "
                         "int32 merge path")
    n_units = -(-most // unit_slots)
    dev = row_cnt.device
    counts = row_cnt.reshape(-1).to(torch.int64)
    row_end = torch.cumsum(counts, 0)
    n_flat = counts.numel()
    # the path position just past row f's end, increasing in f
    key = row_end + torch.arange(1, n_flat + 1, device=dev)
    total = key[-1] if n_flat else torch.zeros((), dtype=torch.int64,
                                               device=dev)
    diag = torch.minimum(
        torch.arange(n_units + 1, device=dev, dtype=torch.int64) * unit_slots,
        total)
    unit_row = torch.searchsorted(key, diag, right=True)
    unit_slot = diag - unit_row
    return (row_end.to(torch.int32), unit_row.to(torch.int32),
            unit_slot.to(torch.int32))


def block_csr_combine(row_ptr, tile_idx, tile_col, row_cnt,
                      tiles_v, tiles_b, tiles_cnt, xv, xc, *,
                      mode: str, tile: int, identity: float = 0.0):
    """Selective monoid combine over runtime-compacted block-CSR tiles.

    Every argument carries a leading destination axis Q: one launch
    serves all Q destination partitions.

    row_ptr [Q, R+1] i32: static slot offsets per destination row block.
    tile_idx [Q, S] i32: storage tile per compacted slot (live-first per row).
    tile_col [Q, S] i32: source block id per compacted slot.
    row_cnt [Q, R] i32: live tiles per row; slots past it are never read.
    tiles_v / tiles_b [Q, S, T, T] f32 or None depending on ``mode``
      (add: tiles_v; add_b: tiles_v + tiles_b; min/max: tiles_b).
    tiles_cnt [Q, S, T, T] f32: per-cell valid-edge multiplicities.
    xv [Q, C*T] f32: slot-transformed masked messages (identity where absent).
    xc [Q, C*T] f32: 0/1 message-presence mask.

    Returns (val [Q, R*T] f32 — the monoid aggregate, identity where
    nothing arrived; hascnt [Q, R*T] f32 — live edges that delivered).
    CPU tensors run :func:`block_csr_combine_ref`; CUDA tensors launch the
    split (:func:`combine_units`), the combine kernel and its fixup (the
    call counted once in ``block_csr_combine.launches``) or raise."""
    if mode not in MODES:
        raise ValueError(f"unknown combine mode {mode!r}")
    kind = row_cnt.device.type
    if kind == "cpu":
        return block_csr_combine_ref(
            row_ptr, tile_idx, tile_col, row_cnt, tiles_v, tiles_b,
            tiles_cnt, xv, xc, mode=mode, tile=tile, identity=identity)
    if kind != "cuda":
        raise ValueError(f"block_csr_combine runs on cpu or cuda, not {kind}")
    return _launch(row_ptr, tile_idx, tile_col, row_cnt, tiles_v, tiles_b,
                   tiles_cnt, xv, xc, mode=mode, tile=tile,
                   identity=identity)


block_csr_combine.launches = 0


def _library():
    from repro_torch.kernels.build import load_library
    lib = load_library(_SOURCE)
    fn = lib.block_csr_combine_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci] * 7 + [ctypes.c_float] + [vp] * 16
        fn.restype = ci
        lib.block_csr_combine_error_string.argtypes = [ci]
        lib.block_csr_combine_error_string.restype = ctypes.c_char_p
        lib.block_csr_combine_unit_slots.restype = ci
        mq = lib.block_csr_combine_mq_launch
        mq.argtypes = [ci] * 10 + [ctypes.c_float] + [vp] * 16
        mq.restype = ci
    return lib


def _launch(row_ptr, tile_idx, tile_col, row_cnt, tiles_v, tiles_b,
            tiles_cnt, xv, xc, *, mode, tile, identity):
    if tile not in KERNEL_TILES:
        raise ValueError(f"the CUDA combine kernel is built for tile sizes "
                         f"{KERNEL_TILES}, not {tile}")
    need_v, need_b = mode in ("add", "add_b"), mode != "add"
    if (need_v and tiles_v is None) or (need_b and tiles_b is None):
        raise ValueError(f"mode {mode!r} needs "
                         f"{'tiles_v' if need_v else ''} "
                         f"{'tiles_b' if need_b else ''}".strip())
    tiles_v = tiles_v if need_v else None
    tiles_b = tiles_b if need_b else None
    q_cnt, n_rows = row_cnt.shape
    n_slots = tile_idx.shape[1]
    n_src = xv.shape[1]
    dev = row_cnt.device
    shapes = {"row_ptr": (row_ptr, torch.int32, (q_cnt, n_rows + 1)),
              "tile_idx": (tile_idx, torch.int32, (q_cnt, n_slots)),
              "tile_col": (tile_col, torch.int32, (q_cnt, n_slots)),
              "row_cnt": (row_cnt, torch.int32, (q_cnt, n_rows)),
              "tiles_cnt": (tiles_cnt, torch.float32,
                            (q_cnt, n_slots, tile, tile)),
              "xv": (xv, torch.float32, (q_cnt, n_src)),
              "xc": (xc, torch.float32, (q_cnt, n_src))}
    for name, tv in (("tiles_v", tiles_v), ("tiles_b", tiles_b)):
        if tv is not None:
            shapes[name] = (tv, torch.float32, (q_cnt, n_slots, tile, tile))
    for name, (x, dtype, shape) in shapes.items():
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous and 8-byte aligned")
    if n_src % tile:
        raise ValueError(f"source vector length {n_src} is not a multiple "
                         f"of the tile {tile}")
    val = torch.empty((q_cnt, n_rows * tile), dtype=torch.float32,
                      device=dev)
    hascnt = torch.empty_like(val)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _library()
    with torch.cuda.device(dev):
        row_end, unit_row, unit_slot = combine_units(
            row_cnt, n_slots, lib.block_csr_combine_unit_slots())
        n_units = unit_row.numel() - 1
        part_val, part_cnt = _scratch(mode, n_units, tile, 1, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.block_csr_combine_launch(
            MODES.index(mode), tile, q_cnt, n_rows, n_slots, n_src, n_units,
            float(identity), ptr(row_ptr), ptr(tile_idx), ptr(tile_col),
            ptr(row_end), ptr(unit_row), ptr(unit_slot), ptr(tiles_v),
            ptr(tiles_b), ptr(tiles_cnt), ptr(xv), ptr(xc), val.data_ptr(),
            hascnt.data_ptr(), ptr(part_val), ptr(part_cnt), stream)
    if code != 0:
        msg = lib.block_csr_combine_error_string(code).decode()
        raise RuntimeError(f"block_csr_combine launch failed: {msg} "
                           f"(cudaError {code})")
    block_csr_combine.launches += 1
    return val, hascnt


def _scratch(mode, n_units, tile, width, dev):
    """The partials of rows that span units: [2, n_units, T, width], double
    for the add modes, float32 for min/max and the counts."""
    shape = (2, n_units, tile, width)
    dtype = torch.float64 if mode in ("add", "add_b") else torch.float32
    return (torch.empty(shape, dtype=dtype, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev))


def block_csr_combine_ref(row_ptr, tile_idx, tile_col, row_cnt,
                          tiles_v, tiles_b, tiles_cnt, xv, xc, *,
                          mode: str, tile: int, identity: float = 0.0):
    """Plain PyTorch version of :func:`block_csr_combine` (same arguments,
    same result, any tile size, any device).

    Expands the live slots of every (q, row) into a flat list, gathers
    their tiles and vector blocks, and folds them into the rows:
    ``index_add_`` of the tile-vector products (accumulated in float64, as
    the kernel does, so the float32 result does not depend on the order)
    for add/add_b, ``scatter_reduce_`` of the float32 row extrema of
    ``B + xv`` for min/max.  Works through the live slots in steps of
    ``_REF_CHUNK`` tiles to bound its scratch memory."""
    if mode not in MODES:
        raise ValueError(f"unknown combine mode {mode!r}")
    t = tile
    q_cnt, n_rows = row_cnt.shape
    n_slots = tile_idx.shape[1]
    dev = row_cnt.device
    extremum = mode in ("min", "max")
    acc = torch.float32 if extremum else torch.float64
    val = torch.full((q_cnt * n_rows, t), float(identity), dtype=acc,
                     device=dev)
    hascnt = torch.zeros((q_cnt * n_rows, t), dtype=torch.float64,
                         device=dev)

    # one entry per live slot: its flat (q, row) and compacted position
    counts = row_cnt.reshape(-1).to(torch.int64)
    owner = torch.repeat_interleave(
        torch.arange(q_cnt * n_rows, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(owner.numel(), device=dev) - first[owner]
    q = owner // n_rows
    pos = row_ptr[:, :-1].reshape(-1).to(torch.int64)[owner] + j
    flat = lambda x, i: x.reshape(-1)[q * n_slots + i]
    slot = flat(tile_idx, pos).to(torch.int64)
    col = flat(tile_col, pos).to(torch.int64)

    n_src = xv.shape[1]
    lanes = torch.arange(t, device=dev)
    for lo in range(0, owner.numel(), _REF_CHUNK):
        sl = slice(lo, lo + _REF_CHUNK)
        tid = q[sl] * n_slots + slot[sl]
        xi = (q[sl] * n_src + col[sl] * t)[:, None] + lanes     # [L, T]
        xvb, xcb = xv.reshape(-1)[xi], xc.reshape(-1)[xi]
        tile_of = lambda x: x.reshape(-1, t, t)[tid]             # [L, T, T]
        hascnt.index_add_(0, owner[sl], torch.bmm(
            tile_of(tiles_cnt).double(), xcb.double()[:, :, None])[..., 0])
        if extremum:
            red = torch.amin if mode == "min" else torch.amax
            rows = red(tile_of(tiles_b) + xvb[:, None, :], dim=2)
            val.scatter_reduce_(0, owner[sl, None].expand(-1, t), rows,
                                reduce="amin" if mode == "min" else "amax")
        else:
            contrib = torch.bmm(tile_of(tiles_v).double(),
                                xvb.double()[:, :, None])[..., 0]
            if mode == "add_b":
                contrib += torch.bmm(tile_of(tiles_b).double(),
                                     xcb.double()[:, :, None])[..., 0]
            val.index_add_(0, owner[sl], contrib)
    val = val.to(torch.float32).reshape(q_cnt, n_rows * t)
    hascnt = hascnt.to(torch.float32).reshape(q_cnt, n_rows * t)
    return val, hascnt


# ---------------------------------------------------------------------------
# The multi-query panel combine: wrapper, CUDA launch, plain version
# ---------------------------------------------------------------------------

MQ_WIDTHS = (1, 2, 4, 8, 16)     # column counts the CUDA kernel is built for


def block_csr_combine_mq(row_ptr, tile_idx, tile_col, row_cnt,
                         tiles_v, tiles_b, tiles_cnt, xv, xc, *,
                         mode: str, tile: int, identity: float = 0.0):
    """:func:`block_csr_combine` over Q-column value panels.

    Same structure and tile arguments (leading destination axis D); ``xv``
    / ``xc`` are [D, C*T, Q] panels — one slot-transformed message column
    and one presence column per query — and the outputs are [D, R*T, Q]
    panels.  Each column equals a solo :func:`block_csr_combine` call on
    that column bit for bit.  CPU tensors run
    :func:`block_csr_combine_mq_ref`; CUDA tensors launch the split once
    and the combine kernel and its fixup per group of at most 16 columns
    (each group counted once in ``block_csr_combine_mq.launches``) or
    raise."""
    if mode not in MODES:
        raise ValueError(f"unknown combine mode {mode!r}")
    kind = row_cnt.device.type
    if kind == "cpu":
        return block_csr_combine_mq_ref(
            row_ptr, tile_idx, tile_col, row_cnt, tiles_v, tiles_b,
            tiles_cnt, xv, xc, mode=mode, tile=tile, identity=identity)
    if kind != "cuda":
        raise ValueError(
            f"block_csr_combine_mq runs on cpu or cuda, not {kind}")
    return _launch_mq(row_ptr, tile_idx, tile_col, row_cnt, tiles_v,
                      tiles_b, tiles_cnt, xv, xc, mode=mode, tile=tile,
                      identity=identity)


block_csr_combine_mq.launches = 0


def mq_layout(n_queries: int):
    """(group width, padded column count) of a Q-column panel: Q up to 16
    pads to the next kernel width and runs in one launch; more runs in
    groups of 16."""
    if n_queries < 1:
        raise ValueError(f"a panel needs at least one column, got "
                         f"{n_queries}")
    width = next(w for w in MQ_WIDTHS if w >= min(n_queries, MQ_WIDTHS[-1]))
    return width, -(-n_queries // width) * width


def _launch_mq(row_ptr, tile_idx, tile_col, row_cnt, tiles_v, tiles_b,
               tiles_cnt, xv, xc, *, mode, tile, identity):
    if tile not in KERNEL_TILES:
        raise ValueError(f"the CUDA combine kernel is built for tile sizes "
                         f"{KERNEL_TILES}, not {tile}")
    need_v, need_b = mode in ("add", "add_b"), mode != "add"
    if (need_v and tiles_v is None) or (need_b and tiles_b is None):
        raise ValueError(f"mode {mode!r} needs "
                         f"{'tiles_v' if need_v else ''} "
                         f"{'tiles_b' if need_b else ''}".strip())
    tiles_v = tiles_v if need_v else None
    tiles_b = tiles_b if need_b else None
    if xv.dim() != 3 or xv.shape != xc.shape:
        raise ValueError(f"xv / xc must be [D, C*T, Q] panels of one shape, "
                         f"got {tuple(xv.shape)} and {tuple(xc.shape)}")
    q_cnt, n_rows = row_cnt.shape
    n_slots = tile_idx.shape[1]
    n_src, n_cols = xv.shape[1], xv.shape[2]
    width, padded = mq_layout(n_cols)
    if padded != n_cols:
        # dead columns: identity values, no presence; cut off below
        pad = (0, padded - n_cols)
        xv = torch.nn.functional.pad(xv, pad, value=float(identity))
        xc = torch.nn.functional.pad(xc, pad)
    dev = row_cnt.device
    align = 16 if width >= 4 else 8     # float4 / float2 panel loads
    shapes = {"row_ptr": (row_ptr, torch.int32, (q_cnt, n_rows + 1), 4),
              "tile_idx": (tile_idx, torch.int32, (q_cnt, n_slots), 4),
              "tile_col": (tile_col, torch.int32, (q_cnt, n_slots), 4),
              "row_cnt": (row_cnt, torch.int32, (q_cnt, n_rows), 4),
              "tiles_cnt": (tiles_cnt, torch.float32,
                            (q_cnt, n_slots, tile, tile), 8),
              "xv": (xv, torch.float32, (q_cnt, n_src, padded), align),
              "xc": (xc, torch.float32, (q_cnt, n_src, padded), align)}
    for name, tv in (("tiles_v", tiles_v), ("tiles_b", tiles_b)):
        if tv is not None:
            shapes[name] = (tv, torch.float32,
                            (q_cnt, n_slots, tile, tile), 8)
    for name, (x, dtype, shape, nbytes) in shapes.items():
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % nbytes:
            raise ValueError(f"{name} must be contiguous and {nbytes}-byte "
                             "aligned")
    if n_src % tile:
        raise ValueError(f"source panel height {n_src} is not a multiple "
                         f"of the tile {tile}")
    val = torch.empty((q_cnt, n_rows * tile, padded), dtype=torch.float32,
                      device=dev)
    hascnt = torch.empty_like(val)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _library()
    with torch.cuda.device(dev):
        # one split and one scratch for every group: the split depends on
        # row_cnt alone, and the groups run in stream order
        row_end, unit_row, unit_slot = combine_units(
            row_cnt, n_slots, lib.block_csr_combine_unit_slots())
        n_units = unit_row.numel() - 1
        part_val, part_cnt = _scratch(mode, n_units, tile, width, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for col0 in range(0, padded, width):
            code = lib.block_csr_combine_mq_launch(
                MODES.index(mode), tile, width, q_cnt, n_rows, n_slots,
                n_src, n_units, padded, col0, float(identity), ptr(row_ptr),
                ptr(tile_idx), ptr(tile_col), ptr(row_end), ptr(unit_row),
                ptr(unit_slot), ptr(tiles_v), ptr(tiles_b), ptr(tiles_cnt),
                ptr(xv), ptr(xc), val.data_ptr(), hascnt.data_ptr(),
                ptr(part_val), ptr(part_cnt), stream)
            if code != 0:
                msg = lib.block_csr_combine_error_string(code).decode()
                raise RuntimeError(f"block_csr_combine_mq launch failed: "
                                   f"{msg} (cudaError {code})")
            block_csr_combine_mq.launches += 1
    if padded != n_cols:
        val = val[..., :n_cols].contiguous()
        hascnt = hascnt[..., :n_cols].contiguous()
    return val, hascnt


def block_csr_combine_mq_ref(row_ptr, tile_idx, tile_col, row_cnt,
                             tiles_v, tiles_b, tiles_cnt, xv, xc, *,
                             mode: str, tile: int, identity: float = 0.0):
    """Plain PyTorch version of :func:`block_csr_combine_mq`: the solo
    plain version :func:`block_csr_combine_ref` on each column, stacked
    (same arguments, same result, any device)."""
    cols = [block_csr_combine_ref(
        row_ptr, tile_idx, tile_col, row_cnt, tiles_v, tiles_b, tiles_cnt,
        xv[..., j].contiguous(), xc[..., j].contiguous(), mode=mode,
        tile=tile, identity=identity) for j in range(xv.shape[-1])]
    return (torch.stack([v for v, _ in cols], dim=-1),
            torch.stack([h for _, h in cols], dim=-1))


# ---------------------------------------------------------------------------
# Host-side structure builders
# ---------------------------------------------------------------------------

def build_tile_struct(row_blk: torch.Tensor, col_blk: torch.Tensor,
                      n_row_blocks: int, n_col_blocks: int):
    """Edge block coordinates -> ragged tile structure sorted by (row, col),
    built on the device the coordinates lie on.

    Returns (slot_row [S] i32, slot_col [S] i32, row_ptr [R+1] i32,
    edge_slot [E] i32 — which slot each edge's cell belongs to), tensors
    beside the inputs.  ``torch.unique`` sorts as the reference's
    ``np.unique`` does, so the structures are equal to its."""
    key = row_blk.long() * n_col_blocks + col_blk.long()
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    slot_row = (uniq // n_col_blocks).to(torch.int32)
    counts = torch.bincount(slot_row, minlength=n_row_blocks)
    row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return (slot_row, (uniq % n_col_blocks).to(torch.int32),
            row_ptr.to(torch.int32), inv.to(torch.int32))


def build_tile_struct_np(row_blk: np.ndarray, col_blk: np.ndarray,
                         n_row_blocks: int, n_col_blocks: int, device=None):
    """:func:`build_tile_struct` for numpy coordinates: built on
    ``device`` (the CPU by default), returned as numpy arrays."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return tuple(x.cpu().numpy() for x in build_tile_struct(
        t(row_blk), t(col_blk), n_row_blocks, n_col_blocks))


def compact_live_tiles(slot_row: np.ndarray, slot_col: np.ndarray,
                       row_ptr: np.ndarray, live: np.ndarray,
                       n_rows: int):
    """Host-side mirror of the engine's runtime live-tile compaction.

    Packs live slots to the front of their row's slot range (the layout
    ``block_csr_combine`` expects): returns (tile_idx [S], tile_col [S],
    row_cnt [R]) with dead positions zeroed."""
    s = slot_row.shape[0]
    row_cnt = np.bincount(slot_row[live], minlength=n_rows).astype(np.int32)
    cnt_cum = np.concatenate([[0], np.cumsum(row_cnt)]).astype(np.int64)
    rank = np.cumsum(live) - live            # exclusive rank among live
    dest = np.where(live, row_ptr[slot_row] + (rank - cnt_cum[slot_row]), s)
    tile_idx = np.zeros((s,), np.int32)
    tile_col = np.zeros((s,), np.int32)
    keep = dest < s
    tile_idx[dest[keep]] = np.arange(s, dtype=np.int32)[keep]
    tile_col[dest[keep]] = slot_col[keep]
    return tile_idx, tile_col, row_cnt


def build_block_csr(src, dst, data, num_vertices: int, tile: int):
    """Host-side: edge list -> padded block-CSR (numpy).

    Returns dict(tiles [n, T, T] f32, tile_col [n] i32,
    row_ptr [n_rows+1] i32, n_rows, n_cols, max_tiles_per_row)."""
    t = tile
    n_blocks = -(-num_vertices // t)
    slot_row, slot_col, rp, edge_slot = build_tile_struct_np(
        np.asarray(dst) // t, np.asarray(src) // t, n_blocks, n_blocks)
    max_tiles = max(1, int((rp[1:] - rp[:-1]).max()) if n_blocks else 1)

    tiles = np.zeros((n_blocks * max_tiles, t, t), np.float32)
    tile_col = np.zeros((n_blocks * max_tiles,), np.int32)
    row_ptr = np.arange(0, n_blocks * max_tiles + 1, max_tiles,
                        dtype=np.int32)
    # rectangular re-layout: slot i of row r -> padded slot r*max_tiles + i
    padded_slot = (slot_row.astype(np.int64) * max_tiles
                   + (np.arange(slot_row.shape[0]) - rp[slot_row]))
    tile_col[padded_slot] = slot_col
    np.add.at(tiles,
              (padded_slot[edge_slot],
               np.asarray(dst) % t, np.asarray(src) % t),
              np.asarray(data, np.float32))
    return dict(tiles=tiles, tile_col=tile_col, row_ptr=row_ptr,
                n_rows=n_blocks, n_cols=n_blocks,
                max_tiles_per_row=max_tiles)
