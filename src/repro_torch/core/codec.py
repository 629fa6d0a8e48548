"""Vectorized delta/varint codecs for the compression tier — the port's
copy of ``repro.core.codec`` (DESIGN.md §9).

One byte-exact codec family shared by the storage layer (delta-varint DCSR
pair streams, pruned-CSR dst residue streams) and the wire layer
(delta-varint message index streams).  Everything here is plain integer
arithmetic, so encode -> decode round-trips are bit-exact, and the *size*
functions are the byte model: the analytic counters and the physical
encoders both call :func:`varint_sizes` on the same delta arrays, which is
what keeps ``measured == modeled`` true by construction with compression
enabled.  The numpy functions are copied verbatim so a stream written by
either package is byte-identical; the ``xp=torch`` paths replace the
reference's ``xp=jnp`` paths (``torch.cummax`` for ``jax.lax.cummax``).

The varint is LEB128-style: little-endian 7-bit groups, high bit set on
every byte except the last.
"""
from __future__ import annotations

import numpy as np
import torch

_MAX_GROUPS = 10        # ceil(64 / 7): a uint64 needs at most 10 groups


# ---------------------------------------------------------------------------
# Core varint codec (vectorized)
# ---------------------------------------------------------------------------

def varint_sizes(values, xp=np):
    """Encoded byte length per value: ``1 + #{k >= 1 : v >= 2**(7k)}``.

    Works on numpy (full uint64 domain, exact integer comparisons) and
    torch (int32 domain — the width of every gap / residue the engine
    prices) via ``xp``; this is THE size model — :func:`varint_encode`
    emits exactly these many bytes per value."""
    if xp is np:
        v = np.asarray(values).astype(np.uint64)
        nb = np.ones(v.shape, np.int64)
        for k in range(1, _MAX_GROUPS):
            nb = nb + (v >= np.uint64(1 << (7 * k)))
        return nb
    v = torch.as_tensor(values)
    nb = torch.ones_like(v, dtype=torch.int32)
    for k in range(1, 5):        # int32 values < 2**31 need <= 5 groups
        nb = nb + (v >= (1 << (7 * k))).to(torch.int32)
    return nb


def varint_encode(values: np.ndarray) -> np.ndarray:
    """LEB128-encode a non-negative integer array -> uint8 byte stream."""
    v = np.ascontiguousarray(values, np.uint64)
    if v.size == 0:
        return np.zeros(0, np.uint8)
    nb = varint_sizes(v)
    pos = np.concatenate([[0], np.cumsum(nb[:-1])])
    out = np.zeros(int(nb.sum()), np.uint8)
    for j in range(int(nb.max())):
        sel = nb > j
        group = ((v[sel] >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(
            np.uint8)
        cont = (nb[sel] > j + 1).astype(np.uint8) << 7
        out[pos[sel] + j] = group | cont
    return out


def varint_decode(buf, count: int) -> np.ndarray:
    """Inverse of :func:`varint_encode`: uint8 stream -> uint64[count].

    ``buf`` may be bytes or a uint8 array and must contain exactly
    ``count`` terminated varints (raises ValueError otherwise — a
    truncated or trailing-garbage stream is a corrupt chunk)."""
    b = np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes, bytearray,
                                                         memoryview)) else \
        np.asarray(buf, np.uint8)
    if count == 0:
        if b.size:
            raise ValueError(f"varint stream has {b.size} trailing bytes "
                             "after 0 values")
        return np.zeros(0, np.uint64)
    ends = np.flatnonzero((b & 0x80) == 0)
    if ends.size != count or (ends.size and ends[-1] != b.size - 1):
        raise ValueError(
            f"varint stream is corrupt: {ends.size} terminated values in "
            f"{b.size} bytes, expected {count}")
    starts = np.concatenate([[0], ends[:-1] + 1])
    nb = ends - starts + 1
    out = np.zeros(count, np.uint64)
    for j in range(int(nb.max())):
        sel = nb > j
        out[sel] |= (b[starts[sel] + j] & np.uint64(0x7F)).astype(
            np.uint64) << np.uint64(7 * j)
    return out


# ---------------------------------------------------------------------------
# DCSR pair streams: delta over the sorted (src, idx) runs
# ---------------------------------------------------------------------------

def pair_delta_values(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(src, idx) DCSR pairs -> interleaved non-negative delta stream.

    ``src`` is strictly increasing (one entry per nonzero-degree source)
    and ``idx`` (run start offsets, chunk-relative) strictly increasing
    with ``idx[0] == 0``; both are delta-encoded against a 0 base and
    interleaved ``[ds0, di0, ds1, di1, ...]`` so one varint stream holds
    the whole pair section."""
    s = np.asarray(src, np.int64)
    i = np.asarray(idx, np.int64)
    out = np.empty(2 * s.size, np.int64)
    out[0::2] = np.diff(s, prepend=0)
    out[1::2] = np.diff(i, prepend=0)
    return out.astype(np.uint64)


def pair_delta_restore(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`pair_delta_values` -> (src int32, idx int32)."""
    v = np.asarray(vals, np.int64)
    return (np.cumsum(v[0::2]).astype(np.int32),
            np.cumsum(v[1::2]).astype(np.int32))


# ---------------------------------------------------------------------------
# Pruned-CSR dst residues: per-run delta against the batch base
# ---------------------------------------------------------------------------

def dst_delta_values(dst: np.ndarray, starts: np.ndarray, base: int
                     ) -> np.ndarray:
    """dst column of one chunk -> non-negative residue stream.

    Within each source run (``starts`` = chunk-relative run start offsets)
    the dst ids are non-decreasing, and every dst lies in the chunk's
    destination batch (``dst >= base``); the residue is the delta to the
    previous edge's dst, restarting at ``dst - base`` on each run
    boundary.  The run boundaries are *not* stored — they are derivable
    from whichever index section (DCSR pairs or CSR idx) a read chose,
    which is what prunes the 4 B/edge dst column down to its residues."""
    d = np.asarray(dst, np.int64)
    if d.size == 0:
        return np.zeros(0, np.uint64)
    res = np.empty(d.size, np.int64)
    res[0] = 0                       # position 0 is always a run start
    res[1:] = d[1:] - d[:-1]
    res[np.asarray(starts, np.int64)] = d[np.asarray(starts, np.int64)] - base
    return res.astype(np.uint64)


def dst_delta_restore(res: np.ndarray, starts: np.ndarray,
                      runs: np.ndarray, base: int) -> np.ndarray:
    """Inverse of :func:`dst_delta_values` given the run structure
    (``starts`` offsets + ``runs`` lengths) -> dst int32[E]."""
    r = np.asarray(res, np.int64)
    if r.size == 0:
        return np.zeros(0, np.int32)
    st = np.asarray(starts, np.int64)
    csum = np.cumsum(r)
    before = csum[st] - r[st]        # sum of residues before each run
    return (base + csum - np.repeat(before, np.asarray(runs, np.int64))
            ).astype(np.int32)


# ---------------------------------------------------------------------------
# Wire index streams: gap bytes of a delta-varint-encoded presence mask
# ---------------------------------------------------------------------------

def mask_gap_bytes(mask, xp=np):
    """[..., V] presence mask -> [...] bytes of its delta-varint index
    stream (the FMT_VPAIRS wire encoding's index section).

    The stream encodes, per set position, the gap to the previous set
    position (base -1, so every gap is >= 1); this function sums the
    varint sizes of those gaps without materializing the stream, so the
    LOCAL network counters can price the same encoding the dist_ooc wire
    physically emits.  Host (numpy) callers sum in float64 — exact against
    the integer byte counts the encoder measures; the torch path keeps the
    counters' float32."""
    v = mask.shape[-1]
    if xp is np:
        idx = np.arange(v, dtype=np.int32)
        filled = np.where(mask, idx, np.int32(-1))
        run = np.maximum.accumulate(filled, axis=-1)
        prev = np.concatenate(
            [np.full(mask.shape[:-1] + (1,), -1, np.int32), run[..., :-1]],
            axis=-1)
        # Gaps are int32, so at most 5 varint groups: the four int32
        # comparisons of the torch path give varint_sizes's values without
        # its uint64 pass over all ten groups (the OOC executor prices
        # [P, P, V] masks here every iteration).
        gap = idx - prev
        nb = (1 + (gap >= 1 << 7).astype(np.int8) + (gap >= 1 << 14)
              + (gap >= 1 << 21) + (gap >= 1 << 28))
        return np.sum(np.where(mask, nb, 0), axis=-1, dtype=np.float64)
    idx = torch.arange(v, dtype=torch.int32, device=mask.device)
    filled = torch.where(mask, idx, torch.full_like(idx, -1))
    run = torch.cummax(filled, dim=-1).values
    prev = torch.cat(
        [torch.full(mask.shape[:-1] + (1,), -1, dtype=torch.int32,
                    device=mask.device), run[..., :-1]], dim=-1)
    nb = varint_sizes(idx - prev, xp=torch)
    return torch.sum(torch.where(mask, nb, 0).to(torch.float32), dim=-1)
