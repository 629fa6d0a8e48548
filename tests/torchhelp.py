"""Shared helpers for the ``tests/test_torch_*.py`` parity suites: one small
weighted RMAT problem built by the JAX package and carried into the port
through :mod:`repro_torch.interop`, so both packages run on identical
structures."""
import dataclasses

import numpy as np
import torch

GRAPH = dict(scale=7, edge_factor=8, seed=3, weighted=True)
SPEC = dict(num_partitions=4, batch_size=16)


def jax_fields(obj) -> dict:
    """A reference dataclass (DistGraph / ChunkFormats / BlockTiles) as the
    plain mapping :mod:`repro_torch.interop` takes: numpy arrays for the
    array fields, Python values for the static ones."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = dataclasses.asdict(v)
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def port_fields(obj) -> dict:
    """The port's structure as numpy arrays / Python values."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = dataclasses.asdict(v)
        elif hasattr(v, "cpu"):
            out[f.name] = v.cpu().numpy()
        else:
            out[f.name] = v
    return out


def assert_same_fields(ref: dict, port: dict):
    """Every array bit-equal (same dtype and shape), every static equal."""
    assert ref.keys() == port.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert port[k].dtype == v.dtype, (k, port[k].dtype, v.dtype)
            assert port[k].shape == v.shape, (k, port[k].shape, v.shape)
            assert np.array_equal(port[k], v), k
        else:
            assert port[k] == v, (k, port[k], v)


# ---------------------------------------------------------------------------
# Combine layouts with chosen row lengths, and the kernel's unit split
# emulated in plain torch
# ---------------------------------------------------------------------------

F32_MAX = float(np.finfo(np.float32).max)


def row_lengths(kind, unit_slots, n_dest=2, n_rows=48, seed=0):
    """Live tiles per row [n_dest, n_rows] of a named layout:
    ``hub`` — one row per destination holds a quarter of its tiles, the
    other tiles spread over runs of rows between runs of empty rows;
    ``edges`` — rows of K - 1, K, K + 1, 1 and 0 tiles (K = unit_slots)
    and a row spanning several units; ``single`` — one tile in the whole
    call; ``empty`` — no live tile; ``random`` — lengths 0..3K with many
    zeros."""
    rng = np.random.default_rng(seed)
    k = unit_slots
    if kind == "hub":
        cnt = np.zeros((n_dest, n_rows), np.int64)
        run = max(1, n_rows // 8)
        full = (np.arange(n_rows) // run) % 2 == 0      # alternate runs
        for q in range(n_dest):
            cnt[q, full] = rng.integers(1, 2 * k, full.sum())
            hub = rng.integers(0, n_rows)
            cnt[q, hub] = cnt[q].sum() // 3             # a quarter after
        return cnt.astype(np.int32)
    if kind == "edges":
        pattern = [k - 1, k, k + 1, 1, 0, 0, k + 1, k - 1, 3 * k + 2, k]
        row = np.resize(np.array(pattern), n_rows)
        return np.stack([np.roll(row, q) for q in range(n_dest)]).astype(
            np.int32)
    if kind == "single":
        cnt = np.zeros((n_dest, n_rows), np.int32)
        cnt[n_dest - 1, n_rows // 2] = 1
        return cnt
    if kind == "empty":
        return np.zeros((n_dest, n_rows), np.int32)
    if kind == "random":
        cnt = rng.integers(0, 3 * k + 1, (n_dest, n_rows))
        cnt[rng.random((n_dest, n_rows)) < 0.4] = 0
        return cnt.astype(np.int32)
    raise ValueError(kind)


def combine_layout(row_cnt, mode, *, nq=None, seed=0, n_src_blocks=24,
                   spare=2):
    """Inputs of one combine call whose rows hold ``row_cnt`` [Q, R] live
    tiles, each row followed by ``spare`` dead slots, live tiles scattered
    over the slot arrays (``tile_idx`` a random permutation), ~10% of
    tile cells holding an edge.  ``nq`` columns make panel inputs.  Returns
    (the nine numpy arguments, identity)."""
    rng = np.random.default_rng(seed)
    t = 8
    row_cnt = np.asarray(row_cnt, np.int32)
    q_cnt, n_rows = row_cnt.shape
    row_ptr = np.zeros((q_cnt, n_rows + 1), np.int32)
    row_ptr[:, 1:] = np.cumsum(row_cnt + spare, axis=1)
    n_slots = int(row_ptr[:, -1].max())
    tile_idx = np.zeros((q_cnt, n_slots), np.int32)
    tile_col = np.zeros((q_cnt, n_slots), np.int32)
    for q in range(q_cnt):
        pos = np.concatenate([row_ptr[q, r] + np.arange(row_cnt[q, r])
                              for r in range(n_rows)]).astype(np.int64)
        tile_idx[q, pos] = rng.permutation(n_slots)[:pos.size]
        tile_col[q, pos] = rng.integers(0, n_src_blocks, pos.size)
    shape = (q_cnt, n_slots, t, t)
    edge = rng.random(shape) < 0.1
    tc = np.where(edge, rng.integers(1, 3, shape), 0).astype(np.float32)
    ident = {"min": F32_MAX, "max": -F32_MAX}.get(mode, 0.0)
    tv = tb = None
    if mode in ("add", "add_b"):
        tv = np.where(edge, rng.random(shape), 0).astype(np.float32)
    if mode != "add":
        tb = np.where(edge, rng.random(shape), ident).astype(np.float32)
    vec = (q_cnt, n_src_blocks * t) + (() if nq is None else (nq,))
    mask = rng.random(vec) < 0.5
    xv = np.where(mask, rng.standard_normal(vec), ident).astype(np.float32)
    xc = mask.astype(np.float32)
    return (row_ptr, tile_idx, tile_col, row_cnt, tv, tb, tc, xv, xc), ident


def emulate_units(args, *, mode, tile, identity, unit_slots):
    """The CUDA kernel's split of a combine call, in plain torch: each unit
    of :func:`combine_units` folds the slots of each row it touches; rows
    it covers whole are written, the others leave a head (the row's end)
    or tail (the row runs on) partial, and the fixup folds each spanning
    row's tails in unit order, then its head.  Asserts that every row is
    written exactly once and that the tails of a row come from consecutive
    units ending just before the head's.  Panels run column by column on
    the one split.  Returns (val, hascnt) as the wrappers do."""
    import torch
    from repro_torch.kernels.csr_spmv import combine_units
    row_ptr, tile_idx, tile_col, row_cnt, tv, tb, tc, xv, xc = args
    if xv.dim() == 3:
        cols = []
        for j in range(xv.shape[2]):
            solo = list(args)
            solo[7], solo[8] = xv[..., j], xc[..., j]
            cols.append(emulate_units(tuple(solo), mode=mode, tile=tile,
                                      identity=identity,
                                      unit_slots=unit_slots))
        return (torch.stack([v for v, _ in cols], -1),
                torch.stack([h for _, h in cols], -1))
    t = tile
    q_cnt, n_rows = row_cnt.shape
    n_slots, n_src = tile_idx.shape[1], xv.shape[1]
    n_flat = q_cnt * n_rows
    extremum = mode in ("min", "max")
    row_end, unit_row, unit_slot = (
        x.long() for x in combine_units(row_cnt, n_slots, unit_slots))
    counts = row_cnt.reshape(-1).long()
    row_start = row_end - counts
    # each live slot's contribution to its row, in path order
    owner = torch.repeat_interleave(torch.arange(n_flat), counts)
    q = owner // n_rows
    pos = (row_ptr[:, :-1].reshape(-1).long()[owner]
           + torch.arange(owner.numel()) - row_start[owner])
    tid = q * n_slots + tile_idx.reshape(-1)[q * n_slots + pos].long()
    col = tile_col.reshape(-1)[q * n_slots + pos].long()
    xi = (q * n_src + col * t)[:, None] + torch.arange(t)
    tile_of = lambda x: x.reshape(-1, t, t)[tid].double()
    xvb, xcb = xv.reshape(-1)[xi], xc.reshape(-1)[xi]
    cnt_c = torch.bmm(tile_of(tc), xcb.double()[:, :, None])[..., 0]
    if extremum:
        red = torch.amin if mode == "min" else torch.amax
        val_c = red(tb.reshape(-1, t, t)[tid] + xvb[:, None, :], dim=2)
    else:
        val_c = torch.bmm(tile_of(tv), xvb.double()[:, :, None])[..., 0]
        if mode == "add_b":
            val_c += torch.bmm(tile_of(tb), xcb.double()[:, :, None])[..., 0]
    start = (torch.full((t,), identity, dtype=torch.float32) if extremum
             else torch.zeros(t, dtype=torch.float64))

    def fold(a, b):
        if not extremum:
            return a + b
        return torch.minimum(a, b) if mode == "min" else torch.maximum(a, b)

    def segment(lo, hi):
        v, c = start.clone(), torch.zeros(t, dtype=torch.float64)
        for s in range(lo, hi):
            v, c = fold(v, val_c[s]), c + cnt_c[s]
        return v, c

    val = torch.empty((n_flat, t), dtype=torch.float32)
    hascnt = torch.empty((n_flat, t), dtype=torch.float32)
    written = np.zeros(n_flat, np.int64)

    def write(f, v, c):
        val[f] = v if extremum else (identity + v).float()
        hascnt[f] = c.float()
        written[f] += 1

    heads, tails = {}, {}
    n_units = unit_row.numel() - 1
    for u in range(n_units):
        f0, f1 = int(unit_row[u]), int(unit_row[u + 1])
        s0, s1 = int(unit_slot[u]), int(unit_slot[u + 1])
        for f in range(f0, min(f1, n_flat - 1) + 1):
            rs, re = int(row_start[f]), int(row_end[f])
            part = segment(max(rs, s0), min(re, s1))
            if f < f1 and rs >= s0:
                write(f, *part)
            elif f < f1:
                heads[u] = (f, part)
            else:
                tails[u] = (f, part)
    for u, (f, (v, c)) in heads.items():
        mine = [w for w in sorted(tails) if tails[w][0] == f]
        assert mine == list(range(u - len(mine), u)), (u, f, mine)
        acc_v, acc_c = start.clone(), torch.zeros(t, dtype=torch.float64)
        for w in mine:
            acc_v = fold(acc_v, tails[w][1][0])
            acc_c = acc_c + tails[w][1][1]
        write(f, fold(acc_v, v), acc_c + c)
    assert (written == 1).all(), np.nonzero(written != 1)
    return (val.reshape(q_cnt, n_rows * t), hascnt.reshape(q_cnt, n_rows * t))


# ---------------------------------------------------------------------------
# The tensor-core attention kernel's roundings, emulated in plain torch
# ---------------------------------------------------------------------------

def emulate_attention_roundings(q, k, v, *, causal, window, softcap, pv,
                                tanh="exact"):
    """Attention as the plain version computes it (float32 scores of the
    scaled q, softcap, -1e30 mask, float32 softmax), except for the
    roundings a tensor-core kernel may make: ``pv="split"`` multiplies V by
    P as two bf16 terms, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, the
    kernel's scheme; ``pv="bf16"`` by P rounded to bf16 once.  ``tanh=
    "exp_form"`` takes the softcap's tanh as ``1 - 2 / (2^(2y log2 e) + 1)``
    in float32, the kernel's form.  bf16 q, k, v [BH, S, D]; returns bf16."""
    import torch
    from repro_torch.kernels.ref import softcap_and_mask
    d = q.shape[-1]
    s = torch.bmm(q.float() * d ** -0.5, k.float().transpose(1, 2))
    if softcap and tanh == "exp_form":
        e = torch.exp2(s * (2 * 1.4426950408889634 / softcap))
        s = softcap * (1 - 2 / (e + 1))
        s = softcap_and_mask(s, 0, causal=causal, window=window, softcap=0.0)
    else:
        s = softcap_and_mask(s, 0, causal=causal, window=window,
                             softcap=softcap)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    vf = v.float()
    hi = p.bfloat16().float()
    o = torch.bmm(hi, vf)
    if pv == "split":
        o = o + torch.bmm((p - hi).bfloat16().float(), vf)
    elif pv != "bf16":
        raise ValueError(f"pv is 'split' or 'bf16', not {pv!r}")
    return (o / p.sum(-1, keepdim=True)).bfloat16()


def emulate_spmv_packed(packed, x):
    """``csrc/block_csr_spmv.cu``'s walk over the packed form, lane by lane
    in plain Python: per row block, its live tiles 32 at a time (one per
    lane), each lane's first value from ``pvoff[r]`` plus the exclusive
    scan of the lanes' popcounts, its set bits in cell order, and the
    products summed in float64 per (lane, tile row), then over the lanes
    and rounded once.  Returns out [R*T] float32 (numpy), so a test can
    hold the kernel's offset arithmetic against the plain version."""
    t, n_rows = packed["tile"], packed["n_rows"]
    prow, pcol, pvoff = (packed[k].tolist() for k in ("prow", "pcol",
                                                      "pvoff"))
    masks = [[w & (2**64 - 1) for w in row]
             for row in packed["pmask"].tolist()]
    pval = packed["pval"].double().tolist()
    xs = np.asarray(x, np.float64)
    out = np.zeros(n_rows * t, np.float32)
    for r in range(n_rows):
        acc = np.zeros((32, t))
        voff = pvoff[r]
        for base in range(prow[r], prow[r + 1], 32):
            lanes = range(base, min(base + 32, prow[r + 1]))
            cnt = [sum(bin(w).count("1") for w in masks[i]) for i in lanes]
            first = np.cumsum([0] + cnt[:-1])
            for lane, i in enumerate(lanes):
                v = voff + int(first[lane])
                for k, word in enumerate(masks[i]):
                    for b in range(64):
                        if word >> b & 1:
                            c = 64 * k + b
                            acc[lane, c // t] += pval[v] * xs[
                                pcol[i] * t + c % t]
                            v += 1
            voff += sum(cnt)
        out[r * t:(r + 1) * t] = acc.sum(0)
    return out


def _lookback_prefixes(aggs, *, comb, first_of, rng):
    """The single-pass look-back of ``csrc/varint.cu`` and
    ``csrc/chunk_decode.cu`` in plain Python, with the blocks' progress
    interleaved at random: tiles take their index in order, in bursts, and
    publish their aggregate; a published tile (the newest or a random one)
    then looks back 32 predecessors at a time (each already published,
    some with only an aggregate; one before ``first_of[s]``, its segment's
    first tile, counts as an empty prefix), folds each window in order,
    older on the left, up to the nearest inclusive prefix, and publishes
    its own.  ``comb(a, b)`` is the carry of a then b, ``None`` the empty
    carry.  Returns each tile's exclusive prefix (None for a segment's
    first) and the largest number of windows one look-back read."""
    def fold(a, b):
        return b if a is None else a if b is None else comb(a, b)

    n_tiles = len(aggs)
    flag, value, prefix = [], [], [None] * n_tiles
    pending, started, windows = [], 0, 0
    while started < n_tiles or pending:
        # a burst of up to 80 tiles starts, then some published tiles
        # finish, newest first half the time, so runs of unfinished
        # predecessors build up
        for _ in range(min(n_tiles - started, int(rng.integers(0, 80)))):
            first = started == first_of[started]
            flag.append("P" if first else "A")
            value.append(aggs[started])
            if not first:
                pending.append(started)
            started += 1
        if not pending:
            continue
        s = pending.pop(-1 if rng.random() < 0.5
                        else rng.integers(len(pending)))
        exclusive, pred, reads = None, s - 1, 0
        while True:
            reads += 1
            window = [(flag[p], value[p]) if p >= first_of[s] else ("P", None)
                      for p in range(pred, pred - 32, -1)]
            stop = next((i for i, (f, _) in enumerate(window) if f == "P"),
                        31)
            w = None
            for _, v in window[:stop + 1]:
                w = fold(v, w)
            exclusive = fold(w, exclusive)
            if window[stop][0] == "P":
                break
            pred -= 32
        windows = max(windows, reads)
        prefix[s] = exclusive
        flag[s], value[s] = "P", fold(exclusive, aggs[s])
    return prefix, windows


def _wrap(x):
    return (x + 2**31) % 2**32 - 2**31


def emulate_lookback_scan(x, *, mode, tile, seed):
    """``csrc/varint.cu``'s single-pass scan (:func:`_lookback_prefixes`
    over tiles of ``tile`` elements).  Returns the inclusive scan (int32
    numpy) and the largest number of windows one look-back read."""
    rng = np.random.default_rng(seed)
    comb = ((lambda a, b: _wrap(a + b)) if mode == "add" else max)
    x = np.asarray(x, np.int64)
    n_tiles = -(-x.size // tile)
    aggs = []
    for s in range(n_tiles):
        a = 0
        for v in x[s * tile:(s + 1) * tile]:
            a = comb(a, int(v))
        aggs.append(a)
    prefix, windows = _lookback_prefixes(aggs, comb=comb,
                                         first_of=[0] * n_tiles, rng=rng)
    out = np.empty(x.size, np.int64)
    for s in range(n_tiles):
        acc = prefix[s] or 0
        for i in range(s * tile, min((s + 1) * tile, x.size)):
            acc = comb(acc, int(x[i]))
            out[i] = acc
    return out.astype(np.int32), windows


def _varint_ending_at(b, j):
    """The stencil's 5-tap select at byte ``j`` of section ``b``: the value
    of the varint ending there (bytes before the section are terminators),
    in uint32 arithmetic."""
    gpos = 4
    for d in range(4):
        if j - 1 - d < 0 or b[j - 1 - d] < 0x80:
            gpos = d
            break
    v = 0
    for d in range(gpos + 1):
        v += int(b[j - d] & 0x7F) << (7 * (gpos - d))
    return v & 0xFFFFFFFF


def emulate_segmented_decode(sections, *, tile, seed):
    """The first launch of ``csrc/chunk_decode.cu`` in plain Python.
    ``sections``: [(uint8 bytes, pairs flag)], laid one after another as
    the kernel's tiles are; each cut into tiles of ``tile`` bytes.  A tile
    decodes the varints ending in it (the 5-tap select reads back across
    its tile edge, never before its section) into a carry (varints, sum of
    the even-index values, sum of the odd-index values — one sum on a
    residue section), with the operator of the kernel: a carry after an
    odd count swaps where the later sums land.  The tiles' exclusive
    prefixes come from :func:`_lookback_prefixes`, segmented at each
    section's first tile.  Returns, per section, what its varints write:
    (srcs, starts) on a pair section, csum on a residue section (int32
    numpy), and the largest number of windows one look-back read."""
    rng = np.random.default_rng(seed)
    tiles, first_of = [], []
    for si, (b, _) in enumerate(sections):
        first = len(tiles)
        for lo in range(0, len(b), tile):
            tiles.append((si, lo, min(lo + tile, len(b))))
            first_of.append(first)

    def carries(si, lo, hi):
        b, pairs = sections[si]
        return [_varint_ending_at(b, j) for j in range(lo, hi)
                if b[j] < 0x80], pairs

    def comb_for(pairs):
        def comb(a, c):
            swap = pairs and a[0] % 2 == 1
            return (a[0] + c[0], _wrap(a[1] + (c[2] if swap else c[1])),
                    _wrap(a[2] + (c[1] if swap else c[2])))
        return comb

    aggs = []
    for si, lo, hi in tiles:
        vals, pairs = carries(si, lo, hi)
        acc = (0, 0, 0)
        for v in vals:
            acc = comb_for(pairs)(acc, (1, _wrap(v), 0))
        aggs.append((acc, pairs))
    # one operator for all tiles: a segment never mixes kinds
    comb = (lambda a, c: (comb_for(a[1])(a[0], c[0]), a[1]))
    prefix, windows = _lookback_prefixes(aggs, comb=comb, first_of=first_of,
                                         rng=rng)
    outs = [([], []) if pairs else [] for _, pairs in sections]
    for t, (si, lo, hi) in enumerate(tiles):
        vals, pairs = carries(si, lo, hi)
        c, e, o = prefix[t][0] if prefix[t] is not None else (0, 0, 0)
        for v in vals:
            if not pairs:
                e = _wrap(e + v)
                outs[si].append(e)
            elif c % 2 == 0:
                e = _wrap(e + v)
                outs[si][0].append(e)
            else:
                o = _wrap(o + v)
                outs[si][1].append(o)
            c += 1
    res = [(np.array(o[0], np.int32), np.array(o[1], np.int32)) if p
           else np.array(o, np.int32) for o, (_, p) in zip(outs, sections)]
    return res, windows


def _bf16_split(x, split):
    """x as bf16 hi and the bf16 rounding of what is left (0 when
    ``split`` is off), both back in float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if split
                else torch.zeros_like(x))


def _mm_split(a, b, split, b_exact=False):
    """a @ b as the tensor-core route takes it: float32 operands split into
    bf16 hi + lo, three products (hi.hi + hi.lo + lo.hi), or two where
    ``b`` is exact in bf16 (v), float32 sums."""
    ah, al = _bf16_split(a, split)
    if b_exact:
        return ah @ b + al @ b
    bh, bl = _bf16_split(b, split)
    return ah @ bh + ah @ bl + al @ bh


def emulate_gla_subchunks(q, k, v, w, u=None, *, chunk, include_current,
                          sub=16, split=True):
    """``csrc/gla_chunk.cu``'s tensor-core route in plain torch (float32 on
    the CPU; q, k, v hold bf16 values): the chunks' state increments
    dS_c = (k exp(l_last - lc))^T v, the recurrence S_c = exp(l_last) S_{c-1}
    + dS_c, and y = (q exp(lq)) S_{c-1} + A v, with A's ``sub`` x ``sub``
    diagonal blocks from exponentials of differences and every block below
    them the product of (q_t exp(lq_t - m)) and (k_s exp(m - lc_s)), m the
    lq of the first row of t's sub-chunk.  Every product rounds its
    operands as the kernel does (:func:`_mm_split`; ``split=False`` keeps
    the hi parts only).  Returns (y, final state), float32."""
    q, k, v, w = (a.float() for a in (q, k, v, w))
    bh, t, dk = q.shape
    dv = v.shape[-1]
    n_c = t // chunk
    qc, kc, wc = (a.reshape(bh, n_c, chunk, dk) for a in (q, k, w))
    vc = v.reshape(bh, n_c, chunk, dv)
    lc = torch.cumsum(wc, dim=2)
    lq = lc if include_current else torch.nn.functional.pad(
        lc[:, :, :-1], (0, 0, 1, 0))
    l_last = lc[:, :, -1:, :]                           # [bh, C, 1, dk]
    ds = _mm_split((kc * torch.exp(l_last - lc)).transpose(-1, -2), vc,
                   split, b_exact=True)                 # [bh, C, dk, dv]
    s = torch.zeros(bh, dk, dv)
    prev = []
    for c in range(n_c):
        prev.append(s)
        s = torch.exp(l_last[:, c, 0, :])[:, :, None] * s + ds[:, c]
    y = _mm_split(qc * torch.exp(lq), torch.stack(prev, 1), split)
    row = torch.arange(sub)
    keep = (row[:, None] >= row[None, :]) if include_current else \
        (row[:, None] > row[None, :])
    for i in range(chunk // sub):
        ti = slice(sub * i, sub * (i + 1))
        m = lq[:, :, sub * i:sub * i + 1, :]
        q_t = qc[:, :, ti] * torch.exp(lq[:, :, ti] - m)
        blocks = []
        for j in range(i):
            sj = slice(sub * j, sub * (j + 1))
            k_t = kc[:, :, sj] * torch.exp(m - lc[:, :, sj])
            blocks.append(_mm_split(q_t, k_t.transpose(-1, -2), split))
        diff = lq[:, :, ti, None, :] - lc[:, :, None, ti, :]
        diff = torch.where(keep[None, None, :, :, None], diff,
                           torch.tensor(float("-inf")))
        a = (qc[:, :, ti, None, :] * kc[:, :, None, ti, :]
             * torch.exp(diff)).sum(-1)
        if u is not None:
            a = a + torch.diag_embed(
                (qc[:, :, ti] * u.float()[:, None, None, :]
                 * kc[:, :, ti]).sum(-1))
        blocks.append(a)
        y[:, :, ti] += _mm_split(torch.cat(blocks, -1),
                                 vc[:, :, :sub * (i + 1)], split,
                                 b_exact=True)
    return y.reshape(bh, t, dv), s
