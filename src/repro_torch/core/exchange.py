"""The wire byte model of the inter-worker message exchange — the pricing
subset of ``repro.core.exchange`` that the phases need.

Phase 2's filter emits, per (source partition p, destination partition q),
a send list; each list is one **message batch** whose byte representation
is chosen adaptively (the §4.1 CSR/DCSR idea applied to the network):

* ``pairs``  — compacted ``(src_local int32, value float32)`` entries:
  ``count * (4 + msg_bytes)`` bytes;
* ``vpairs`` — the same entries with the index column replaced by a
  delta-varint gap stream: ``gap_bytes(mask) + count * msg_bytes``
  (compression on);
* ``slab``   — a presence bitmap plus ``v_max`` dense values:
  ``ceil(v_max / 8) + v_max * msg_bytes`` bytes;
* ``uval``   — a gap stream plus ONE value when every value of the batch
  is identical: ``gap_bytes(mask) + msg_bytes`` (compression on).

:func:`batch_wire_bytes` prices every executor's ``net_bytes`` counter and
:func:`choose_wire_format` is its scalar twin for an encoder.  The
encoders, :class:`Exchange` and the decode-ahead thread come with the
distributed out-of-core executor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import ceil_div

WIRE_MSG_BYTES = 4          # float32 payload values on the wire
_IDX_BYTES = 4              # int32 source-local index per compacted pair

FMT_PAIRS = 0
FMT_SLAB = 1
FMT_VPAIRS = 2              # delta-varint index stream + dense value column
FMT_UVAL = 3                # delta-varint index stream + ONE uniform value


def pair_batch_bytes(count, msg_bytes: int):
    """Compacted (index, value) encoding: ``count`` live messages."""
    return count * float(_IDX_BYTES + msg_bytes)


def slab_batch_bytes(v_max: int, msg_bytes: int) -> float:
    """Dense batch slab: presence bitmap + one value per source vertex."""
    return float(ceil_div(v_max, 8) + v_max * msg_bytes)


def vpair_batch_bytes(count, gap_bytes, msg_bytes: int):
    """Delta-varint pairs: the gap stream plus one value per message.
    ``gap_bytes`` comes from :func:`repro_torch.core.codec.mask_gap_bytes`
    on the same send mask the encoder serializes."""
    return gap_bytes + count * float(msg_bytes)


def uval_batch_bytes(gap_bytes, msg_bytes: int):
    """Uniform-value batch: the gap stream plus ONE value for the whole
    batch.  Valid only for batches whose masked values are all
    identical."""
    return gap_bytes + float(msg_bytes)


def batch_wire_bytes(count, v_max: int, msg_bytes: int, gap_bytes=None,
                     uniform=None, xp=np):
    """Priced wire bytes of one (p -> q) message batch.

    ``count`` may be a scalar or an array (numpy, or torch via ``xp``);
    empty batches are never sent and cost 0.  With ``gap_bytes`` the
    price is the compressed-tier minimum including ``vpairs`` — and, where
    ``uniform`` is True, ``uval``.  Without ``gap_bytes``, the legacy
    two-way pairs/slab choice (``uniform`` is then ignored).  The host
    (numpy) path prices in float64 so the model stays exact against the
    integer byte sum a wire measures; the torch path keeps float32, the
    analytic counters' dtype."""
    slab = slab_batch_bytes(v_max, msg_bytes)
    if xp is np:
        pairs = pair_batch_bytes(np.asarray(count, np.float64), msg_bytes)
        best = np.minimum(pairs, slab)
        if gap_bytes is not None:
            gb = np.asarray(gap_bytes, np.float64)
            best = np.minimum(best, vpair_batch_bytes(
                np.asarray(count, np.float64), gb, msg_bytes))
            if uniform is not None:
                best = np.where(np.asarray(uniform),
                                np.minimum(best, uval_batch_bytes(
                                    gb, msg_bytes)), best)
        return np.where(np.asarray(count) > 0, best, 0.0)
    c = torch.as_tensor(count).to(torch.float32)
    best = pair_batch_bytes(c, msg_bytes).clamp(max=slab)
    if gap_bytes is not None:
        gb = torch.as_tensor(gap_bytes).to(torch.float32)
        best = torch.minimum(best, vpair_batch_bytes(c, gb, msg_bytes))
        if uniform is not None:
            best = torch.where(torch.as_tensor(uniform),
                               torch.minimum(best, uval_batch_bytes(
                                   gb, msg_bytes)), best)
    return torch.where(c > 0, best, 0.0)


def choose_wire_format(count: int, v_max: int, msg_bytes: int,
                       gap_bytes=None, uniform: bool = False) -> int:
    """The encoder's scalar realization of :func:`batch_wire_bytes`: the
    cheapest enabled encoding, ties preferring the cheaper decode
    (pairs, then vpairs, then uval, then slab).  Any tie-break yields the
    same byte count as the model's minimum — which is the invariant that
    matters."""
    best, cost = FMT_PAIRS, pair_batch_bytes(count, msg_bytes)
    if gap_bytes is not None:
        vb = vpair_batch_bytes(count, float(gap_bytes), msg_bytes)
        if vb < cost:
            best, cost = FMT_VPAIRS, vb
        if uniform:
            ub = uval_batch_bytes(float(gap_bytes), msg_bytes)
            if ub < cost:
                best, cost = FMT_UVAL, ub
    if slab_batch_bytes(v_max, msg_bytes) < cost:
        best = FMT_SLAB
    return best
