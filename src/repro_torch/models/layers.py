"""Core transformer layers: norms, RoPE/M-RoPE, GQA attention (global /
sliding-window, softcap, qk-norm, bias), SwiGLU/GeGLU MLP, embeddings.

The port's copy of ``repro.models.layers``: pure functions on tensors,
parameters in dicts laid out as the reference's (``interop.
lm_params_from_jax`` carries them across unchanged).  ``init_*`` take an
:class:`Init` — a seeded ``torch.Generator`` on the target device plus a
leading shape, ``(n,)`` for a stage of n stacked layers — and allocate on
that device.

Attention uses a dense path for short sequences and a query-block loop
with online-softmax structure for long ones (``CHUNKED_ATTN_THRESHOLD``, or
``flags.ATTN_CHUNK_THRESHOLD``).  Scores are float32 whatever the
parameters' dtype: q and k are upcast before the product, softcap, mask
and softmax run in float32, and only the probabilities are cast back — the
reference's ``preferred_element_type=float32``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import flags
from repro_torch.models.config import AttnSpec, ModelConfig
from repro_torch.sharding.rules import ShardingRules

# Threshold above which attention switches to the query-chunked path.
CHUNKED_ATTN_THRESHOLD = 8192
Q_CHUNK = 1024
NEG = -1e30          # masked score

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


@dataclasses.dataclass(frozen=True)
class Init:
    """Where and how parameters are drawn: ``gen`` (its device is the
    target), and ``lead``, the shape prefixed to every leaf.  Each leaf
    names its logical axes; with ``gen=None`` nothing is drawn or
    allocated and each leaf *is* its axes tuple (``"layers"`` prefixed
    per ``lead`` axis): the reference's spec tree, built by the same
    code as the parameters."""
    gen: Optional[torch.Generator]
    lead: tuple = ()

    def leaf(self, axes, make):
        """``make()``'s tensor, or ``axes`` when only specs are built."""
        if self.gen is None:
            return ("layers",) * len(self.lead) + tuple(axes)
        return make()

    def normal(self, shape, dtype, std: float, axes):
        return self.leaf(axes, lambda: torch.randn(
            self.lead + tuple(shape), generator=self.gen,
            device=self.gen.device, dtype=dtype).mul_(std))

    def full(self, shape, value, dtype, axes):
        return self.leaf(axes, lambda: torch.full(
            self.lead + tuple(shape), value, dtype=dtype,
            device=self.gen.device))

    def zeros(self, shape, dtype, axes):
        return self.full(shape, 0.0, dtype, axes)


@dataclasses.dataclass(frozen=True)
class EmptyInit(Init):
    """Leaves of the parameters' shapes and dtypes on ``device``, left
    uninitialised (``torch.empty``): under ``FakeTensorMode`` nothing is
    drawn or allocated (the dry run's state).  ``gen`` is a CPU generator
    whose only use is the device of the few leaves built by a function
    (Mamba2's ``A_log``), moved to ``device`` after."""
    device: Optional[torch.device] = None

    def leaf(self, axes, make):
        return make().to(self.device)

    def normal(self, shape, dtype, std: float, axes):
        return self.full(shape, 0.0, dtype, axes)

    def full(self, shape, value, dtype, axes):
        return torch.empty(self.lead + tuple(shape), dtype=dtype,
                           device=self.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rms_norm(init: Init, d: int, dtype) -> dict:
    return {"scale": init.zeros((d,), dtype, (None,))}


def rms_norm(x, params, eps: float = 1e-6):
    """RMSNorm with (1 + scale) parameterization (gemma/llama compatible)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def init_layer_norm(init: Init, d: int, dtype) -> dict:
    return {"scale": init.full((d,), 1.0, dtype, (None,)),
            "bias": init.zeros((d,), dtype, (None,))}


def layer_norm(x, params, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def _freq(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x, sin, cos):
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _heads_expand(t, ndim):
    """[B, S, D/2] -> [B, S, 1, ..., D/2] for an x of ``ndim`` axes."""
    return t.reshape(t.shape[:2] + (1,) * (ndim - 3) + t.shape[2:])


def apply_rope(x, positions, theta: float):
    """x: [B, S, ..., D] (any number of head axes); positions: [B, S]."""
    ang = positions.float()[..., None] * _freq(x.shape[-1] // 2, theta,
                                                x.device)
    return _rotate(x, _heads_expand(torch.sin(ang), x.ndim),
                   _heads_expand(torch.cos(ang), x.ndim))


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL multimodal RoPE.  positions3: [B, S, 3] (t, h, w ids);
    ``sections`` splits the half-dim across the three id streams.
    x: [B, S, ..., D] (any number of head axes)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    # choose which positional stream drives each frequency band
    sec_id = torch.as_tensor(np.repeat(np.arange(3), list(sections)) % 3,
                             device=x.device)                   # [half]
    pos = positions3.float()[..., sec_id]                     # [B, S, half]
    ang = pos * _freq(half, theta, x.device)[None, None, :]
    return _rotate(x, _heads_expand(torch.sin(ang), x.ndim),
                   _heads_expand(torch.cos(ang), x.ndim))


def sinusoidal_embedding(length: int, dim: int, device=None):
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.as_tensor(emb.astype(np.float32), device=device)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(init: Init, cfg: ModelConfig, dtype) -> dict:
    """Grouped layout: wq/wo carry explicit (kv_heads, q_group) axes, as
    the reference's (whose sharding picks either axis)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kv
    std = d ** -0.5
    params = {
        "wq": init.normal((d, kv, g, hd), dtype, std,
                          ("d_model", "kv_heads", "q_group", "head_dim")),
        "wk": init.normal((d, kv, hd), dtype, std,
                          ("d_model", "kv_heads", "head_dim")),
        "wv": init.normal((d, kv, hd), dtype, std,
                          ("d_model", "kv_heads", "head_dim")),
        "wo": init.normal((kv, g, hd, d), dtype, (h * hd) ** -0.5,
                          ("kv_heads", "q_group", "head_dim", "d_model")),
    }
    if cfg.attn.qkv_bias:
        params.update(
            bq=init.zeros((kv, g, hd), dtype,
                          ("kv_heads", "q_group", "head_dim")),
            bk=init.zeros((kv, hd), dtype, ("kv_heads", "head_dim")),
            bv=init.zeros((kv, hd), dtype, ("kv_heads", "head_dim")))
    if cfg.attn.qk_norm:
        params.update(q_norm=init.zeros((hd,), dtype, (None,)),
                      k_norm=init.zeros((hd,), dtype, (None,)))
    return params


def _softcap(scores, cap: float):
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def _scores(q, k, scale):
    """float32 scores [B, KV, G, Sq, Sk] of q [B,Sq,KV,G,D] and k [B,Sk,KV,D]."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _mix(scores, mask, v, dtype):
    """Masked softmax in float32, probabilities cast to ``dtype``, times v."""
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _mask(qpos, kpos, *, causal, window, kv_valid_len=None):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_valid_len is not None:
        mask &= kpos[None, :] < kv_valid_len
    return mask


def _attn_dense(q, k, v, *, causal, window, softcap, q_offset, kv_valid_len,
                scale):
    """q: [B, Sq, KV, G, Dh]; k/v: [B, Sk, KV, Dh].  Mask semantics:
    query global position = q_offset + row; kv position = column index."""
    sq, sk = q.shape[1], k.shape[1]
    scores = _softcap(_scores(q, k, scale), softcap)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = _mask(qpos, kpos, causal=causal, window=window,
                 kv_valid_len=kv_valid_len)
    return _mix(scores, mask, v, q.dtype)


def _attn_chunked(q, k, v, *, causal, window, softcap, scale):
    """Query-block loop (flash structure): one [Q_CHUNK, Sk] score block at
    a time, so peak memory is bounded by the block."""
    sq, sk = q.shape[1], k.shape[1]
    assert sq % Q_CHUNK == 0, (sq, Q_CHUNK)
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for q0 in range(0, sq, Q_CHUNK):
        qblk = q[:, q0:q0 + Q_CHUNK]
        qpos = q0 + torch.arange(Q_CHUNK, device=q.device)
        scores = _softcap(_scores(qblk, k, scale), softcap)
        mask = _mask(qpos, kpos, causal=causal, window=window)
        outs.append(_mix(scores, mask, v, qblk.dtype))
    return torch.cat(outs, dim=1)


def _project(x, w, rules: ShardingRules, heads_axis: Optional[str]):
    """x [B, S, D] times w [D, H, ...] -> [B, S, H, ...], as one matmul
    over the heads axes flattened (the reference's einsum).  On a mesh
    the flattened axis is sharded as its leading heads axis
    (``heads_axis``) before it splits, so the split never cuts a
    sharded axis unevenly."""
    y = rules.shard(x @ w.reshape(w.shape[0], -1), "batch", "seq",
                    heads_axis)
    return y.reshape(tuple(x.shape[:2]) + tuple(w.shape[1:]))


def _write_token(ck, cv, k, v, widx, offset=None):
    """Store one token's k and v ([B, KV, HD]) at slot ``widx`` ([B]) of each
    row's cache ([B, Sc, KV, HD]), in place.  With ``offset`` the cache is
    one rank's shard of a sequence-sharded one, holding the slots from
    ``offset`` on: a row's token lands at ``widx - offset`` when the shard
    holds that slot, and a row whose slot lies elsewhere leaves the shard
    as it was, byte for byte (the slot nearest to its own is written with
    its own value)."""
    bidx = torch.arange(ck.shape[0], device=ck.device)
    if offset is None:
        ck[bidx, widx] = k.to(ck.dtype)
        cv[bidx, widx] = v.to(cv.dtype)
        return
    n = ck.shape[1]
    slot = widx - offset
    own = ((slot >= 0) & (slot < n))[:, None, None]
    slot = slot.clamp(0, n - 1)
    ck[bidx, slot] = torch.where(own, k.to(ck.dtype), ck[bidx, slot])
    cv[bidx, slot] = torch.where(own, v.to(cv.dtype), cv[bidx, slot])


def _attend_cache(q, ck, cv, valid, *, scale, softcap, dtype):
    """One query token over a decode cache: q [B, 1, KV, G, HD], the cache
    [B, Sc, KV, HD], ``valid`` [B, Sc] the slots it may attend to."""
    scores = _softcap(_scores(q, ck, scale), softcap)
    return _mix(scores, valid[:, None, None, None, :], cv, dtype)


def _attend_cache_shards(q, ck, cv, valid, *, scale, softcap, dtype, reduce):
    """:func:`_attend_cache` on one rank's shard of a sequence-sharded cache
    (context parallelism), ``valid`` the shard's slots; ``reduce(x, op)``
    all-reduces over the ranks that hold the other shards.  The softmax
    over the whole cache is the one XLA partitions the reference's into:
    the float32 scores, softcapped and masked; their max over the cache
    (a local max, then MAX); the shifted exps' sum (a local sum, then
    SUM); the probabilities cast to ``dtype`` as the reference's.  Each
    shard's product with its values is taken in float32 and the partial
    outputs are summed (SUM) in float32, cast to ``dtype`` once after.  A
    shard with no valid slot has the masked score ``NEG`` as its max and
    contributes exactly 0: exp(NEG - the global max) is 0, and no -inf is
    ever subtracted.  What moves is per query head and independent of the
    cache's length: [B, KV, G, 1, 1] twice and [B, 1, KV, G, HD] once."""
    scores = _softcap(_scores(q, ck, scale), softcap)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG)
    peak = reduce(scores.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(scores - peak)
    probs = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), cv.float())
    return reduce(out, "sum").to(dtype)


def attention(params, x, positions, rules: ShardingRules, cfg: ModelConfig,
              *, kind: str = "global", cache=None, decode_pos=None,
              cross_kv=None, causal: bool = True, rope: bool = True,
              theta_override: Optional[float] = None):
    """Self- or cross-attention with GQA.

    cache: optional dict(k=[B, Sc, KV, Dh], v=...) — decode mode writes the
    current token at ``decode_pos`` ([B] int) into the cache IN PLACE and
    attends over it.  A local-attention cache sized exactly to the window
    is a ring buffer: slot ``pos % window``.
    Returns (out [B, S, d_model], the cache or None).
    """
    spec: AttnSpec = cfg.attn
    b, s, _ = x.shape
    hd = cfg.head_dim
    window = spec.window if kind == "local" else 0

    kv_in = x if cross_kv is None else cross_kv
    # the GQA group axis over 'model' (kv_heads indivisible, G divisible):
    # the heads axes are flattened G first, so that the flattening starts
    # at the sharded axis, and the results are put back in [KV, G] order
    grouped = rules.mesh is not None and rules.table.get("q_group") is not None
    if grouped:
        q = _project(x, params["wq"].transpose(1, 2), rules,
                     "q_group").transpose(2, 3)
    else:
        q = _project(x, params["wq"], rules, "kv_heads")      # [B,S,KV,G,HD]
    k = _project(kv_in, params["wk"], rules, "kv_heads")
    v = _project(kv_in, params["wv"], rules, "kv_heads")
    if spec.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if spec.qk_norm:
        q = rms_norm(q, {"scale": params["q_norm"]}, cfg.norm_eps)
        k = rms_norm(k, {"scale": params["k_norm"]}, cfg.norm_eps)
    if rope and spec.rope and cross_kv is None:
        theta = theta_override if theta_override is not None else (
            spec.rope_theta_local
            if (kind == "local" and spec.rope_theta_local) else spec.rope_theta)
        if cfg.mrope and positions.ndim == 3:
            q = apply_mrope(q, positions, theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
    # Flat-head mode: when neither kv_heads nor the GQA group divides the TP
    # width but the flat head count does (mixtral 48, yi 32, gemma2 16 on
    # tp=16), repeat K/V to full heads and shard the flat head axis — the
    # attention compute and score buffers shard 1/tp instead of being
    # replicated.  Params stay FSDP-sharded; K/V repeat is activation-only.
    # Full-sequence paths only (decode caches stay un-repeated).
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    g = h // kvh
    flat = (cache is None and rules.mesh is not None
            and rules.table.get("heads") is not None
            and rules.table.get("kv_heads") is None
            and rules.table.get("q_group") is None
            and h % rules.logical_size("heads") == 0)
    if flat:
        q_axes = ("batch", "seq", "heads", None, None)
        kv_axes = ("batch", "seq", "heads", None)
        # only the flat layout cuts the heads over 'model': the gradients
        # are gathered before they flow back into the grouped [KV, G] one,
        # which cannot hold the cut when neither KV nor G divides by it
        q = rules.gather_grad(q.reshape(b, s, h, 1, hd), "heads")
        k = rules.gather_grad(torch.repeat_interleave(k, g, dim=2), "heads")
        v = rules.gather_grad(torch.repeat_interleave(v, g, dim=2), "heads")
    else:
        q_axes = ("batch", "seq", "kv_heads", "q_group", None)
        kv_axes = ("batch", "seq", "kv_heads", None)
    q = rules.shard(q, *q_axes)
    k = rules.shard(k, *kv_axes)
    v = rules.shard(v, *kv_axes)
    scale = hd ** -0.5

    if cache is not None:
        sc = cache["k"].shape[1]
        rolling = bool(kind == "local" and window and sc == window)
        widx = (decode_pos % sc if rolling else decode_pos).long()
        # context parallelism (the long_decode plan): the cache's slots cut
        # over the data axes, each rank writing and attending to its own
        ranks = rules.logical_size("cache_seq")
        if sc % ranks:
            raise ValueError(f"a decode cache of {sc} slots cannot be cut "
                             f"over the {ranks} ranks of 'cache_seq'")
        # per batch row and KV head: on a mesh, on each rank's shards, which
        # are the cache's own only when it is placed as the plan says
        cache_axes = ("batch", "cache_seq", "kv_heads", None)
        tok_axes = ("batch", "kv_heads", None)
        if rules.mesh is not None:
            want = rules.placements(*cache_axes)
            for name in ("k", "v"):
                got = getattr(cache[name], "placements", None)
                if got is None or tuple(got) != want:
                    raise ValueError(
                        f"decode cache {name!r} is placed {got}, not "
                        f"{want}: a write into its shards would be lost; "
                        "place the caches with rules.tree_shard(cache, "
                        "model.cache_logical_specs())")
        write = _write_token
        if ranks > 1:
            write = functools.partial(
                _write_token, offset=rules.shard_range("cache_seq", sc)[0])
        rules.local(write, (cache_axes, cache_axes, tok_axes, tok_axes,
                            ("batch",)), (None,))(
            cache["k"], cache["v"], k[:, 0], v[:, 0], widx)
        kpos = torch.arange(sc, device=x.device)
        if rolling:
            # Slot j holds the most recent position = j (mod sc); once
            # decode_pos >= sc every slot is within the window.  Earlier,
            # only slots <= decode_pos have been written.
            valid = (kpos[None, :] <= decode_pos[:, None]) | (
                decode_pos[:, None] >= sc)
        else:
            valid = kpos[None, :] <= decode_pos[:, None]
            if window:
                valid &= kpos[None, :] > decode_pos[:, None] - window
        if ranks > 1:
            # the query whole on every rank of the cache's shards; the
            # cache never gathered
            q_axes = ("batch", None) + q_axes[2:]
            out = rules.local(
                _attend_cache_shards,
                (q_axes, cache_axes, cache_axes, ("batch", "cache_seq")),
                (q_axes,))(
                q, cache["k"], cache["v"], valid, scale=scale,
                softcap=spec.softcap, dtype=x.dtype,
                reduce=functools.partial(rules.all_reduce,
                                         logical="cache_seq"))
        else:
            out = rules.local(_attend_cache, (q_axes, cache_axes, cache_axes,
                                              ("batch", None)), (q_axes,))(
                q, cache["k"], cache["v"], valid, scale=scale,
                softcap=spec.softcap, dtype=x.dtype)
    else:
        threshold = flags.ATTN_CHUNK_THRESHOLD or CHUNKED_ATTN_THRESHOLD
        # per batch row and head: on a mesh, on each rank's shards
        in_specs, out_specs = (q_axes, kv_axes, kv_axes), (q_axes,)
        if s >= threshold and s % Q_CHUNK == 0 and cross_kv is None:
            out = rules.local(_attn_chunked, in_specs, out_specs)(
                q, k, v, causal=causal, window=window, softcap=spec.softcap,
                scale=scale)
        else:
            out = rules.local(_attn_dense, in_specs, out_specs)(
                q, k, v, causal=causal and cross_kv is None, window=window,
                softcap=spec.softcap, q_offset=0, kv_valid_len=None,
                scale=scale)
    # [B, S, KV, G, HD] (or [B, S, H, 1, HD] flat: the same order) times
    # wo [KV, G, HD, D], as one matmul over the heads axes flattened
    wo = params["wo"]
    if grouped:
        out, wo = out.transpose(2, 3), wo.transpose(0, 1)
    out = rules.shard(out.reshape(b, s, -1), "batch", "seq",
                      "heads" if flat else "q_group" if grouped
                      else "kv_heads")
    wo = wo.reshape(-1, wo.shape[-1])
    if flat:
        wo = rules.gather_grad(wo, "heads")
    out = out @ wo
    return rules.shard(out, "batch", "seq", "act_d_model"), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(init: Init, d: int, d_ff: int, dtype, *, gated: bool = True):
    std_in, std_out = d ** -0.5, d_ff ** -0.5
    if gated:
        return {"wi_gate": init.normal((d, d_ff), dtype, std_in,
                                       ("d_model", "d_ff")),
                "wi_up": init.normal((d, d_ff), dtype, std_in,
                                     ("d_model", "d_ff")),
                "wo": init.normal((d_ff, d), dtype, std_out,
                                  ("d_ff", "d_model"))}
    return {"wi": init.normal((d, d_ff), dtype, std_in, ("d_model", "d_ff")),
            "wo": init.normal((d_ff, d), dtype, std_out, ("d_ff", "d_model"))}


def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp(params, x, act: str, rules: ShardingRules):
    if "wi_gate" in params:
        hidden = _act(x @ params["wi_gate"], act) * (x @ params["wi_up"])
    else:
        hidden = _act(x @ params["wi"], act)
    hidden = rules.shard(hidden, "batch", "seq", "d_ff")
    out = hidden @ params["wo"]
    return rules.shard(out, "batch", "seq", "act_d_model")


# ---------------------------------------------------------------------------
# Embedding / unembedding (vocab padded to a multiple of 2048, as the
# reference's: whisper's 51865 pads to 53248)
# ---------------------------------------------------------------------------

def padded_vocab(cfg: ModelConfig, multiple: int = 2048) -> int:
    return -(-cfg.vocab_size // multiple) * multiple


def init_embedding(init: Init, cfg: ModelConfig, dtype) -> dict:
    pv = padded_vocab(cfg)
    params = {"table": init.normal((pv, cfg.d_model), dtype,
                                   cfg.d_model ** -0.5, ("vocab", "d_model"))}
    if not cfg.tie_embeddings:
        params["unembed"] = init.normal((cfg.d_model, pv), dtype,
                                        cfg.d_model ** -0.5,
                                        ("d_model", "vocab"))
    return params


def _lookup(table, tokens):
    return table[tokens.long()]


def embed(params, tokens, cfg: ModelConfig, rules: ShardingRules,
          *, scale: bool = False):
    # the rows are gathered from the whole table: on a mesh each rank
    # looks its tokens up in a replica of the table (an all-gather of the
    # vocab and d_model shards; the gradient comes back as a partial sum
    # over the batch shards), where DTensor's indexing rule misplaces the
    # rows of a table sharded on both axes
    x = rules.local(_lookup, ((None, None), ("batch", "seq")),
                    (("batch", "seq", None),))(params["table"], tokens)
    if scale:    # gemma multiplies by sqrt(d_model), rounded to the dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return rules.shard(x, "batch", "seq", "act_d_model")


def unembed(params, x, cfg: ModelConfig, rules: ShardingRules):
    if "unembed" in params:
        logits = x @ params["unembed"]
    else:
        logits = x @ params["table"].T
    logits = _softcap(logits.float(), cfg.final_logit_softcap)
    return rules.shard(logits, "batch", "seq", "vocab")
