"""RWKV6 "Finch" block (arXiv:2404.05892): time-mix with data-dependent
per-channel decay (dynamic token-shift mixing via LoRA) + squared-ReLU
channel-mix.  Sequence processing uses the chunked GLA core; decode carries
(last_x_tmix, last_x_cmix, wkv state) per layer.  The port's copy of
``repro.models.rwkv6``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, init_layer_norm, layer_norm
from repro_torch.models.linear_attention import chunked_gla, gla_decode_step
from repro_torch.sharding.rules import ShardingRules

N_MIX = 5   # r, k, v, w, g dynamic mixing streams
F32 = torch.float32


def init_rwkv_block(init: Init, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    r = cfg.rwkv
    h = d // r.head_dim
    std = d ** -0.5
    return {
        "ln1": init_layer_norm(init, d, dtype),
        "ln2": init_layer_norm(init, d, dtype),
        # token-shift mixing coefficients
        "mu_x": init.full((d,), 0.5, dtype, (None,)),
        "mu_rkvwg": init.full((N_MIX, d), 0.5, dtype, (None, None)),
        "maa_w1": init.normal((d, N_MIX * r.gate_lora), dtype, std,
                              ("d_model", None)),
        "maa_w2": init.normal((N_MIX, r.gate_lora, d), dtype,
                              r.gate_lora ** -0.5, (None, None, "d_model")),
        # decay LoRA
        "w0": init.full((d,), -2.0, F32, (None,)),
        "w1": init.normal((d, r.decay_lora), dtype, std, ("d_model", None)),
        "w2": init.normal((r.decay_lora, d), dtype, r.decay_lora ** -0.5,
                          (None, "d_model")),
        "u": init.normal((h, r.head_dim), F32, 0.1, ("state_heads", None)),
        "wr": init.normal((d, d), dtype, std, ("d_model", "heads_x_dim")),
        "wk": init.normal((d, d), dtype, std, ("d_model", "heads_x_dim")),
        "wv": init.normal((d, d), dtype, std, ("d_model", "heads_x_dim")),
        "wg": init.normal((d, d), dtype, std, ("d_model", "heads_x_dim")),
        "wo": init.normal((d, d), dtype, std, ("heads_x_dim", "d_model")),
        "gn_scale": init.full((d,), 1.0, dtype, (None,)),
        "gn_bias": init.zeros((d,), dtype, (None,)),
        # channel mix
        "mu_ck": init.full((d,), 0.5, dtype, (None,)),
        "mu_cr": init.full((d,), 0.5, dtype, (None,)),
        "wck": init.normal((d, cfg.d_ff), dtype, std, ("d_model", "d_ff")),
        "wcv": init.normal((cfg.d_ff, d), dtype, cfg.d_ff ** -0.5,
                           ("d_ff", "d_model")),
        "wcr": init.normal((d, d), dtype, std, ("d_model", "heads_x_dim")),
    }


def _group_norm(y, scale, bias, h, eps=64e-5):
    """Per-head LayerNorm over head_dim (RWKV's GroupNorm(h))."""
    b, t, d = y.shape
    yf = y.reshape(b, t, h, d // h).float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yf = (yf - mu) * torch.rsqrt(var + eps)
    return (yf.reshape(b, t, d) * scale.float()
            + bias.float()).to(y.dtype)


def _dynamic_mix(params, x, xx, rules: ShardingRules):
    """ddlerp: per-stream dynamic token-shift mixing (RWKV6's novelty).
    On a mesh the LoRA activations are replicated over the feature axis
    before they split into the ``N_MIX`` (5) streams, which no even mesh
    axis divides: an all-gather the plan does not ask for."""
    base = x + xx * params["mu_x"]
    lora = rules.shard(torch.tanh(base @ params["maa_w1"]),
                       "batch", "seq", None)
    b, t, _ = lora.shape
    lora = lora.reshape(b, t, N_MIX, -1)
    dyn = torch.einsum("btnr,nrd->btnd", lora, params["maa_w2"])
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (
        params["mu_rkvwg"][None, None] + dyn)
    return [mixed[:, :, i, :] for i in range(N_MIX)]


def _shifted(x, last_x):
    """The previous token's input per position (zeros, or ``last_x``,
    before the first)."""
    first = (torch.zeros_like(x[:, :1]) if last_x is None
             else last_x[:, None, :])
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(params, x, cfg: ModelConfig, rules: ShardingRules,
                  *, last_x=None, state=None, single_step=False):
    """x: [B, T, D].  Returns (out, new_last_x, new_state)."""
    r = cfg.rwkv
    b, t, d = x.shape
    h = d // r.head_dim
    xx = _shifted(x, last_x) - x
    xr, xk, xv, xw, xg = _dynamic_mix(params, x, xx, rules)
    rq = xr @ params["wr"]
    k = xk @ params["wk"]
    v = xv @ params["wv"]
    g = F.silu(xg @ params["wg"])
    w = -torch.exp(params["w0"]
                   + (torch.tanh(xw @ params["w1"]) @ params["w2"]).float())

    def to_heads(z):
        return z.reshape(b, t, h, r.head_dim).transpose(1, 2)
    rq_h, k_h, v_h, w_h = to_heads(rq), to_heads(k), to_heads(v), to_heads(w)
    heads = ("batch", "state_heads", "seq", None)
    rq_h = rules.shard(rq_h, *heads)
    state_axes = ("batch", "state_heads", None, None)
    if single_step:
        # per head: on a mesh, on each rank's shards
        step_axes = ("batch", "state_heads", None)
        y, new_state = rules.local(
            lambda q_, k_, v_, w_, s_, u_: gla_decode_step(
                q_, k_, v_, w_, s_, include_current=False, bonus=u_),
            (step_axes,) * 4 + (state_axes, ("state_heads", None)),
            (step_axes, state_axes))(
            rq_h[:, :, 0], k_h[:, :, 0], v_h[:, :, 0], w_h[:, :, 0], state,
            params["u"])
        y = y[:, :, None, :].to(x.dtype)
    else:
        # per head: on a mesh, on each rank's shards
        y, new_state = rules.local(
            lambda q_, k_, v_, w_, s_, u_: chunked_gla(
                q_, k_, v_, w_, chunk=min(r.chunk, t), state=s_,
                include_current=False, bonus=u_),
            (heads,) * 4 + (state_axes, ("state_heads", None)),
            (heads, state_axes))(rq_h, k_h, v_h, w_h, state, params["u"])
    y = y.transpose(1, 2).reshape(b, t, d)
    y = _group_norm(y, params["gn_scale"], params["gn_bias"], h) * g
    out = y @ params["wo"]
    return rules.shard(out, "batch", "seq", "act_d_model"), x[:, -1], new_state


def rwkv_channel_mix(params, x, rules: ShardingRules, *, last_x=None):
    xx = _shifted(x, last_x) - x
    xk = x + xx * params["mu_ck"]
    xr = x + xx * params["mu_cr"]
    kk = rules.shard(torch.square(F.relu(xk @ params["wck"])),
                     "batch", "seq", "d_ff")
    vv = kk @ params["wcv"]
    rr = torch.sigmoid(xr @ params["wcr"])
    return rules.shard(rr * vv, "batch", "seq", "act_d_model"), x[:, -1]


def rwkv_block(params, x, cfg: ModelConfig, rules: ShardingRules,
               *, cache=None):
    """Full RWKV6 layer.  cache: dict(tmix_x [B,D], cmix_x [B,D],
    state [B,H,Dk,Dk]) for decode, or None for full-sequence."""
    if cache is None:
        a, _, _ = rwkv_time_mix(params, layer_norm(x, params["ln1"]), cfg,
                                rules)
        x = x + a
        m, _ = rwkv_channel_mix(params, layer_norm(x, params["ln2"]), rules)
        return x + m, None
    a, t_x, new_state = rwkv_time_mix(
        params, layer_norm(x, params["ln1"]), cfg, rules,
        last_x=cache["tmix_x"], state=cache["state"], single_step=True)
    x = x + a
    m, c_x = rwkv_channel_mix(params, layer_norm(x, params["ln2"]), rules,
                              last_x=cache["cmix_x"])
    return x + m, dict(tmix_x=t_x, cmix_x=c_x, state=new_state)


def init_rwkv_cache(cfg: ModelConfig, lead: tuple, batch: int, dtype,
                    device) -> dict:
    d = cfg.d_model
    h = d // cfg.rwkv.head_dim
    hd = cfg.rwkv.head_dim
    return dict(
        tmix_x=torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        cmix_x=torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        state=torch.zeros(lead + (batch, h, hd, hd), dtype=F32,
                          device=device),
    )
