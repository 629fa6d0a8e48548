"""Mamba2 (SSD) block (zamba2's backbone): gated state-space with per-head
scalar decay, causal depthwise conv frontend, chunked scan via the GLA core.
The port's copy of ``repro.models.mamba2``.

Mapping onto chunked_gla: per head h in group g,
  k_t = B_t(g) [N],  v_t = dt_t(h) * x_t(h) [P],  q_t = C_t(g) [N],
  log decay = -exp(A_log_h) * dt_t(h)  (scalar per head per step),
  y_t = q_t . S_t + D_h x_t.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, init_rms_norm, rms_norm
from repro_torch.models.linear_attention import chunked_gla, gla_decode_step
from repro_torch.sharding.rules import ShardingRules

F32 = torch.float32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    nheads = inner // s.head_dim
    conv_dim = inner + 2 * s.n_groups * s.state_dim
    return inner, nheads, conv_dim


def init_mamba_block(init: Init, cfg: ModelConfig, dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    inner, nheads, conv_dim = _dims(cfg)
    proj_out = 2 * inner + 2 * s.n_groups * s.state_dim + nheads

    def a_log():
        return torch.log(torch.linspace(
            1.0, 16.0, nheads, dtype=F32, device=init.gen.device)).expand(
            init.lead + (nheads,)).clone()
    return {
        "norm": init_rms_norm(init, d, dtype),
        "in_proj": init.normal((d, proj_out), dtype, d ** -0.5,
                               ("d_model", "inner")),
        "conv_w": init.normal((s.conv_width, conv_dim), dtype,
                              s.conv_width ** -0.5, (None, "inner")),
        "conv_b": init.zeros((conv_dim,), dtype, ("inner",)),
        "A_log": init.leaf(("state_heads",), a_log),
        "D": init.full((nheads,), 1.0, F32, ("state_heads",)),
        "dt_bias": init.zeros((nheads,), F32, ("state_heads",)),
        "gnorm": init_rms_norm(init, inner, dtype),
        "out_proj": init.normal((inner, d), dtype, inner ** -0.5,
                                ("inner", "d_model")),
    }


def _causal_conv(xbc, conv_w, conv_b, *, conv_state=None):
    """Depthwise causal conv, width W.  xbc: [B, T, C].
    conv_state: [B, W-1, C] trailing inputs from the previous segment.
    Returns (y [B, T, C], new_conv_state)."""
    w = conv_w.shape[0]
    t = xbc.shape[1]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                       # [B, T+W-1, C]
    y = full[:, 0:t] * conv_w[0]
    for i in range(1, w):            # the reference's left-to-right sum
        y = y + full[:, i:i + t] * conv_w[i]
    y = y + conv_b
    return F.silu(y), full[:, -(w - 1):]


def mamba_block(params, x, cfg: ModelConfig, rules: ShardingRules,
                *, cache=None):
    """x: [B, T, D].  cache: dict(conv [B, W-1, C], state [B, H, N, P]) for
    decode; None for full sequence.  Returns (out, new_cache)."""
    s = cfg.ssm
    inner, nheads, conv_dim = _dims(cfg)
    b, t, d = x.shape
    res = x
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [inner, conv_dim, nheads], dim=-1)
    xbc, new_conv = _causal_conv(
        xbc, params["conv_w"], params["conv_b"],
        conv_state=None if cache is None else cache["conv"])
    gs = s.n_groups * s.state_dim
    xs, bs, cs = torch.split(xbc, [inner, gs, gs], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])           # [B,T,H]
    decay = -torch.exp(params["A_log"])[None, None] * dt      # [B,T,H]

    heads_per_group = nheads // s.n_groups
    xh = xs.reshape(b, t, nheads, s.head_dim)
    bh = torch.repeat_interleave(bs.reshape(b, t, s.n_groups, s.state_dim),
                                 heads_per_group, dim=2)
    ch = torch.repeat_interleave(cs.reshape(b, t, s.n_groups, s.state_dim),
                                 heads_per_group, dim=2)
    q = ch.transpose(1, 2)                                    # [B,H,T,N]
    k = bh.transpose(1, 2)
    v = (xh * dt[..., None].to(xh.dtype)).transpose(1, 2)
    w = decay.transpose(1, 2)[..., None]                      # [B,H,T,1]
    heads = ("batch", "state_heads", "seq", None)
    q = rules.shard(q, *heads)
    if cache is not None:
        # per head: on a mesh, on each rank's shards
        step_axes = ("batch", "state_heads", None)
        state_axes = ("batch", "state_heads", None, None)
        y, new_state = rules.local(
            lambda q_, k_, v_, w_, s_: gla_decode_step(
                q_, k_, v_, w_, s_, include_current=True),
            (step_axes,) * 4 + (state_axes,), (step_axes, state_axes))(
            q[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0], cache["state"])
        y = y[:, :, None, :]
    else:
        # per head: on a mesh, on each rank's shards
        y, new_state = rules.local(
            chunked_gla, (heads,) * 4,
            (heads, ("batch", "state_heads", None, None)))(
            q, k, v, w, chunk=min(s.chunk, t), include_current=True)
    y = y.transpose(1, 2).reshape(b, t, inner).to(x.dtype)
    y = y + xs * torch.repeat_interleave(params["D"], s.head_dim)[
        None, None].to(x.dtype)
    # the heads back together before the gated norm and out_proj reduce
    # over them: on a mesh an all-gather over the heads' axis, where the
    # norm's statistic and the projection would otherwise be partial sums
    # over it, which round apart from one device's and which the later
    # layers' decay chains amplify
    y = rms_norm(rules.shard(y * F.silu(z), "batch", "seq", None),
                 params["gnorm"], cfg.norm_eps)
    out = rules.shard(y @ params["out_proj"], "batch", "seq", "act_d_model")
    new_cache = None
    if cache is not None:
        new_cache = dict(conv=new_conv, state=new_state)
    return res + out, new_cache


def init_mamba_cache(cfg: ModelConfig, lead: tuple, batch: int, dtype,
                     device) -> dict:
    s = cfg.ssm
    inner, nheads, conv_dim = _dims(cfg)
    return dict(
        conv=torch.zeros(lead + (batch, s.conv_width - 1, conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros(lead + (batch, nheads, s.state_dim, s.head_dim),
                          dtype=F32, device=device),
    )
