"""The LM stack's layers on the port against the reference's, one function
at a time, on the same numpy inputs in float32 (rtol = atol = 1e-5):
norms, RoPE and M-RoPE, attention (dense, the query-chunked path forced
by the flag at a small size, cached decode with the local ring buffer
across its wrap), ``chunked_gla`` against the reference's and the port's
own ``gla_decode_step`` recurrence, and the MoE routing with integer
outputs exact, tied logits included (``torch.topk`` promises no tie
order; ``jax.lax.top_k`` keeps the lower index)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import sparse_collectives as jsc
from repro.models import flags as jflags
from repro.models import layers as JL
from repro.models import linear_attention as JLA
from repro.sharding.rules import make_rules as j_make_rules

from repro_torch.configs import get_reduced
from repro_torch.core import sparse_collectives as tsc
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import flags as tflags
from repro_torch.models import layers as TL
from repro_torch.models import linear_attention as TLA
from repro_torch.sharding.rules import make_rules

TOL = dict(rtol=1e-5, atol=1e-5)
JR, TR = j_make_rules(None), make_rules(None)


def rng(seed=0):
    return np.random.default_rng(seed)


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def f32(arch):
    return (dataclasses.replace(j_get_reduced(arch), dtype="float32"),
            dataclasses.replace(get_reduced(arch), dtype="float32"))


def test_norms():
    r = rng(1)
    x = r.normal(0, 3, (2, 5, 16)).astype(np.float32)
    scale = r.normal(0, 0.5, 16).astype(np.float32)
    bias = r.normal(0, 0.5, 16).astype(np.float32)
    close(TL.rms_norm(t(x), {"scale": t(scale)}, 1e-6),
          JL.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)}, 1e-6))
    close(TL.layer_norm(t(x), {"scale": t(scale), "bias": t(bias)}),
          JL.layer_norm(jnp.asarray(x), {"scale": jnp.asarray(scale),
                                         "bias": jnp.asarray(bias)}))


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope(theta):
    r = rng(2)
    x = r.normal(0, 1, (2, 6, 2, 3, 16)).astype(np.float32)
    pos = r.integers(0, 4096, (2, 6)).astype(np.int32)
    close(TL.apply_rope(t(x), t(pos), theta),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_mrope_and_sinusoidal():
    r = rng(3)
    x = r.normal(0, 1, (2, 6, 2, 2, 16)).astype(np.float32)
    pos3 = r.integers(0, 512, (2, 6, 3)).astype(np.int32)
    close(TL.apply_mrope(t(x), t(pos3), 1e6, (2, 3, 3)),
          JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (2, 3, 3)))
    close(TL.sinusoidal_embedding(12, 16), JL.sinusoidal_embedding(12, 16),
          rtol=0, atol=0)


def attn_params(cfg_j, cfg_t, seed):
    p = JL.init_attention(jax.random.PRNGKey(seed), cfg_j, jnp.float32)[0]
    r = rng(seed)
    p = {k: np.asarray(v) + (r.normal(0, 0.1, v.shape).astype(np.float32)
                             if k.startswith(("b", "q_", "k_")) else 0)
         for k, v in p.items()}         # non-zero biases and norm scales
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: t(v) for k, v in p.items()})


@pytest.mark.parametrize("arch,kind", [
    ("gemma2-9b", "local"), ("gemma2-9b", "global"), ("gemma3-4b", "local"),
    ("qwen2-vl-7b", "global"), ("whisper-medium", "global")])
def test_attention_dense(arch, kind):
    cj, ct = f32(arch)
    pj, pt = attn_params(cj, ct, 4)
    r = rng(5)
    b, s = 2, 24
    x = r.normal(0, 1, (b, s, cj.d_model)).astype(np.float32)
    if cj.mrope:
        pos = r.integers(0, s, (b, s, 3)).astype(np.int32)
    else:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want, _ = JL.attention(pj, jnp.asarray(x), jnp.asarray(pos), JR, cj,
                           kind=kind)
    got, _ = TL.attention(pt, t(x), t(pos), TR, ct, kind=kind)
    close(got, want)
    # cross attention (no rope, no mask) over another sequence
    kv = r.normal(0, 1, (b, 7, cj.d_model)).astype(np.float32)
    want, _ = JL.attention(pj, jnp.asarray(x), jnp.asarray(pos), JR, cj,
                           cross_kv=jnp.asarray(kv), causal=False, rope=False)
    got, _ = TL.attention(pt, t(x), t(pos), TR, ct, cross_kv=t(kv),
                          causal=False, rope=False)
    close(got, want)


@pytest.mark.parametrize("kind", ["local", "global"])
def test_attention_chunked_branch(monkeypatch, kind):
    """The query-chunked path, forced at a small size by the threshold
    flag (and a small query block), in both packages; it equals the dense
    path."""
    cj, ct = f32("gemma2-9b")
    pj, pt = attn_params(cj, ct, 6)
    r = rng(7)
    b, s = 2, 48
    x = r.normal(0, 1, (b, s, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    dense, _ = TL.attention(pt, t(x), t(pos), TR, ct, kind=kind)
    monkeypatch.setattr(jflags, "ATTN_CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(tflags, "ATTN_CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(JL, "Q_CHUNK", 8)
    monkeypatch.setattr(TL, "Q_CHUNK", 8)
    calls = []
    real = TL._attn_chunked
    monkeypatch.setattr(TL, "_attn_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want, _ = JL.attention(pj, jnp.asarray(x), jnp.asarray(pos), JR, cj,
                           kind=kind)
    got, _ = TL.attention(pt, t(x), t(pos), TR, ct, kind=kind)
    assert calls, "the chunked branch did not run"
    close(got, want)
    close(got, dense.numpy())


@pytest.mark.parametrize("cache_len", [4, 12])
def test_cached_decode_ring_buffer_wrap(cache_len):
    """Local attention decoded token by token for 11 steps: with the cache
    sized to the window (4) the ring buffer wraps twice; with a longer
    cache the window masks.  Each step equals the reference's, and the
    port's steps equal its own dense forward's rows."""
    cj, ct = f32("gemma2-9b")
    cj = dataclasses.replace(cj, attn=dataclasses.replace(cj.attn, window=4))
    ct = dataclasses.replace(ct, attn=dataclasses.replace(ct.attn, window=4))
    pj, pt = attn_params(cj, ct, 8)
    r = rng(9)
    b, steps, kvh, hd = 2, 11, cj.num_kv_heads, cj.head_dim
    x = r.normal(0, 1, (b, steps, cj.d_model)).astype(np.float32)
    pos_all = np.broadcast_to(np.arange(steps, dtype=np.int32),
                              (b, steps)).copy()
    full, _ = TL.attention(pt, t(x), t(pos_all), TR, ct, kind="local")
    jc = dict(k=jnp.zeros((b, cache_len, kvh, hd)),
              v=jnp.zeros((b, cache_len, kvh, hd)))
    tc = dict(k=torch.zeros((b, cache_len, kvh, hd)),
              v=torch.zeros((b, cache_len, kvh, hd)))
    for i in range(steps):
        xi = x[:, i:i + 1]
        pos = np.full((b,), i, np.int32)
        want, jc = JL.attention(pj, jnp.asarray(xi), jnp.asarray(pos[:, None]),
                                JR, cj, kind="local", cache=jc,
                                decode_pos=jnp.asarray(pos))
        got, tc = TL.attention(pt, t(xi), t(pos[:, None]), TR, ct,
                               kind="local", cache=tc, decode_pos=t(pos))
        close(got, want)
        close(got[:, 0], full[:, i].numpy())
    close(tc["k"], jc["k"])


@pytest.mark.parametrize("scalar,include_current,bonus", [
    (True, True, False), (False, False, True), (False, True, False)])
def test_chunked_gla(scalar, include_current, bonus):
    r = rng(10)
    b, h, tt, dk, dv, chunk = 2, 3, 16, 8, 6, 4
    q, k = (r.normal(0, 1, (b, h, tt, dk)).astype(np.float32)
            for _ in range(2))
    v = r.normal(0, 1, (b, h, tt, dv)).astype(np.float32)
    w = -np.exp(r.normal(-1, 0.5, (b, h, tt, 1 if scalar else dk))).astype(
        np.float32)
    u = r.normal(0, 0.5, (h, dk)).astype(np.float32) if bonus else None
    s0 = r.normal(0, 1, (b, h, dk, dv)).astype(np.float32)
    kw = dict(include_current=include_current)
    y_j, s_j = JLA.chunked_gla(*(jnp.asarray(a) for a in (q, k, v, w)),
                               chunk=chunk, state=jnp.asarray(s0),
                               bonus=None if u is None else jnp.asarray(u),
                               **kw)
    y_t, s_t = TLA.chunked_gla(t(q), t(k), t(v), t(w), chunk=chunk,
                               state=t(s0), bonus=None if u is None else t(u),
                               **kw)
    close(y_t, y_j)
    close(s_t, s_j)
    # the port's chunked form against its own one-token recurrence
    state, ys = t(s0), []
    for i in range(tt):
        y, state = TLA.gla_decode_step(
            t(q[:, :, i]), t(k[:, :, i]), t(v[:, :, i]), t(w[:, :, i]), state,
            bonus=None if u is None else t(u), **kw)
        ys.append(y)
    close(torch.stack(ys, 2), y_t.numpy(), rtol=1e-4, atol=1e-4)
    close(state, s_t.numpy(), rtol=1e-4, atol=1e-4)


ROUTING = [("random", None, None), ("random", 4, None), ("random", None, 2),
           ("tied", None, None), ("tied", 4, 2)]


def routing_logits(kind, tokens=24, experts=8):
    r = rng(11)
    if kind == "random":
        return r.normal(0, 1, (tokens, experts)).astype(np.float32)
    # ties inside a row (equal logits on several experts) and equal rows
    base = r.integers(0, 3, (tokens // 3, experts)).astype(np.float32)
    return np.concatenate([base, base, base])


@pytest.mark.parametrize("kind,block,groups", ROUTING)
def test_topk_routing_exact(kind, block, groups):
    logits = routing_logits(kind)
    k, cap = 2, 4             # capacity well below demand: tokens drop
    ref = jsc.topk_routing(jnp.asarray(logits), k, cap, block=block,
                           groups=groups)
    port = tsc.topk_routing(t(logits), k, cap, block=block, groups=groups)
    for name, a, b in zip(("dispatch", "expert_idx", "position", "weights",
                           "group_id"), ref, port):
        if a is None:
            assert b is None, name
        elif name == "weights":
            close(b, a)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    assert not np.asarray(ref[0]).all()      # some tokens were dropped


@pytest.mark.parametrize("groups", [None, 2])
def test_dense_dispatch_and_combine(groups):
    r = rng(12)
    tokens, experts, k, cap, d = 24, 8, 2, 8, 5
    logits = routing_logits("random", tokens, experts)
    x = r.normal(0, 1, (tokens, d)).astype(np.float32)
    disp, idx, pos, w, gid = jsc.topk_routing(jnp.asarray(logits), k, cap,
                                              groups=groups)
    tdisp, tidx, tpos, tw, tgid = tsc.topk_routing(t(logits), k, cap,
                                                   groups=groups)
    g = groups or 1
    buf_j = jsc.dense_dispatch(jnp.asarray(x), disp, idx, pos, experts, cap,
                               group_id=gid, groups=g)
    buf_t = tsc.dense_dispatch(t(x), tdisp, tidx, tpos, experts, cap,
                               group_id=tgid, groups=g)
    close(buf_t, buf_j, rtol=0, atol=0)
    out = r.normal(0, 1, buf_t.shape).astype(np.float32)
    close(tsc.dense_combine(t(out), tdisp, tidx, tpos, tw, tokens,
                            group_id=tgid),
          jsc.dense_combine(jnp.asarray(out), disp, idx, pos, w, tokens,
                            group_id=gid))


def test_embeds():
    r = rng(13)
    table = r.normal(0, 1, (40, 6)).astype(np.float32)
    tokens = r.integers(0, 40, (3, 5)).astype(np.int32)
    close(tsc.vocab_sharded_embed(t(tokens), t(table), 40),
          jsc.vocab_sharded_embed(jnp.asarray(tokens), jnp.asarray(table), 40))
    close(tsc.take_embed(t(tokens), t(table)),
          jsc.take_embed(jnp.asarray(tokens), jnp.asarray(table)),
          rtol=0, atol=0)


def test_mlp_embed_unembed():
    cj, ct = f32("gemma2-9b")
    key = jax.random.PRNGKey(14)
    emb = JL.init_embedding(key, cj, jnp.float32)[0]
    mlp = JL.init_mlp(key, cj.d_model, cj.d_ff, jnp.float32)[0]
    emb_t = lm_params_from_jax({"embed": emb, "stages": []},
                               dataclasses.replace(ct, num_layers=0),
                               device="cpu")["embed"]
    mlp_t = {k: t(v) for k, v in mlp.items()}
    r = rng(15)
    tokens = r.integers(0, cj.vocab_size, (2, 5)).astype(np.int32)
    xe_j = JL.embed(emb, jnp.asarray(tokens), cj, JR, scale=True)
    xe_t = TL.embed(emb_t, t(tokens), ct, TR, scale=True)
    close(xe_t, xe_j)
    close(TL.mlp(mlp_t, xe_t, "gelu", TR), JL.mlp(mlp, xe_j, "gelu", JR))
    close(TL.unembed(emb_t, xe_t, ct, TR), JL.unembed(emb, xe_j, cj, JR))
    assert TL.padded_vocab(ct) == JL.padded_vocab(cj) == 2048
