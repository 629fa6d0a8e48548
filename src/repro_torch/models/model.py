"""Model assembler: builds any assigned architecture from its ModelConfig.
The port's copy of ``repro.models.model``.

Layers are grouped into *stages* exactly as the reference's: consecutive
layers whose per-layer descriptor cycle repeats share one stage, whose
parameters are stacked along a leading 'layers' axis (leaves ``[n, ...]``,
the layout of the reference's ``lax.scan`` stages, so
``interop.lm_params_from_jax`` carries a parameter tree across leaf for
leaf).  Where the reference scans, the port loops over the stage's layers
and indexes the stacked leaves.  Irregular prefixes/suffixes (deepseek's
dense first layer, gemma3's trailing local layers) become their own stages.

Per-layer descriptor = (attn_kind, ffn_kind):
  attn_kind: 'global' | 'local' | 'encdec' | 'rwkv' | 'mamba'
  ffn_kind:  'mlp' | 'moe' | None (rwkv/mamba blocks are self-contained)

zamba2: a single *shared* attention+MLP block (one param set) is invoked
after every ``shared_attn_every`` mamba layers.

Decode caches are stacked the same way and updated in place:
``decode_step`` returns the cache it was given, advanced by one token.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import ShardingRules
from repro_torch.utils import resolve_device

Desc = Tuple[str, Optional[str]]
SHARED: Desc = ("global", "mlp")


@dataclasses.dataclass(frozen=True)
class Stage:
    cycle: Tuple[Desc, ...]   # block descriptors in one step
    n: int                    # number of steps (stacked layers per position)
    shared_attn: bool = False  # zamba2: apply the shared block after cycle
    encoder: bool = False


def _layer_descs(cfg: ModelConfig) -> List[Desc]:
    descs: List[Desc] = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind in ("rwkv", "mamba"):
            descs.append((kind, None))
        else:
            ffn = "mlp"
            if cfg.moe is not None and i >= cfg.moe.dense_first_n:
                ffn = "moe"
            descs.append(("encdec" if cfg.is_encdec else kind, ffn))
    return descs


def _group_stages(descs: List[Desc], cycle_len: int,
                  shared_every: int = 0) -> List[Stage]:
    stages: List[Stage] = []
    if shared_every:
        cycle_len = shared_every
    i = 0
    n = len(descs)
    while i < n:
        # try to extend a full-cycle run
        cyc = tuple(descs[i:i + cycle_len])
        runs = 0
        j = i
        while j + cycle_len <= n and tuple(descs[j:j + cycle_len]) == cyc:
            runs += 1
            j += cycle_len
        if runs >= 1 and len(cyc) == cycle_len:
            stages.append(Stage(cyc, runs, shared_attn=bool(shared_every)))
            i = j
        else:
            # remainder: group identical consecutive descriptors
            d0 = descs[i]
            j = i
            while j < n and descs[j] == d0:
                j += 1
            stages.append(Stage((d0,), j - i, shared_attn=False))
            i = j
    return stages


def _index(tree, i):
    """Layer ``i`` of a stacked tree: views, no copy."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _write_back(view, new) -> None:
    """Store a block's new cache into the stacked cache it was viewed from
    (attention writes its cache in place; recurrent blocks return new
    state)."""
    for k, v in view.items():
        if isinstance(v, dict):
            _write_back(v, new[k])
        elif new[k] is not v:
            v.copy_(new[k])


# ---------------------------------------------------------------------------
# Block init / apply dispatch
# ---------------------------------------------------------------------------

def _init_block(init: L.Init, desc: Desc, cfg: ModelConfig, dtype) -> dict:
    attn_kind, ffn_kind = desc
    if attn_kind == "rwkv":
        return R.init_rwkv_block(init, cfg, dtype)
    if attn_kind == "mamba":
        return M.init_mamba_block(init, cfg, dtype)
    d = cfg.d_model
    params = {"ln1": L.init_rms_norm(init, d, dtype),
              "attn": L.init_attention(init, cfg, dtype),
              "ln2": L.init_rms_norm(init, d, dtype)}
    if attn_kind == "encdec":
        params.update(ln_x=L.init_rms_norm(init, d, dtype),
                      xattn=L.init_attention(init, cfg, dtype))
    if ffn_kind == "moe":
        params["moe"] = MOE.init_moe(init, cfg, dtype)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.d_ff_dense:
            d_ff = cfg.moe.d_ff_dense
        gated = not cfg.is_encdec           # whisper uses plain GELU MLP
        params["mlp"] = L.init_mlp(init, d, d_ff, dtype, gated=gated)
    if cfg.post_norms:
        params.update(post_ln1=L.init_rms_norm(init, d, dtype),
                      post_ln2=L.init_rms_norm(init, d, dtype))
    return params


def _apply_block(params, desc: Desc, x, cfg: ModelConfig,
                 rules: ShardingRules, *, positions, cache=None,
                 decode_pos=None, cross_kv=None, causal=True):
    """Returns (x, aux, new_cache)."""
    attn_kind, ffn_kind = desc
    zero = x.new_zeros((), dtype=torch.float32)
    if attn_kind == "rwkv":
        x, nc = R.rwkv_block(params, x, cfg, rules, cache=cache)
        return x, zero, nc
    if attn_kind == "mamba":
        x, nc = M.mamba_block(params, x, cfg, rules, cache=cache)
        return x, zero, nc
    # transformer block
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    a, _ = L.attention(
        params["attn"], h, positions, rules, cfg,
        kind="local" if attn_kind == "local" else "global",
        cache=None if cache is None else cache.get("self"),
        decode_pos=decode_pos, causal=causal, rope=cfg.attn.rope)
    if cfg.post_norms:
        a = L.rms_norm(a, params["post_ln1"], cfg.norm_eps)
    x = x + a
    if attn_kind == "encdec":
        hx = L.rms_norm(x, params["ln_x"], cfg.norm_eps)
        if cache is not None and "ck" in cache:
            # decode: cached cross K/V
            xa = _cached_cross_attention(params["xattn"], hx, cache, cfg,
                                         rules)
        else:
            xa, _ = L.attention(params["xattn"], hx, positions, rules, cfg,
                                cross_kv=cross_kv, causal=False, rope=False)
        x = x + xa
    h2 = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    aux = zero
    if ffn_kind == "moe":
        f, aux = MOE.moe_ffn(params["moe"], h2, cfg, rules)
    else:
        f = L.mlp(params["mlp"], h2, cfg.act, rules)
    if cfg.post_norms:
        f = L.rms_norm(f, params["post_ln2"], cfg.norm_eps)
    return x + f, aux, cache


def _put_patches(x, positions, embeds):
    """A copy of x [B, S, D] with each row's patch embeddings [B, P, D]
    written at its positions [B, P]."""
    x = x.clone()
    x[torch.arange(x.shape[0], device=x.device)[:, None],
      positions.long()] = embeds.to(x.dtype)
    return x


def _cached_cross_attention(params, x, cache, cfg: ModelConfig,
                            rules: ShardingRules):
    """Decode-time cross attention over precomputed encoder K/V (the heads
    axes flattened into one matmul each way, as ``layers.attention``'s)."""
    b, s, _ = x.shape
    qh = L._project(x, params["wq"], rules, "kv_heads")      # [B,S,KV,G,HD]
    if cfg.attn.qkv_bias:
        qh = qh + params["bq"]
    # per batch row and KV head: on a mesh, on each rank's shards
    q_axes = ("batch", None, "kv_heads", "q_group", None)
    kv_axes = ("batch", "frames", "kv_heads", None)
    out = rules.local(_cross_mix, (q_axes, kv_axes, kv_axes), (q_axes,))(
        qh, cache["ck"], cache["cv"], scale=cfg.head_dim ** -0.5,
        dtype=x.dtype)
    out = rules.shard(out.reshape(b, s, -1), "batch", None, "kv_heads")
    return out @ params["wo"].reshape(-1, params["wo"].shape[-1])


def _cross_mix(q, ck, cv, *, scale, dtype):
    scores = L._scores(q, ck, scale)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, cv)


def _init_block_cache(desc: Desc, cfg: ModelConfig, lead: tuple, batch: int,
                      cache_len: int, dtype, device, *, frames: int = 0):
    attn_kind, _ = desc
    if attn_kind == "rwkv":
        return R.init_rwkv_cache(cfg, lead, batch, dtype, device)
    if attn_kind == "mamba":
        return M.init_mamba_cache(cfg, lead, batch, dtype, device)
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    rolling = attn_kind == "local" and cfg.attn.window and \
        cfg.attn.window < cache_len
    sc = cfg.attn.window if rolling else cache_len

    def zeros(length):
        return torch.zeros(lead + (batch, length, kvh, hd), dtype=dtype,
                           device=device)
    cache = {"self": dict(k=zeros(sc), v=zeros(sc))}
    if attn_kind == "encdec":
        cache["ck"] = zeros(frames)
        cache["cv"] = zeros(frames)
    return cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model:
    """One architecture on one device (``"cuda"`` unless ``device`` says
    otherwise).  ``remat`` checkpoints each step of a stage's loop on the
    forward (training) path, as the reference's ``jax.checkpoint`` of its
    scan body does; decode ignores it."""

    def __init__(self, cfg: ModelConfig, remat: bool = False, *,
                 device=None):
        self.cfg = cfg
        self.remat = remat
        self.device = resolve_device(device)
        self.stages = _group_stages(_layer_descs(cfg), len(cfg.attn.pattern),
                                    cfg.shared_attn_every)
        self.encoder_stages: List[Stage] = []
        if cfg.is_encdec:
            enc_desc = [SHARED] * cfg.encoder_layers
            self.encoder_stages = [
                dataclasses.replace(s, encoder=True)
                for s in _group_stages(enc_desc, 1)]

    # -- init ----------------------------------------------------------------
    def _init_stage(self, init: L.Init, stage: Stage, dtype) -> list:
        """Stacked params: per cycle position, leaves shaped [n, ...]."""
        init = dataclasses.replace(init, lead=(stage.n,))
        return [_init_block(init, desc, self.cfg, dtype)
                for desc in stage.cycle]

    def init(self, generator: torch.Generator | None = None,
             seed: int = 0) -> dict:
        """Random parameters drawn on the model's device from ``generator``
        (one seeded from ``seed`` on that device when None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        return self._build(L.Init(generator))

    def empty_params(self) -> dict:
        """The parameter tree on the model's device, uninitialised
        (``torch.empty``): under ``FakeTensorMode`` the dry run's params,
        built with no generator and no allocation."""
        return self._build(L.EmptyInit(torch.Generator(),
                                       device=self.device))

    def param_specs(self) -> dict:
        """The parameter tree with each leaf replaced by its tuple of
        logical axis names (``"layers"`` first on stacked stage leaves):
        the reference's ``param_specs``, built without drawing or
        allocating a parameter."""
        return self._build(L.Init(None))

    def _build(self, init: L.Init) -> dict:
        cfg = self.cfg
        dtype = L.dtype_of(cfg)
        params = {"embed": L.init_embedding(init, cfg, dtype),
                  "final_norm": L.init_rms_norm(init, cfg.d_model, dtype),
                  "stages": [self._init_stage(init, stage, dtype)
                             for stage in self.stages]}
        if cfg.shared_attn_every:
            params["shared_attn"] = _init_block(init, SHARED, cfg, dtype)
        if cfg.is_encdec:
            params["enc_stages"] = [self._init_stage(init, stage, dtype)
                                    for stage in self.encoder_stages]
            params["enc_final_norm"] = L.init_rms_norm(init, cfg.d_model,
                                                       dtype)
            params["dec_pos"] = init.normal(
                (cfg.max_target_positions, cfg.d_model), dtype, 0.02,
                ("cache_seq", "d_model"))
        return params

    # -- stage runner ----------------------------------------------------------
    def _run_stage(self, stage: Stage, stage_params, x, rules, *, positions,
                   cache=None, decode_pos=None, cross_kv=None, causal=True,
                   shared=None, shared_cache=None):
        """The stage's layers in order; with ``cache`` (the stage's stacked
        cache) each layer reads and advances its slice.  ``shared`` is
        zamba2's shared block, applied after each cycle when the stage
        says so, with its own per-invocation cache in decode.  Without a
        cache and with ``remat``, each step of the loop (the cycle's
        blocks plus the shared block) is checkpointed: its activations
        are recomputed in the backward pass, as ``jax.checkpoint`` of the
        reference's scan body."""
        cfg = self.cfg

        def body(i, x, aux):
            for j, desc in enumerate(stage.cycle):
                cj = None if cache is None else _index(cache[j], i)
                x, a, nc = _apply_block(
                    _index(stage_params[j], i), desc, x, cfg, rules,
                    positions=positions, cache=cj, decode_pos=decode_pos,
                    cross_kv=cross_kv, causal=causal)
                aux = aux + a
                if cj is not None:
                    _write_back(cj, nc)
            if stage.shared_attn and shared is not None:
                sc = None if shared_cache is None else _index(shared_cache, i)
                x, a, _ = _apply_block(
                    shared, SHARED, x, cfg, rules, positions=positions,
                    cache=sc, decode_pos=decode_pos, causal=causal)
                aux = aux + a
            return x, aux

        remat = self.remat and cache is None
        aux = x.new_zeros((), dtype=torch.float32)
        for i in range(stage.n):
            if remat:
                x, aux = checkpoint(body, i, x, aux, use_reentrant=False)
            else:
                x, aux = body(i, x, aux)
        return x, aux

    # -- forward (train / prefill) --------------------------------------------
    def apply(self, params, batch, rules: ShardingRules):
        """batch: dict with 'tokens' [B,S] (+ 'positions', 'patch_embeds',
        'patch_positions', 'frames' as the arch requires).
        Returns (logits [B,S,Vpad] float32, aux dict)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = L.embed(params["embed"], tokens, cfg, rules,
                    scale=cfg.embed_scale)
        if cfg.mrope:
            positions = batch["positions"]          # [B, S, 3]
        else:
            positions = batch.get("positions")
            if positions is None:
                positions = torch.arange(s, device=x.device).expand(b, s)
        if "patch_embeds" in batch:                 # VLM stub frontend
            # per batch row: on a mesh, on each rank's rows
            row = ("batch", None, None)
            x = rules.local(_put_patches, (row, ("batch", None), row),
                            (row,))(x, batch["patch_positions"],
                                    batch["patch_embeds"])
        cross_kv = None
        if cfg.is_encdec:
            cross_kv = self._encode(params, batch["frames"], rules)
            x = x + params["dec_pos"][None, :s].to(x.dtype)
        x = rules.shard(x, "batch", "seq", "act_d_model")
        aux = x.new_zeros((), dtype=torch.float32)
        for stage, sp in zip(self.stages, params["stages"]):
            x, a = self._run_stage(stage, sp, x, rules, positions=positions,
                                   cross_kv=cross_kv,
                                   shared=params.get("shared_attn"))
            aux = aux + a
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, rules)
        return logits, {"moe_aux": aux}

    def _encode(self, params, frames, rules):
        cfg = self.cfg
        b, f, _ = frames.shape
        pos_table = L.sinusoidal_embedding(f, cfg.d_model, frames.device)
        x = rules.shard(frames + pos_table[None].to(frames.dtype),
                        "batch", "seq", "act_d_model")
        positions = torch.arange(f, device=frames.device).expand(b, f)
        for stage, sp in zip(self.encoder_stages, params["enc_stages"]):
            x, _ = self._run_stage(stage, sp, x, rules, positions=positions,
                                   causal=False)
        return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)

    # -- cache ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, *, frames: int = 0,
                   device=None):
        """Per stage: a list over the cycle of stacked caches ``[n, ...]``;
        a stage with the shared block holds ``(that list, the shared
        block's stacked per-invocation cache)``."""
        cfg = self.cfg
        dtype = L.dtype_of(cfg)
        dev = self.device if device is None else torch.device(device)
        caches = []
        for stage in self.stages:
            lead = (stage.n,)
            blk = [_init_block_cache(desc, cfg, lead, batch, cache_len, dtype,
                                     dev, frames=frames)
                   for desc in stage.cycle]
            if stage.shared_attn:
                caches.append((blk, _init_block_cache(
                    SHARED, cfg, lead, batch, cache_len, dtype, dev)))
            else:
                caches.append(blk)
        return caches

    def cache_logical_specs(self):
        """Logical-axis tuples mirroring ``init_cache``'s structure."""
        def block_specs(desc):
            attn_kind, _ = desc
            if attn_kind == "rwkv":
                return dict(tmix_x=("layers", "batch", None),
                            cmix_x=("layers", "batch", None),
                            state=("layers", "batch", "state_heads",
                                   None, None))
            if attn_kind == "mamba":
                return dict(conv=("layers", "batch", None, None),
                            state=("layers", "batch", "state_heads",
                                   None, None))
            c = {"self": dict(
                k=("layers", "batch", "cache_seq", "kv_heads", None),
                v=("layers", "batch", "cache_seq", "kv_heads", None))}
            if attn_kind == "encdec":
                c["ck"] = ("layers", "batch", "frames", "kv_heads", None)
                c["cv"] = ("layers", "batch", "frames", "kv_heads", None)
            return c

        specs = []
        for stage in self.stages:
            blk = [block_specs(desc) for desc in stage.cycle]
            if stage.shared_attn:
                specs.append((blk, block_specs(SHARED)))
            else:
                specs.append(blk)
        return specs

    # -- decode ---------------------------------------------------------------
    def decode_step(self, params, cache, batch, rules: ShardingRules):
        """One-token step.  batch: dict(tokens [B,1], pos [B],
        optional positions [B,1,3] for mrope).
        Returns (logits [B, Vpad] float32, cache advanced in place)."""
        cfg = self.cfg
        tokens, pos = batch["tokens"], batch["pos"]
        x = L.embed(params["embed"], tokens, cfg, rules,
                    scale=cfg.embed_scale)
        positions = batch["positions"] if cfg.mrope else pos[:, None]
        if cfg.is_encdec:
            x = x + params["dec_pos"][pos.long()][:, None].to(x.dtype)
        shared = params.get("shared_attn")
        for stage, sp, sc in zip(self.stages, params["stages"], cache):
            blk, shared_cache = sc if stage.shared_attn else (sc, None)
            x, _ = self._run_stage(stage, sp, x, rules, positions=positions,
                                   cache=blk, decode_pos=pos, shared=shared,
                                   shared_cache=shared_cache)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, rules)
        return logits[:, 0], cache


def make_model(cfg: ModelConfig, remat: bool = False, *,
               device=None) -> Model:
    return Model(cfg, remat=remat, device=device)
