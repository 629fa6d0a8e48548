"""Assigned input-shape set and per-(arch x shape) input specs.

Every LM arch is paired with four shapes:
    train_4k     seq_len=4096   global_batch=256   (training)
    prefill_32k  seq_len=32768  global_batch=32    (inference prefill)
    decode_32k   seq_len=32768  global_batch=128   (one-token decode step,
                                                    KV/state cache of seq_len)
    long_500k    seq_len=524288 global_batch=1     (long-context decode —
                                                    sub-quadratic archs only)

The port's copy of ``repro.configs.shapes``: where the reference hands out
``jax.ShapeDtypeStruct`` stand-ins, ``batch_specs`` / ``cache_specs`` give
``(shape, dtype)`` pairs (dtype a numpy dtype name), and ``concrete_batch``
draws the same numpy values for the same seed, as tensors on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # 'train' | 'prefill' | 'decode' | 'long_decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "long_decode", 524_288, 1),
}


def cell_applicability(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """Returns a skip reason, or None if the (arch, shape) cell runs."""
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return ("full-attention arch: long_500k needs sub-quadratic decode "
                "state (see DESIGN.md)")
    if shape.kind in ("decode", "long_decode") and not cfg.has_decode:
        return "arch has no decode step"
    return None


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``(shape, dtype name)`` of the *data* inputs of the step.

    train/prefill: full-sequence batch;  decode/long_decode: one-token step
    (the cache is described separately by ``cache_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    i32, f = "int32", cfg.dtype
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": ((b, s), i32)}
        if shape.kind == "train":
            batch["targets"] = ((b, s), i32)
        if cfg.mrope:
            batch["positions"] = ((b, s, 3), i32)
        if cfg.family == "vlm":
            n_patch = min(s // 4, 1024)
            batch["patch_embeds"] = ((b, n_patch, cfg.d_model), f)
            batch["patch_positions"] = ((b, n_patch), i32)
        if cfg.is_encdec:
            # audio stub frontend: precomputed frame embeddings; the decoder
            # sequence is seq_len // 4 (4:1 frame-to-token ratio)
            batch["frames"] = ((b, s, cfg.d_model), f)
            batch["tokens"] = ((b, s // 4), i32)
            if shape.kind == "train":
                batch["targets"] = ((b, s // 4), i32)
        return batch
    # decode kinds: one new token
    batch = {"tokens": ((b, 1), i32), "pos": ((b,), i32)}
    if cfg.mrope:
        batch["positions"] = ((b, 1, 3), i32)
    return batch


def cache_specs(model, cfg: ModelConfig, shape: ShapeSpec):
    """``(shape, dtype)`` of every decode-cache leaf, in ``init_cache``'s
    structure, without allocating (the cache is built on the meta device)."""
    frames = cfg.max_source_positions if cfg.is_encdec else 0
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             frames=frames, device="meta")

    def spec(x):
        if isinstance(x, dict):
            return {k: spec(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(spec(v) for v in x)
        return tuple(x.shape), x.dtype
    return spec(cache)


_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32,
                 "bfloat16": torch.bfloat16, "float16": torch.float16}


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                   device=None) -> dict:
    """Small concrete batch for smoke tests: the reference's numpy draws,
    as tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    specs = batch_specs(cfg, shape)
    out = {}
    for k, (shp, dt) in specs.items():
        if dt == "int32":
            hi = cfg.vocab_size if "token" in k or "target" in k else \
                max(shp[-1] if k == "patch_positions" else shape.seq_len, 2)
            if k == "pos":
                hi = shape.seq_len
            if k == "patch_positions":
                hi = shape.seq_len // 4 if shape.kind == "train" else shape.seq_len
            out[k] = torch.from_numpy(
                rng.integers(0, hi, shp).astype(np.int32)).to(dev)
        else:
            out[k] = torch.from_numpy(rng.normal(0, 1, shp)).to(
                dev, _TORCH_DTYPES[dt])
    return out
