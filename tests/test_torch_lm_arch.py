"""All ten architectures on the port against the reference:

* ``get_config`` / ``get_reduced`` equal field for field;
* reduced configs in float32, the reference's parameters carried across
  with ``interop.lm_params_from_jax``: forward logits and two decode steps
  within rtol = atol = 1e-4 of the reference's;
* the reference's teacher-forcing property (tests/test_arch_smoke.py) on
  the port: cached decode reproduces the forward position by position;
* bfloat16 forward and decode shapes and finiteness, as the reference's
  smoke test.

The ``cuda`` case holds a model on the card against the CPU in float32
with TF32 off (``pytest -m cuda`` there; jax is imported only inside the
tests that compare with it)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import all_arch_names, get_config, get_reduced
from repro_torch.configs.shapes import ShapeSpec, concrete_batch
from repro_torch.interop import lm_params_from_jax
from repro_torch.models.layers import padded_vocab
from repro_torch.models.model import make_model
from repro_torch.sharding.rules import make_rules

RULES = make_rules(None)
SMALL = ShapeSpec("small_train", "train", 16, 2)
TOL = dict(rtol=1e-4, atol=1e-4)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def unique_patches(batch, seed=1):
    """Patch positions without repeats: a repeated position makes the
    scatter's winner unspecified in both packages."""
    if "patch_positions" in batch:
        b, n = batch["patch_positions"].shape
        rng = np.random.default_rng(seed)
        pp = np.stack([rng.permutation(n) for _ in range(b)]).astype(
            np.int32)
        old = batch["patch_positions"]
        batch["patch_positions"] = (torch.from_numpy(pp).to(old.device)
                                    if isinstance(old, torch.Tensor) else pp)
    return batch


def torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", all_arch_names())
def test_configs_equal_reference(arch):
    from repro.configs import get_config as j_get_config
    from repro.configs import get_reduced as j_get_reduced
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        j_get_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(
        j_get_reduced(arch))


@pytest.mark.parametrize("arch", all_arch_names())
def test_forward_and_decode_match_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as j_get_reduced
    from repro.configs.shapes import concrete_batch as j_concrete_batch
    from repro.models.model import make_model as j_make_model
    from repro.sharding.rules import make_rules as j_make_rules
    jr = j_make_rules(None)
    cj, ct = f32(j_get_reduced(arch)), f32(get_reduced(arch))
    jm, tm = j_make_model(cj), make_model(ct, device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), ct,
                            device="cpu")
    batch = unique_patches({k: np.asarray(v) for k, v in
                            j_concrete_batch(cj, SMALL, seed=2).items()})
    want = jax.jit(lambda p, b: jm.apply(p, b, jr)[0])(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, aux = tm.apply(tp, torch_batch(batch), RULES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.dtype == torch.float32 and aux["moe_aux"].shape == ()

    b, cache_len = 2, 16
    frames = cj.max_source_positions if cj.is_encdec else 0
    jc = jm.init_cache(b, cache_len, frames=frames)
    tc = tm.init_cache(b, cache_len, frames=frames)
    step = jax.jit(lambda p, c, bt: jm.decode_step(p, c, bt, jr))
    for i in range(2):
        db = {"tokens": np.array([[1 + i], [7 + i]], np.int32),
              "pos": np.array([i, i + 3], np.int32)}
        if cj.mrope:
            db["positions"] = np.full((b, 1, 3), i, np.int32)
        want, jc = step(jp, jc, {k: jnp.asarray(v) for k, v in db.items()})
        with torch.no_grad():
            got, tc = tm.decode_step(tp, tc, torch_batch(db), RULES)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"{arch} decode step {i}")


@pytest.mark.parametrize("arch", ["gemma2-9b", "yi-6b", "rwkv6-1.6b",
                                  "zamba2-1.2b", "mixtral-8x22b"])
def test_decode_matches_teacher_forcing(arch):
    """The reference's cache-parity property, on the port: one token at a
    time through the cache gives the forward's logits at every position."""
    cfg = f32(get_reduced(arch))
    model = make_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    b, s = 2, 8
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        full, _ = model.apply(params, {"tokens": toks}, RULES)
        cache = model.init_cache(b, s)
        for i in range(s):
            batch = {"tokens": toks[:, i:i + 1],
                     "pos": torch.full((b,), i, dtype=torch.int32)}
            logits, cache = model.decode_step(params, cache, batch, RULES)
            np.testing.assert_allclose(
                logits.numpy(), full[:, i].numpy(), **TOL,
                err_msg=f"{arch} decode diverges from forward at {i}")


@pytest.mark.parametrize("arch", all_arch_names())
def test_bf16_forward_and_decode_shapes_finite(arch):
    cfg = get_reduced(arch)
    model = make_model(cfg, device="cpu")
    params = model.init(seed=0)
    batch = unique_patches(concrete_batch(
        cfg, ShapeSpec("small_train", "train", 32, 2), device="cpu"))
    with torch.no_grad():
        logits, _ = model.apply(params, batch, RULES)
    seq = 32 // 4 if cfg.is_encdec else 32
    assert logits.shape == (2, seq, padded_vocab(cfg))
    assert bool(torch.isfinite(logits).all()), "NaN/inf in logits"
    frames = cfg.max_source_positions if cfg.is_encdec else 0
    cache = model.init_cache(2, 16, frames=frames)
    db = {"tokens": torch.tensor([[1], [2]], dtype=torch.int32),
          "pos": torch.tensor([0, 3], dtype=torch.int32)}
    if cfg.mrope:
        db["positions"] = torch.zeros((2, 1, 3), dtype=torch.int32)
    with torch.no_grad():
        logits, _ = model.decode_step(params, cache, db, RULES)
    assert logits.shape == (2, padded_vocab(cfg))
    assert bool(torch.isfinite(logits).all())


def test_params_live_where_the_model_does():
    cfg = get_reduced("gemma2-9b")
    model = make_model(cfg, device="cpu")
    params = model.init(seed=0)
    for stage in params["stages"]:
        for block in stage:
            assert block["attn"]["wq"].shape[0] == model.stages[0].n
    with pytest.raises(ValueError):    # another architecture's tree
        lm_params_from_jax(params, get_reduced("yi-6b"), device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card run of the models")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", all_arch_names())
def test_cuda_matches_cpu(cuda_device, arch):
    cfg = f32(get_reduced(arch))
    cpu, card = make_model(cfg, device="cpu"), make_model(cfg,
                                                          device=cuda_device)
    params = cpu.init(seed=5)
    params_card = lm_params_from_jax(params, cfg, device=cuda_device)
    batch = unique_patches(concrete_batch(cfg, SMALL, seed=6, device="cpu"))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want, _ = cpu.apply(params, batch, RULES)
            got, _ = card.apply(params_card, {
                k: v.to(cuda_device) for k, v in batch.items()}, RULES)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
