"""LM serving on the port against the reference: ``ServeSession.generate``
gives the reference's tokens in float32 for the serving example's three
architectures (attention, SSM, hybrid) on the reference's parameters;
``make_prefill_and_decode``'s prefill picks the reference's tokens;
greedy sampling never picks a padded id; ``topk_sample``'s draws stay in
the top k (its random stream is torch's, not jax's); and the sharding
rules are a no-op on one card and place by mesh axis on a device mesh."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_jax
from repro_torch.models.model import make_model
from repro_torch.serve.engine import (
    ServeSession, greedy_sample, make_prefill_and_decode, topk_sample,
)
from repro_torch.sharding.rules import make_rules

RULES = make_rules(None)


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b", "zamba2-1.2b"])
def test_generate_matches_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as j_get_reduced
    from repro.models.model import make_model as j_make_model
    from repro.serve.engine import ServeSession as JServeSession
    from repro.serve.engine import make_prefill_and_decode as j_prefill
    from repro.sharding.rules import make_rules as j_make_rules
    cj = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    ct = dataclasses.replace(get_reduced(arch), dtype="float32")
    jm, tm = j_make_model(cj), make_model(ct, device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), ct,
                            device="cpu")
    batch, prompt_len, gen = 4, 8, 12
    prompts = np.random.default_rng(0).integers(
        0, cj.vocab_size, (batch, prompt_len), dtype=np.int32)
    want = JServeSession(jm, jp, j_make_rules(None), batch=batch,
                         cache_len=prompt_len + gen + 1).generate(prompts, gen)
    got = ServeSession(tm, tp, RULES, batch=batch,
                       cache_len=prompt_len + gen + 1).generate(prompts, gen)
    assert got.shape == (batch, gen) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)

    prefill, _ = make_prefill_and_decode(tm, RULES)
    j_pre, _ = j_prefill(jm, j_make_rules(None))
    with torch.no_grad():
        first = prefill(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_array_equal(
        first.numpy(), np.asarray(j_pre(jp, {"tokens": jnp.asarray(prompts)})))


def padded_logits(vocab=500, padded=512, batch=6, seed=0):
    """Logits whose largest entries sit on padded ids."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((batch, padded), generator=g)
    logits[:, vocab:] = 100.0
    return logits


def test_greedy_sample_masks_padded_ids():
    logits = padded_logits()
    tok = greedy_sample(logits, 500)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(),
                                  logits[:, :500].argmax(-1).numpy())


@pytest.mark.parametrize("k,temperature", [(1, 1.0), (5, 0.7), (40, 2.0)])
def test_topk_sample_support(k, temperature):
    logits = padded_logits(batch=64, seed=k)
    top = torch.topk(logits[:, :500], k, dim=-1).indices
    gen = torch.Generator().manual_seed(7)
    for _ in range(20):
        tok = topk_sample(logits, gen, 500, k=k, temperature=temperature)
        assert tok.shape == (64,) and tok.dtype == torch.int32
        assert bool((tok < 500).all()), "drew a padded id"
        assert bool((top == tok[:, None].long()).any(-1).all()), \
            "drew outside the top k"
    if k == 1:      # the support is the argmax alone
        np.testing.assert_array_equal(tok.numpy(),
                                      greedy_sample(logits, 500).numpy())


def test_make_rules_with_a_mesh_is_the_training_slice():
    """The one-card rules stay a no-op; on a ('data', 'model') device mesh
    (the training slice's) ``make_rules`` gives the reference's default
    table and DTensor placements by mesh axis name."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard
    rules = make_rules(None, batch="data")
    x = torch.ones(2, 3)
    assert rules.shard(x, "batch", None) is x
    assert rules.spec("batch", "seq") == ("data", None)
    assert rules.logical_size("batch") == 1
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                      mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)
    on = make_rules(mesh)
    assert on.mesh is mesh
    assert on.spec("batch", "d_model", "heads", "vocab", "seq") == (
        "data", "data", "model", "model", None)
    assert on.placements("batch", "seq", "heads") == (Shard(0), Shard(2))
    assert on.placements("d_model", "d_ff") == (Shard(0), Shard(1))
    assert on.placements("seq", "head_dim") == (Replicate(), Replicate())
    assert on.logical_size("batch") == 2 and on.logical_size("d_ff") == 4
