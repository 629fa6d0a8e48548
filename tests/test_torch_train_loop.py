"""The port's training loop (``repro_torch.train.loop``) and the pieces
under it, the twin of tests/test_train_loop.py:

* ``chunked_gla`` (the models' plain GLA, under autograd) forward and
  gradients against ``ref_recurrent_gla``, the step-by-step oracle, and
  that oracle against the reference's;
* remat on equals remat off bit for bit on the CPU (zamba2's shared block
  and whisper's encoder inside the checkpointed steps);
* ``microbatches=2`` equals one batch (loss, metrics and the accumulated
  gradients through the first moments, rtol 1e-5);
* the loss drops on learnable data, and a run resumed from the block
  store continues bit for bit.

Reduced configs; float32 (``dataclasses.replace(cfg, dtype="float32")``)
wherever values are compared, the reduced configs' bfloat16 elsewhere."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec, concrete_batch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.linear_attention import chunked_gla, ref_recurrent_gla
from repro_torch.models.model import make_model
from repro_torch.sharding.rules import make_rules
from repro_torch.train.loop import (
    checkpoint_template, init_train_state, make_eval_step, make_prefill_step,
    make_train_step,
)
from repro_torch.train.optimizer import OptConfig, flatten

RULES = make_rules(None)
SMALL = ShapeSpec("small_train", "train", 16, 2)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def pipe_batch(pipe, i):
    toks, tgt = pipe.batch_at(i)
    return {"tokens": torch.from_numpy(toks),
            "targets": torch.from_numpy(tgt)}


# ---------------------------------------------------------------------------
# chunked GLA under autograd
# ---------------------------------------------------------------------------

GLA_CASES = {
    # Mamba2: per-head scalar decay, current token included
    "mamba": dict(dk=8, decay_dim=1, include_current=True, bonus=False),
    # RWKV6: per-channel decay, current token through the bonus u
    "rwkv": dict(dk=8, decay_dim=8, include_current=False, bonus=True),
}


def gla_inputs(case, seed=0):
    c = GLA_CASES[case]
    rng = np.random.default_rng(seed)
    b, h, t, dv = 2, 3, 16, 4
    q = rng.normal(size=(b, h, t, c["dk"]))
    k = rng.normal(size=(b, h, t, c["dk"]))
    v = rng.normal(size=(b, h, t, dv))
    w = -np.exp(rng.normal(size=(b, h, t, c["decay_dim"])) - 1.0)
    state = rng.normal(size=(b, h, c["dk"], dv))
    u = rng.normal(size=(h, c["dk"])) if c["bonus"] else None
    arrs = dict(q=q, k=k, v=v, w=w, state=state, u=u)
    return {n: None if a is None else a.astype(np.float32)
            for n, a in arrs.items()}, c["include_current"]


def _gla_outputs(fn, x, include_current, **kw):
    ts = {n: None if a is None else torch.from_numpy(a).requires_grad_(True)
          for n, a in x.items()}
    y, s = fn(ts["q"], ts["k"], ts["v"], ts["w"], state=ts["state"],
              include_current=include_current, bonus=ts["u"], **kw)
    rng = np.random.default_rng(9)
    probe = (torch.sum(y * torch.from_numpy(
        rng.normal(size=y.shape).astype(np.float32)))
        + torch.sum(s * torch.from_numpy(
            rng.normal(size=s.shape).astype(np.float32))))
    names = [n for n in ts if ts[n] is not None]
    grads = torch.autograd.grad(probe, [ts[n] for n in names])
    return y.detach(), s.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("case", sorted(GLA_CASES))
def test_chunked_gla_forward_and_grads_match_recurrence(case):
    x, inc = gla_inputs(case)
    y, s, g = _gla_outputs(chunked_gla, x, inc, chunk=4)
    ry, rs, rg = _gla_outputs(ref_recurrent_gla, x, inc)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), rtol=1e-4, atol=1e-5)
    assert g.keys() == rg.keys()
    for n in g:
        np.testing.assert_allclose(g[n].numpy(), rg[n].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=n)


@pytest.mark.parametrize("case", sorted(GLA_CASES))
def test_recurrence_matches_reference(case):
    import jax.numpy as jnp
    from repro.models.linear_attention import (
        ref_recurrent_gla as j_ref_recurrent_gla,
    )
    x, inc = gla_inputs(case, seed=1)
    j = {n: None if a is None else jnp.asarray(a) for n, a in x.items()}
    jy, js = j_ref_recurrent_gla(j["q"], j["k"], j["v"], j["w"],
                                 state=j["state"], include_current=inc,
                                 bonus=j["u"])
    t = {n: None if a is None else torch.from_numpy(a) for n, a in x.items()}
    y, s = ref_recurrent_gla(t["q"], t["k"], t["v"], t["w"],
                             state=t["state"], include_current=inc,
                             bonus=t["u"])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# remat, accumulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-medium"])
def test_remat_equals_no_remat_bit_for_bit(arch):
    cfg = f32(get_reduced(arch))
    batch = concrete_batch(cfg, SMALL, seed=2, device="cpu")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    out = []
    for remat in (False, True):
        model = make_model(cfg, remat=remat, device="cpu")
        state = init_train_state(model, seed=3)
        step = make_train_step(model, opt_cfg, RULES)
        out.append(step(state, batch))
    (s0, m0), (s1, m1) = out
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for name in ("mu", "nu", "master"):
        for a, b in zip(flatten(s0["opt"][name]), flatten(s1["opt"][name])):
            assert torch.equal(a, b), name
    assert int(s1["step"]) == 1


def test_remat_recomputes_in_backward(monkeypatch):
    """With remat the blocks' forward runs again during the backward pass
    (once more per checkpointed step); decode never checkpoints."""
    from repro_torch.models import model as model_mod
    cfg = f32(get_reduced("zamba2-1.2b"))
    batch = concrete_batch(cfg, SMALL, seed=2, device="cpu")
    calls = []
    real = model_mod._apply_block
    monkeypatch.setattr(model_mod, "_apply_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    counts = {}
    for remat in (False, True):
        model = make_model(cfg, remat=remat, device="cpu")
        state = init_train_state(model, seed=3)
        calls.clear()
        make_train_step(model, OptConfig(), RULES)(state, batch)
        counts[remat] = len(calls)
    assert counts[True] == 2 * counts[False]
    model = make_model(cfg, remat=True, device="cpu")
    params = model.init(seed=0)
    cache = model.init_cache(2, 4)
    calls.clear()
    with torch.no_grad():
        model.decode_step(params, cache, {
            "tokens": torch.tensor([[1], [2]]),
            "pos": torch.tensor([0, 0])}, RULES)
    assert len(calls) == counts[False]


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-1.2b"])
def test_grad_accumulation_equivalent(arch):
    """Per leaf; zamba2 adds the Mamba2 leaves (``A_log``, ``D``,
    ``dt_bias``, the conv) and the shared attention block."""
    cfg = f32(get_reduced(arch))
    model = make_model(cfg, device="cpu")
    state = init_train_state(model, seed=2)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0)
    pipe = TokenPipeline(cfg.vocab_size, 16, 8, seed=3)
    batch = pipe_batch(pipe, 0)
    st1, m1 = make_train_step(model, opt_cfg, RULES, microbatches=1)(
        state, batch)
    st2, m2 = make_train_step(model, opt_cfg, RULES, microbatches=2)(
        state, batch)
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(m1[k].item(), m2[k].item(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # the first moments are (1 - b1) * the clipped gradients
    for a, b in zip(flatten(st1["opt"]["mu"]), flatten(st2["opt"]["mu"])):
        err = torch.linalg.vector_norm(a - b).item()
        assert err <= 1e-5 * torch.linalg.vector_norm(a).item() + 1e-9
    # parameters agree to accumulation-order tolerance (the reference's)
    for a, b in zip(flatten(st1["params"]), flatten(st2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2,
                                   atol=5e-3)
    # the state the steps were given is not written
    fresh = init_train_state(model, seed=2)
    for a, b in zip(flatten(state), flatten(fresh)):
        assert torch.equal(a, b)


def test_accumulation_splits_every_batch_leaf():
    """qwen2-vl's batch carries M-RoPE positions and patches beside the
    tokens; each is split along its leading axis."""
    cfg = f32(get_reduced("qwen2-vl-7b"))
    model = make_model(cfg, device="cpu")
    state = init_train_state(model, seed=0)
    batch = concrete_batch(cfg, ShapeSpec("t", "train", 16, 4), seed=2,
                           device="cpu")
    rng = np.random.default_rng(1)
    b, n = batch["patch_positions"].shape
    batch["patch_positions"] = torch.from_numpy(np.stack(
        [rng.permutation(n) for _ in range(b)]).astype(np.int32))
    _, m1 = make_train_step(model, OptConfig(), RULES)(state, batch)
    _, m2 = make_train_step(model, OptConfig(), RULES, microbatches=2)(
        state, batch)
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# training: descent, resume, eval and prefill
# ---------------------------------------------------------------------------

def test_loss_decreases_on_learnable_data():
    cfg = get_reduced("yi-6b")
    model = make_model(cfg, device="cpu")
    state = init_train_state(model, seed=0)
    step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=100), RULES)
    pipe = TokenPipeline(cfg.vocab_size, 16, 8, seed=1)
    losses = []
    for i in range(30):
        state, metrics = step(state, pipe_batch(pipe, i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[::6]
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 30
    assert all(p.dtype == torch.bfloat16 for p in flatten(state["params"]))


def test_checkpoint_resume_training(tmp_path):
    """Restart from the block store resumes bit for bit (paper §3.2
    contract applied to the train loop): restored into
    ``checkpoint_template`` of a fresh state, the state repeats step 4
    exactly."""
    cfg = get_reduced("zamba2-1.2b")
    model = make_model(cfg, remat=True, device="cpu")
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=0), RULES,
                           microbatches=2)
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=4)
    state = init_train_state(model, seed=5)
    mgr = CheckpointManager(str(tmp_path))
    for i in range(3):
        state, _ = step(state, pipe_batch(pipe, i))
    mgr.save(state, step=3)
    state4, m4 = step(state, pipe_batch(pipe, 3))

    # "crash"; restore into a fresh state and redo step 4
    fresh = init_train_state(model, seed=0)
    got_step, restored = mgr.restore_into(checkpoint_template(fresh, model))
    assert got_step == 3 and int(restored["step"]) == 3
    state4b, m4b = step(restored, pipe_batch(pipe, 3))
    assert torch.equal(m4["loss"], m4b["loss"])
    for a, b in zip(flatten(state4), flatten(state4b)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the fresh state itself keeps Mamba2's float32 leaves, which a step
    # casts to the model dtype: restored into it the run would drift
    _, cast = mgr.restore_into(fresh)
    assert cast["params"]["stages"][0][0]["A_log"].dtype == torch.float32
    assert state["params"]["stages"][0][0]["A_log"].dtype == torch.bfloat16
    _, m4c = step(cast, pipe_batch(pipe, 3))
    assert not torch.equal(m4["loss"], m4c["loss"])


def test_eval_and_prefill_steps():
    cfg = f32(get_reduced("rwkv6-1.6b"))
    model = make_model(cfg, device="cpu")
    state = init_train_state(model, seed=0)
    batch = concrete_batch(cfg, SMALL, seed=2, device="cpu")
    m = make_eval_step(model, RULES)(state["params"], batch)
    _, tm = make_train_step(model, OptConfig(), RULES)(state, batch)
    assert torch.equal(m["loss"], tm["loss"]) and not m["loss"].requires_grad
    last = make_prefill_step(model, RULES)(state["params"], batch)
    with torch.no_grad():
        logits, _ = model.apply(state["params"], batch, RULES)
    assert torch.equal(last, logits[:, -1])
