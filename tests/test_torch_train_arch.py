"""The port's training step against the reference's on all ten reduced
architectures, in float32 (``dataclasses.replace(cfg, dtype="float32")``
in both packages: the reduced configs default to bfloat16).  One state,
made by the reference's ``init_train_state`` and carried across with
``interop.train_state_from_jax``, and one batch (``concrete_batch``,
patch positions made unique), then:

* ``loss_fn`` equals the reference's (rtol 1e-5), its ``ce`` and
  ``moe_aux`` too;
* every gradient leaf equals ``jax.grad``'s within rtol 1e-4 and atol
  1e-6, measured on the leaf as a whole (Frobenius norm of the
  difference against the reference's): float32 gradients that cancel
  differ element by element in the last bits of a different summation
  order (reduced zamba2's tied embedding: 3 of 131,072 elements miss an
  elementwise 1e-4 / 1e-6 by up to 2.5e-6, with leaves near 0.66);
* the reference's gradients fed to the port's ``adamw_update`` give the
  reference's new state (mu, nu, master; rtol 1e-6, atol 1e-9: a
  master element near zero moves by about lr = 1e-3, whose last bits
  round apart in the two packages).  The optimizer is
  held apart from the gradients because AdamW's first step is about
  ``lr * sign(g)``, which tiny gradient differences flip.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import all_arch_names, get_reduced
from repro_torch.interop import train_state_from_jax
from repro_torch.models.model import make_model
from repro_torch.sharding.rules import make_rules
from repro_torch.train.loop import loss_fn
from repro_torch.train.optimizer import (
    OptConfig, adamw_update, flatten, unflatten,
)

from test_torch_lm_arch import SMALL, f32, torch_batch, unique_patches

RULES = make_rules(None)


def _leaves(tree):
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", all_arch_names())
def test_loss_grads_and_update_match_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as j_get_reduced
    from repro.configs.shapes import concrete_batch as j_concrete_batch
    from repro.models.model import make_model as j_make_model
    from repro.sharding.rules import make_rules as j_make_rules
    from repro.train.loop import init_train_state as j_init
    from repro.train.loop import loss_fn as j_loss_fn
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro.train.optimizer import adamw_update as j_adamw_update
    cj, ct = f32(j_get_reduced(arch)), f32(get_reduced(arch))
    jm, tm = j_make_model(cj, remat=True), make_model(ct, remat=True,
                                                      device="cpu")
    jstate = jax.jit(lambda k: j_init(jm, k))(jax.random.PRNGKey(1))
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 ct, device="cpu")
    batch = unique_patches({k: np.asarray(v) for k, v in
                            j_concrete_batch(cj, SMALL, seed=2).items()})

    jr = j_make_rules(None)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(jm, p, b, jr), has_aux=True))(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.detach().requires_grad_(True)
              for p in flatten(state["params"])]
    loss, met = loss_fn(tm, unflatten(state["params"], leaves),
                        torch_batch(batch), RULES)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "moe_aux"):
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    jg = _leaves(jgrads)
    assert len(jg) == len(grads)
    for i, (g, want) in enumerate(zip(grads, jg)):
        assert g.shape == want.shape, i
        err = np.linalg.norm((g.numpy() - want).ravel())
        assert err <= 1e-4 * np.linalg.norm(want.ravel()) + 1e-6, (
            arch, i, err, np.linalg.norm(want.ravel()))

    cfg_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt, jm_ = jax.jit(lambda g, o, s: j_adamw_update(
        g, o, JOptConfig(**cfg_kw), s))(jgrads, jstate["opt"],
                                        jstate["step"])
    tg = unflatten(state["params"], [torch.from_numpy(np.array(x))
                                      for x in jg])
    opt, met = adamw_update(tg, state["opt"], OptConfig(**cfg_kw),
                            state["step"])
    np.testing.assert_allclose(met["grad_norm"].item(),
                               float(jm_["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(met["lr"].item(), float(jm_["lr"]), rtol=1e-6)
    for name in ("mu", "nu", "master"):
        for got, want in zip(flatten(opt[name]), _leaves(jopt[name])):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-9, err_msg=(arch, name))
