"""The port's AdamW (``repro_torch.train.optimizer``) against a numpy hand
roll of the same float32 arithmetic and against the reference's
``adamw_update`` on one tree of 1-D, 2-D and stacked 3-D leaves, started
from one state carried across with ``interop.train_state_from_jax``'s
leaf map; the learning-rate schedule over warmup and decay; no decay on
1-D leaves; clipping."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.train.optimizer import (
    OptConfig, adamw_init, adamw_update, flatten, global_norm, lr_at,
    master_to_params, unflatten,
)

CFG = OptConfig(lr=0.05, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1,
                grad_clip=1.5, warmup_steps=2, total_steps=8,
                min_lr_ratio=0.1)


def tree(rng):
    """Leaves of every rank the models have, keys out of order."""
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "stack": [{"scale": rng.normal(size=(2, 5)).astype(np.float32),
                       "k": rng.normal(size=(2, 3, 4)).astype(np.float32)}],
            "b": rng.normal(size=(6,)).astype(np.float32)}


def grads_at(step):
    return tree(np.random.default_rng(100 + step))


def to_torch(t):
    return unflatten(t, [torch.from_numpy(x.copy()) for x in flatten(t)])


def numpy_adamw(params, steps, cfg):
    """The reference's update written out in float32 numpy."""
    f = np.float32
    p = flatten(params)
    mu = [np.zeros_like(x) for x in p]
    nu = [np.zeros_like(x) for x in p]
    ma = [x.copy() for x in p]
    for step in range(steps):
        g = flatten(grads_at(step))
        gnorm = np.sqrt(sum(np.sum(np.square(x)) for x in g), dtype=f)
        scale = np.minimum(f(1.0), f(cfg.grad_clip) / (gnorm + f(1e-9)))
        s = f(step)
        warm = (s + f(1.0)) / f(max(cfg.warmup_steps, 1))
        prog = np.clip((s - f(cfg.warmup_steps))
                       / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       f(0), f(1))
        cos = f(cfg.min_lr_ratio) + f((1 - cfg.min_lr_ratio) * 0.5) * (
            f(1) + np.cos(f(np.pi) * prog))
        lr = f(cfg.lr) * (warm if s < cfg.warmup_steps else cos)
        t = f(step + 1)
        bc1, bc2 = f(1) - f(cfg.b1) ** t, f(1) - f(cfg.b2) ** t
        for i, gi in enumerate(g):
            gi = gi * scale
            mu[i] = f(cfg.b1) * mu[i] + f(1 - cfg.b1) * gi
            nu[i] = f(cfg.b2) * nu[i] + f(1 - cfg.b2) * np.square(gi)
            step_dir = (mu[i] / bc1) / (np.sqrt(nu[i] / bc2) + f(cfg.eps))
            decay = f(cfg.weight_decay) if ma[i].ndim >= 2 else f(0)
            ma[i] = ma[i] - lr * (step_dir + decay * ma[i])
    return mu, nu, ma


def port_adamw(params, steps, cfg):
    opt = adamw_init(to_torch(params))
    for step in range(steps):
        opt, _ = adamw_update(to_torch(grads_at(step)), opt, cfg,
                              torch.tensor(step, dtype=torch.int32))
    return opt


def test_adamw_matches_numpy_hand_roll():
    params = tree(np.random.default_rng(0))
    opt = port_adamw(params, 5, CFG)
    for name, want in zip(("mu", "nu", "master"),
                          numpy_adamw(params, 5, CFG)):
        for got, w in zip(flatten(opt[name]), want):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-9,
                                       err_msg=name)


def test_adamw_matches_reference():
    import jax
    import jax.numpy as jnp
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro.train.optimizer import adamw_init as j_init
    from repro.train.optimizer import adamw_update as j_update
    params = tree(np.random.default_rng(0))
    jcfg = JOptConfig(**dataclasses.asdict(CFG))
    jopt = j_init(jax.tree_util.tree_map(jnp.asarray, params))
    for step in range(5):
        jopt, jm = j_update(jax.tree_util.tree_map(jnp.asarray,
                                                   grads_at(step)),
                            jopt, jcfg, jnp.asarray(step, jnp.int32))
    opt = port_adamw(params, 4, CFG)
    opt, m = adamw_update(to_torch(grads_at(4)), opt, CFG,
                          torch.tensor(4, dtype=torch.int32))
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
    for name in ("mu", "nu", "master"):
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jopt[name])]
        got = flatten(opt[name])
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            # an element that five steps of mixed-sign gradients cancel
            # keeps the rounding of its larger terms: atol is rtol times
            # the leaf's largest element
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)


def test_lr_schedule_matches_reference():
    import jax.numpy as jnp
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro.train.optimizer import lr_at as j_lr_at
    for cfg in (CFG, dataclasses.replace(CFG, warmup_steps=0),
                OptConfig(lr=3e-3, warmup_steps=10, total_steps=200)):
        jcfg = JOptConfig(**dataclasses.asdict(cfg))
        steps = np.arange(cfg.total_steps + 5, dtype=np.int32)
        got = lr_at(cfg, torch.from_numpy(steps)).numpy()
        want = np.asarray(j_lr_at(jcfg, jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        w = cfg.warmup_steps
        # warmup starts at lr / warmup_steps and climbs linearly
        np.testing.assert_allclose(got[:w], cfg.lr * (steps[:w] + 1) / w,
                                   rtol=1e-6)
        # cosine from lr down to min_lr_ratio * lr, then flat
        np.testing.assert_allclose(got[w], cfg.lr, rtol=1e-6)
        assert np.all(np.diff(got[w:cfg.total_steps + 1]) < 0)
        np.testing.assert_allclose(got[cfg.total_steps:],
                                   cfg.lr * cfg.min_lr_ratio, rtol=1e-5)


def test_weight_decay_skips_1d_params():
    cfg = OptConfig(lr=0.1, weight_decay=0.5, grad_clip=1e9,
                    warmup_steps=0)
    params = {"w": torch.ones((2, 2)), "scale": torch.ones((2,)),
              "stacked": torch.ones((3, 2, 2))}
    opt = adamw_init(params)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    opt, _ = adamw_update(zero_g, opt, cfg, torch.tensor(0))
    assert torch.equal(opt["master"]["scale"], params["scale"])
    assert (opt["master"]["w"] < 1).all()          # decayed
    assert (opt["master"]["stacked"] < 1).all()
    np.testing.assert_allclose(opt["master"]["w"].numpy(), 1 - 0.1 * 0.5,
                               rtol=1e-6)


def test_clipping_engages():
    """Past ``grad_clip`` the gradients are scaled to norm ``grad_clip``:
    a gradient 100x larger leaves the same moments as one already at the
    clip norm; below it nothing is scaled."""
    cfg = OptConfig(lr=0.1, grad_clip=1.0, warmup_steps=0)
    g = {"w": torch.tensor([[3.0, 4.0]]), "b": torch.tensor([0.0])}
    at_clip = {k: v / 5.0 for k, v in g.items()}
    big = {k: v * 100.0 for k, v in g.items()}
    params = {"w": torch.zeros((1, 2)), "b": torch.zeros((1,))}
    step = torch.tensor(0)
    a, ma = adamw_update(big, adamw_init(params), cfg, step)
    b, mb = adamw_update(at_clip, adamw_init(params), cfg, step)
    np.testing.assert_allclose(ma["grad_norm"].item(), 500.0, rtol=1e-6)
    np.testing.assert_allclose(a["mu"]["w"].numpy(), b["mu"]["w"].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(a["mu"]["w"].numpy(),
                               [[0.1 * 0.6, 0.1 * 0.8]], rtol=1e-6)
    small = {k: v / 50.0 for k, v in g.items()}
    c, _ = adamw_update(small, adamw_init(params), cfg, step)
    np.testing.assert_allclose(c["mu"]["w"].numpy(),
                               [[0.1 * 0.06, 0.1 * 0.08]], rtol=1e-6)


def test_state_dtypes_and_tree_order():
    """Moments and masters are float32 whatever the params' dtype; the
    params come back in the model dtype; leaves are visited with dict keys
    sorted (the reference's order), so the global norm sums as it does."""
    params = {"z": torch.ones((2, 2), dtype=torch.bfloat16),
              "a": [torch.full((3,), 2.0, dtype=torch.bfloat16)]}
    opt = adamw_init(params)
    assert all(x.dtype == torch.float32 for name in ("mu", "nu", "master")
               for x in flatten(opt[name]))
    assert [tuple(x.shape) for x in flatten(params)] == [(3,), (2, 2)]
    back = master_to_params(opt, torch.bfloat16)
    assert list(back) == ["z", "a"]
    assert all(torch.equal(x, y) for x, y in zip(flatten(back),
                                                 flatten(params)))
    np.testing.assert_allclose(global_norm(params).item(), np.sqrt(16.0))


@pytest.mark.parametrize("steps", [1, 5])
def test_master_drives_params(steps):
    """Params are the masters cast to the model dtype after every step,
    and the masters do not alias the initial params."""
    params = to_torch(tree(np.random.default_rng(1)))
    before = [x.clone() for x in flatten(params)]
    opt = adamw_init(params)
    for step in range(steps):
        opt, _ = adamw_update(to_torch(grads_at(step)), opt, CFG,
                              torch.tensor(step))
    assert all(torch.equal(x, y) for x, y in zip(flatten(params), before))
    new = master_to_params(opt, torch.bfloat16)
    for p, m in zip(flatten(new), flatten(opt["master"])):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, m.to(torch.bfloat16))
