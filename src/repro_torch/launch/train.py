"""Training launcher, the port's twin of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --reduced --steps 100 --ckpt /tmp/ckpt [--resume] \
        [--batch 8 --seq 64] [--microbatches 2] [--device cpu]

Trains on one card (``--device`` names another torch device), reduced
configs without remat and full ones with it.  The loop checkpoints every
``--ckpt-every`` steps through the copy-on-write block store and resumes
losing at most one step (paper §3.2 contract); each step's batch is a pure
function of (seed, step), so a resumed run sees the batches it would have.

``--mesh`` trains on the production mesh (``launch.mesh``) with the
arch's sharding plan (``plan_for(cfg, "train", mesh)``), as the
reference does: every rank of a process group runs this ``main`` (under
``repro_torch.core.mesh.run_mesh``, as ``run_mesh(rank_main, 256,
args=(argv,))``, or any launcher that starts the ranks and initializes
the group), and rank 0 prints.  Checkpoints hold the state logically
unsharded.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import make_model
from repro_torch.sharding.rules import make_rules
from repro_torch.sharding.strategy import plan_for
from repro_torch.train.loop import (
    checkpoint_template, init_train_state, make_train_step,
    restore_checkpoint, save_checkpoint, state_specs,
)
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation")
    ap.add_argument("--mesh", action="store_true",
                    help="train on the production mesh (run every rank)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = make_model(cfg, remat=not args.reduced, device=args.device)
    if args.mesh:
        mesh = make_production_mesh(device=args.device)
        rules = plan_for(cfg, "train", mesh).rules
    else:
        rules = make_rules(None)
    say = print if not args.mesh or dist.get_rank() == 0 else (
        lambda *a, **k: None)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, rules,
                              microbatches=args.microbatches)

    state = init_train_state(model, seed=args.seed, rules=rules)
    start = 0
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if args.resume and mgr is not None:
        got = restore_checkpoint(mgr, checkpoint_template(state, model),
                                 rules, state_specs(model))
        if got is not None:
            start, state = got
            say(f"resumed from step {start}")

    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)
    metrics = None
    t0 = time.time()
    for i in range(start, args.steps):
        toks, tgt = pipe.batch_at(i)        # deterministic: restart-safe
        state, metrics = step_fn(state, {
            "tokens": torch.from_numpy(toks).to(model.device),
            "targets": torch.from_numpy(tgt).to(model.device)})
        if (i + 1) % 10 == 0 or i == start:
            loss = float(metrics["loss"])   # syncs with the device
            dt = (time.time() - t0) / max(i + 1 - start, 1)
            say(f"step {i + 1:5d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  {dt:.2f}s/step",
                flush=True)
        if mgr is not None and (i + 1) % args.ckpt_every == 0:
            stats = save_checkpoint(mgr, state, i + 1)
            if stats is not None:
                say(f"  checkpoint @ {i + 1}: {stats['blocks_written']} new "
                    f"blocks, {stats['blocks_reused']} reused", flush=True)
    if metrics is None:
        say(f"done: at step {start} of {args.steps}, no step to run")
    else:
        say(f"done: final loss {float(metrics['loss']):.4f}")


def rank_main(mesh, argv) -> None:
    """One rank of a ``--mesh`` run under
    ``repro_torch.core.mesh.run_mesh``: ``main(argv)`` in a rank whose
    process group the launcher started."""
    main(argv)


if __name__ == "__main__":
    main()
