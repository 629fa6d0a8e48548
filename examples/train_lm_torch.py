"""End-to-end LM training example on the PyTorch port: trains a small
llama-family model for a few hundred steps on the synthetic bigram
pipeline, with a checkpoint and a simulated restart half way, and checks
that the loss drops.

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]

The twin of ``examples/train_lm.py``; runs on the CUDA card unless
``--device`` names another torch device.  Weights are random, drawn on the
device from a seeded ``torch.Generator``.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.sharding.rules import make_rules  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    checkpoint_template, init_train_state, make_train_step,
)
from repro_torch.train.optimizer import OptConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    model = make_model(cfg, device=args.device)
    rules = make_rules(None)
    opt = OptConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(model, opt, rules)
    pipe = TokenPipeline(cfg.vocab_size, seq_len=32, global_batch=8, seed=0)

    def batch(i):
        toks, tgt = pipe.batch_at(i)
        return {"tokens": torch.from_numpy(toks).to(model.device),
                "targets": torch.from_numpy(tgt).to(model.device)}

    state = init_train_state(model, seed=0)
    losses = []
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        half = args.steps // 2
        for i in range(half):
            state, m = step_fn(state, batch(i))
            losses.append(float(m["loss"]))
            if (i + 1) % 20 == 0:
                print(f"step {i+1:4d} loss {losses[-1]:.4f}", flush=True)
        mgr.save(state, step=half)
        print(f"-- checkpoint at step {half}; simulating restart --")

        # restart from scratch, restore, continue
        state2 = init_train_state(model, seed=0)
        got_step, state2 = mgr.restore_into(
            checkpoint_template(state2, model))
        for i in range(got_step, args.steps):
            state2, m = step_fn(state2, batch(i))
            losses.append(float(m["loss"]))
            if (i + 1) % 20 == 0:
                print(f"step {i+1:4d} loss {losses[-1]:.4f}", flush=True)

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"mean loss first 10 steps: {first:.4f} -> last 10: {last:.4f}")
    assert last < first - 0.3, "loss did not decrease"
    print("train_lm OK")


if __name__ == "__main__":
    main()
