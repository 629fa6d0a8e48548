"""Batched serving example on the PyTorch port: prefill-by-steps + greedy
decode with KV/state caches across three architecture families (attention
/ SSM / hybrid), reduced configs.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

The twin of ``examples/serve_lm.py``; runs on the CUDA card unless
``--device`` names another torch device.  Weights are random, drawn on the
device from a seeded ``torch.Generator``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.serve.engine import ServeSession  # noqa: E402
from repro_torch.sharding.rules import make_rules  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rules = make_rules(None)
    rng = np.random.default_rng(0)
    for arch in ("yi-6b", "rwkv6-1.6b", "zamba2-1.2b"):
        cfg = get_reduced(arch)
        model = make_model(cfg, device=args.device)
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(1))
        batch, prompt_len, gen = 4, 8, 12
        session = ServeSession(model, params, rules, batch=batch,
                               cache_len=prompt_len + gen + 1)
        prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                               dtype=np.int32)
        out = session.generate(prompts, steps=gen)
        assert out.shape == (batch, gen)
        assert (out >= 0).all() and (out < cfg.vocab_size).all()
        print(f"{arch:14s} generated {out.shape}: {out[0].tolist()}")
    print("serve_lm OK")


if __name__ == "__main__":
    main()
