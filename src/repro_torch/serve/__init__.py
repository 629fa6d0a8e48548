from repro_torch.serve.engine import (  # noqa: F401
    make_serve_step, make_prefill_and_decode, greedy_sample, topk_sample,
    ServeSession,
)
