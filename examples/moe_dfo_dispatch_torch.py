"""The paper's technique as an LM feature: MoE token dispatch as DFOGraph
filtered push (DESIGN.md §3) — the port's twin of
``examples/moe_dfo_dispatch.py``.  It runs on a ('data', 'model') = (2, 4)
device mesh of 8 gloo ranks (sharing one card, or on the CPU with
``--device cpu``), with the tokens over 'data' and the experts' weights
and capacity buffers over 'model' (expert parallelism), counts the
collectives DTensor issues with ``CommDebugMode`` (where the reference
counts them in the compiled HLO), and shows the capacity ("need list")
bound in action.

    PYTHONPATH=src python examples/moe_dfo_dispatch_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import run_mesh  # noqa: E402
from repro_torch.core.sparse_collectives import (  # noqa: E402
    dense_combine, dense_dispatch, topk_routing,
)

MESH = ((2, 4), ("data", "model"))
T, D, E, K = 64, 32, 8, 2
CAP = int(1.25 * T * K / E)


def make_inputs(seed: int = 0):
    """Tokens [T, D], router [D, E], expert weights [E, D, 4D] and
    [E, 4D, D] (the reference's scales; numpy draws from ``seed``)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (normal((T, D), 1.0), normal((D, E), 0.3),
            normal((E, D, 4 * D), D ** -0.5),
            normal((E, 4 * D, D), (4 * D) ** -0.5))


def _rank(pm, x, router, w_up, w_dn):
    """One rank: the arrays placed as the reference's ``in_shardings``, the
    routing and the dispatch scatter on every rank's replica of the
    tokens, the expert FFN on this rank's experts, the combine gather on
    the replica of the expert outputs.  Rank 0 returns the output, the
    kept (token, choice) pairs and the collective counts."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding.rules import local_replica, make_rules
    mesh = make_device_mesh(*MESH, device=pm.device)
    rules = make_rules(mesh)
    dev = pm.device

    def put(a, *axes):
        return rules.shard(torch.from_numpy(a).to(dev), *axes)

    xs = put(x, "batch", None)                       # tokens over 'data'
    rs = put(router, None, None)
    up, dn = put(w_up, "experts", None, None), put(w_dn, "experts", None,
                                                  None)
    with torch.no_grad(), CommDebugMode() as comm:
        xl = local_replica(xs)
        logits = xl @ local_replica(rs)
        dispatch, idx, pos, wts, _ = topk_routing(logits, K, CAP)
        buf = dense_dispatch(xl, dispatch, idx, pos, E, CAP)      # push
        buf = rules.shard(buf, "experts", None, None)             # EP shards
        h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", buf, up))
        o = torch.einsum("ecf,efd->ecd", h, dn)
        out = dense_combine(local_replica(o), dispatch, idx, pos, wts, T)
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    if pm.rank != 0:
        return None
    return out.cpu().numpy(), int(dispatch.sum()), counts


def run(x, router, w_up, w_dn, device=None):
    """(output [T, D], kept pairs, collective counts) of the mesh job."""
    world = MESH[0][0] * MESH[0][1]
    return run_mesh(_rank, world, args=(x, router, w_up, w_dn),
                    device=device, timeout_s=600)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default: the card)")
    args = ap.parse_args(argv)
    out, kept, counts = run(*make_inputs(0), device=args.device)
    print(f"tokens={T} experts={E} top_k={K} capacity/expert={CAP}")
    print(f"kept (token,choice) pairs: {kept} / {T * K} "
          f"(dropped over capacity = paper's bounded message buffers)")
    print("collectives (CommDebugMode): " + ", ".join(
        f"{k} x{v}" for k, v in sorted(counts.items()))
        + " (the DFO inter-node pass on the 'model' axis)")
    print(f"output shape {out.shape}, finite={bool(np.isfinite(out).all())}")
    print("moe_dfo_dispatch OK")


if __name__ == "__main__":
    main()
