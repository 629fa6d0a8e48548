"""Process-mode runtime of the port: fault injection, the per-rank worker
entry point, worker recovery planning and straggler deferral."""
from repro_torch.runtime.elastic import (  # noqa: F401
    plan_elastic_mesh, plan_worker_recovery,
)
from repro_torch.runtime.straggler import (  # noqa: F401
    DeferralPolicy, deferred_merge, merge_deferred_entry, plan_backup_shards,
    simulate_round,
)
