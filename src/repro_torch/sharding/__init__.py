from repro_torch.sharding.rules import ShardingRules, make_rules  # noqa: F401
from repro_torch.sharding.strategy import plan_for  # noqa: F401
