from repro_torch.sharding.rules import ShardingRules, make_rules  # noqa: F401
