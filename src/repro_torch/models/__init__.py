from repro_torch.models.config import (  # noqa: F401
    AttnSpec, ModelConfig, MoESpec, RWKVSpec, SSMSpec,
)
