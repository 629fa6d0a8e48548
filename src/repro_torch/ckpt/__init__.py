from repro_torch.ckpt.blockstore import BlockStore, CheckpointManager  # noqa: F401
