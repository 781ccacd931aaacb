"""Multi-GPU scale-out on torch.distributed (sharding, multihost)."""
