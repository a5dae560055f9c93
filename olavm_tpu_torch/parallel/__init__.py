"""Multi-GPU proving on torch.distributed (parallel/sharded.py)."""
