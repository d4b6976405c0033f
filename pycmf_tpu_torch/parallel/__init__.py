"""Sharded CMF on torch.distributed: one process per shard."""
