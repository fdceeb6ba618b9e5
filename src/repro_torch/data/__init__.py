from repro_torch.data.pipeline import ShardedLoader, SyntheticLatentDataset

__all__ = ["ShardedLoader", "SyntheticLatentDataset"]
