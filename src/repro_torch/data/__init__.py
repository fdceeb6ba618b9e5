from repro_torch.data.pipeline import (ShardedLoader, SyntheticLatentDataset,
                                       SyntheticTokenDataset)

__all__ = ["ShardedLoader", "SyntheticLatentDataset", "SyntheticTokenDataset"]
