from repro_torch.data.pipeline import (DataConfig, ShardedSyntheticDataset,
                                       mix_datasets)

__all__ = ["DataConfig", "ShardedSyntheticDataset", "mix_datasets"]
