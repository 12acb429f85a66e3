from repro_torch.data.pipeline import (DataConfig, PrefetchLoader,
                                       SyntheticCorpus)

__all__ = ["DataConfig", "SyntheticCorpus", "PrefetchLoader"]
