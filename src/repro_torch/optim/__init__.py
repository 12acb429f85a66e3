from repro_torch.optim.adamw import (AdamWConfig, cosine_lr, global_norm,
                                     init, update)

__all__ = ["AdamWConfig", "init", "update", "cosine_lr", "global_norm"]
