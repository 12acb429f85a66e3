from repro_torch.models.common import DTypePolicy, count_params
from repro_torch.models.lm import (decode_step, embed_tokens, forward,
                                   init_model, make_cache, prefill,
                                   ssm_config)

__all__ = [
    "DTypePolicy", "count_params", "init_model", "embed_tokens", "forward",
    "make_cache", "prefill", "decode_step", "ssm_config",
]
