from repro_torch.models.common import DTypePolicy, count_params
from repro_torch.models.lm import (attn_config, decode_step, embed_tokens,
                                   forward, init_model, loss_fn, make_cache,
                                   moe_config, prefill, ssm_config)

__all__ = [
    "DTypePolicy", "count_params", "init_model", "embed_tokens", "forward",
    "loss_fn", "make_cache", "prefill", "decode_step", "attn_config",
    "moe_config", "ssm_config",
]
