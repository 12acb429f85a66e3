from repro_torch.memory.embedding import banked_embedding_lookup
from repro_torch.memory.kv_cache import BankedKVCache
from repro_torch.memory.planner import (AMM_LOCALITY_THRESHOLD, MemoryPlan,
                                        StreamPlan, plan_memory)

__all__ = ["plan_memory", "MemoryPlan", "StreamPlan",
           "AMM_LOCALITY_THRESHOLD", "banked_embedding_lookup",
           "BankedKVCache"]
