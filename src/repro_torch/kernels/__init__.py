from repro_torch.kernels.ops import (amm_gather, kv_decode,
                                     pack_amm_banks, ssd_chunk)

__all__ = ["amm_gather", "kv_decode", "pack_amm_banks", "ssd_chunk"]
