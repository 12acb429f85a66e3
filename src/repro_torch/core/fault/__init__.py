"""Fault-injection and resilience layer.

The paper's algorithmic multi-port memories buy extra ports with
*redundant storage* — NTX parity planes, LVT bank replicas.  This
package measures how much fault tolerance that redundancy buys: it
injects seeded transient bit-flips, stuck-at bits and whole-bank
failures into the flat replay state of every design kind
(:mod:`repro_torch.core.amm.replay`), replays all faults of a campaign
as one batch on the device, and classifies each post-injection read as
benign / corrected / detected / SDC using only the design's own
read-path redundancy (:mod:`repro_torch.core.fault.campaign`).

:func:`attach_resilience` fills the ``res_*`` fields of DSE sweep points
from one campaign per design.
"""
from repro_torch.core.fault.campaign import (CampaignResult, FaultConfig,
                                             attach_resilience,
                                             campaign_draws,
                                             design_resilience,
                                             replay_campaign, run_campaign)
from repro_torch.core.fault.metrics import (COVER, RES_FIELDS, Resilience,
                                            resilience_fields)
from repro_torch.core.fault.model import (FAULT_KINDS, FaultSpec,
                                          build_masks, sample_faults,
                                          state_geometry, tile_states)

__all__ = [
    "FAULT_KINDS", "FaultSpec", "state_geometry", "sample_faults",
    "build_masks", "tile_states",
    "COVER", "RES_FIELDS", "Resilience", "resilience_fields",
    "FaultConfig", "CampaignResult", "campaign_draws", "replay_campaign",
    "run_campaign", "design_resilience", "attach_resilience",
]
