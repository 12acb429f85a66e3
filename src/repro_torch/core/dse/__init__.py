"""Design-space exploration: for now the design templates and their
geometry (:mod:`repro_torch.core.dse.sweep`); the sweep itself comes
with the batched timing backend."""
from repro_torch.core.dse.sweep import DEFAULT_DESIGNS, DesignPoint

__all__ = ["DesignPoint", "DEFAULT_DESIGNS"]
