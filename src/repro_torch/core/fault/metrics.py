"""Resilience metrics: fold a classified fault campaign into one record.

Per-read classification (standard fault-injection taxonomy):

``benign``     the read returned the golden value and no redundant path
               disagreed — the fault was masked for this read.
``corrected``  the raw value a path produced was corrupt, but the
               design's own redundancy recovered the golden value
               (NTX parity-path XOR reconstruction, LVT replica
               majority vote).
``detected``   the redundancy *flagged* the corruption (paths/replicas
               disagree) but could not prove which value is right —
               a detected-unrecoverable error (DUE).
``sdc``        the read returned a wrong value with no disagreement
               anywhere — silent data corruption, the worst outcome.

The aggregate :class:`Resilience` record is what the DSE sweep's points
carry, flattened to the ``res_*`` fields (:func:`resilience_fields`).

A copy of the JAX package's ``core/fault/metrics.py`` (which imports no
JAX); ``tests/test_torch_fault.py`` holds the two equal.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Resilience", "RES_FIELDS", "resilience_fields"]

# cover mechanism per design kind: which redundancy (if any) the
# classifier may use.  b_ntx_wr's Ref unit is *bandwidth* redundancy
# (3 stored planes for 2 logical words, but s0 is unrecoverable without
# s0) and the remap/banked/ideal tables hold no second copy of live
# data, so none of them can detect or correct — measured honestly as
# cover="none".
COVER = {
    "h_ntx_rd": "parity",
    "hb_ntx": "parity",
    "lvt": "replica",
    "b_ntx_wr": "none",
    "remap": "none",
    "banked": "none",
    "ideal": "none",
    "multipump": "none",
}


@dataclasses.dataclass(frozen=True)
class Resilience:
    """Aggregate outcome of one seeded fault campaign on one design.

    ``benign``/``corrected``/``detected``/``sdc`` are read-event totals
    over all ``n_faults`` x ``n_reads`` observations;
    ``det_latency`` is the mean number of cycles from injection to the
    first read that detected (or corrected) the fault, over faults that
    were ever detected (-1.0 when none were).
    """

    cover: str
    n_faults: int
    n_reads: int           # read observations per fault (T x read ports)
    benign: int
    corrected: int
    detected: int
    sdc: int
    det_latency: float

    @property
    def affected(self) -> int:
        return self.corrected + self.detected + self.sdc

    @property
    def sdc_rate(self) -> float:
        return self.sdc / max(self.n_faults * self.n_reads, 1)

    @property
    def corrected_frac(self) -> float:
        return self.corrected / self.affected if self.affected else 0.0

    @property
    def detected_frac(self) -> float:
        return self.detected / self.affected if self.affected else 0.0

    def summary(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(affected=self.affected, sdc_rate=self.sdc_rate,
                 corrected_frac=self.corrected_frac,
                 detected_frac=self.detected_frac)
        return d


# DSEPoint carries the record flattened into these fields (sentinel
# -1.0 / "-" = no campaign attached to the point).
RES_FIELDS = ("res_cover", "res_sdc_rate", "res_corrected", "res_detected",
              "res_latency")


def resilience_fields(r: Resilience) -> dict:
    """The ``DSEPoint`` field values for one record."""
    return {
        "res_cover": r.cover,
        "res_sdc_rate": r.sdc_rate,
        "res_corrected": r.corrected_frac,
        "res_detected": r.detected_frac,
        "res_latency": r.det_latency,
    }
