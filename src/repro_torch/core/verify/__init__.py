"""Independent schedule-legality checking (copy of the JAX package's
``core/verify/__init__.py``, fed by the port's batched timing backend).

``check_schedule(trace, cfg)`` runs ``schedule_batched`` with event
logging on (the ``cycle_lanes`` kernel on the card, its plain version on
the CPU), replays the paper's arbitration legality rules over the
recorded per-cycle issue events
(:mod:`repro_torch.core.verify.invariants`), and asserts the static
hazard certificates (:mod:`repro_torch.core.verify.static_bounds`)
against the measured cycle count.  The checker re-derives all geometry
from the AMMSpec (:mod:`repro_torch.core.verify.geometry`) and shares no
arbitration code with ``repro_torch.core.sim`` — a bug in the kernel or
its plain version shows up as a :class:`Violation` here instead of being
silently reproduced.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sim.events import EventLog
from repro_torch.core.sim.prepared import PreparedTrace, prepare_trace
from repro_torch.core.verify.geometry import ArrayRules, compile_rules
from repro_torch.core.verify.invariants import (RULE_CLASSES, Violation,
                                                verify_events)
from repro_torch.core.verify.static_bounds import (BOUND_KINDS,
                                                   check_bounds,
                                                   static_bounds)

__all__ = [
    "ArrayRules", "BOUND_KINDS", "CheckReport", "LegalityError",
    "RULE_CLASSES", "Violation", "check_schedule", "check_bounds",
    "compile_rules", "static_bounds", "verify_events", "verify_result",
]


class LegalityError(AssertionError):
    """A schedule violated a legality rule or a static lower bound."""

    def __init__(self, report: "CheckReport") -> None:
        self.report = report
        lines = [f"{len(report.violations)} legality violation(s) "
                 f"(backend={report.backend}):"]
        lines += [f"  - {v}" for v in report.violations[:20]]
        if len(report.violations) > 20:
            lines.append(f"  ... {len(report.violations) - 20} more")
        super().__init__("\n".join(lines))


@dataclasses.dataclass
class CheckReport:
    """Everything one legality check produced."""

    result: "object"                    # the ScheduleResult
    events: EventLog
    violations: "list[Violation]"
    bounds: "dict[str, int]"            # static lower bounds, per kind
    backend: str

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_failed(self) -> None:
        if self.violations:
            raise LegalityError(self)


def verify_result(pt: PreparedTrace, cfg, res, events: EventLog,
                  backend: str = "?") -> CheckReport:
    """Check an already-run schedule's events + counters + bounds."""
    violations = verify_events(pt, cfg, res, events)
    bounds = static_bounds(pt, cfg)
    for kind, bound in sorted(bounds.items()):
        if res.cycles < bound:
            violations.append(Violation(
                "static_bound",
                f"measured {res.cycles} cycles is below the provable "
                f"{kind} lower bound of {bound}"))
    return CheckReport(result=res, events=events, violations=violations,
                       bounds=bounds, backend=backend)


def check_schedule(tr, cfg, *, device=None) -> CheckReport:
    """Schedule ``tr`` under ``cfg`` with event logging and validate.

    ``tr`` may be a Trace or an already-prepared PreparedTrace.  The
    schedule is ``core.sim.schedule_events``: ``device=None`` runs the
    ``cycle_lanes`` kernel on the CUDA device, ``device="cpu"`` its
    plain version; the report's ``backend`` names the device.  Returns the :class:`CheckReport`;
    callers that want an exception on failure use
    ``report.raise_if_failed()``.
    """
    from repro_torch.core.sim.scheduler import schedule_events
    from repro_torch.device import resolve_device

    pt = prepare_trace(tr)
    dev = resolve_device(device)
    res, events = schedule_events(pt, cfg, device=dev)
    return verify_result(pt, cfg, res, events, backend=str(dev))
