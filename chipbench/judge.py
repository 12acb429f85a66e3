"""The comparison that decides ``correct``: the program's sweep against
the reference sweep of the same seed.

One number is compared, ``mismatches``, with the limit 0.  It counts:

* grid points the program returned that are not in the grid, or twice;
* in an exhaustive sweep, grid points it did not return;
* returned points whose schedule differs from the reference's (cycles,
  each of the three stall counts) or whose average memory parallelism
  or costs (cycle time, run time, area, power) differ from the
  reference's by more than ``REL_TOL`` of the reference's value;
* members of each Pareto front the sweep was reduced to that are not on
  the reference's front of the whole grid, and reference members
  missing from it (a pruned sweep must keep the exact time/area front);
* sweeps of the window whose points or fronts differ from the judged
  one's.

The float fields are ratios and sums of the schedule's integers in
float64: a sound program computes them bit for bit as the reference
does (its readings are 0.0), while one cycle more or less in a schedule
of at most 10**6 cycles moves the run time by at least 1e-6 of it.
``REL_TOL`` sits between, so that a sound change of summation order
passes and a changed schedule does not.
"""
from __future__ import annotations

from chipbench.reference.model import pareto

INT_FIELDS = ("cycles", "bank_conflict_stalls", "parity_fanout_stalls",
              "write_pair_stalls")
FLOAT_FIELDS = ("avg_mem_parallelism", "cycle_ns", "time_us", "area_mm2",
                "power_mw")
REL_TOL = 1e-9
LIMITS = {"mismatches": 0}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def judge(points: "list[dict]", fronts: "dict[str, list]",
          ref: "list[dict]", *, exhaustive: bool,
          sweeps_differing: int) -> dict:
    """Compare a sweep's ``points`` (dicts with the fields above and
    ``design``/``unroll``) and ``fronts`` (cost field -> the (design,
    unroll) on the time/cost front) with the reference's grid.  Returns
    the compared numbers and, for the record, their parts."""
    by_key = {(p["design"], p["unroll"]): p for p in ref}
    seen: set = set()
    extra = dup = wrong = 0
    worst = 0.0
    for p in points:
        key = (p["design"], p["unroll"])
        r = by_key.get(key)
        if r is None:
            extra += 1
            continue
        if key in seen:
            dup += 1
            continue
        seen.add(key)
        errs = [_rel(float(p[f]), float(r[f])) for f in FLOAT_FIELDS]
        worst = max([worst] + errs)
        if any(p[f] != r[f] for f in INT_FIELDS) or max(errs) > REL_TOL:
            wrong += 1
    missing = len(by_key) - len(seen) if exhaustive else 0
    front = 0
    for cost, got in fronts.items():
        front += len({tuple(x) for x in got} ^ set(pareto(ref, cost)))
    parts = {"extra": extra, "duplicate": dup, "missing": missing,
             "wrong": wrong, "front": front,
             "sweeps_differing": sweeps_differing,
             "worst_rel_err": worst}
    total = extra + dup + missing + wrong + front + sweeps_differing
    return {"numbers": {"mismatches": total}, "parts": parts}


def passes(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
