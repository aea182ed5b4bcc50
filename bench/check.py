"""The comparison that decides ``correct`` for a training cell: each checked
step's loss, the first gradient as the optimizer got it and the
parameters' change over the checked steps, each leaf's norm against the
reference's, and the rows the loader handed over against the shard.

A leaf's gap is ``|norm_program - norm_reference|`` over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change."""
from __future__ import annotations

import math
import statistics

QUIET = 1e-3


def leaf_gaps(prog: dict, ref: dict, skip=()) -> dict:
    """Each leaf's gap (infinite where not finite)."""
    floor = statistics.median(ref.values())
    out = {}
    for k, r in ref.items():
        if k in skip:
            continue
        gap = abs(prog[k] - r) / max(r, floor, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def worst_leaf_gap(prog: dict, ref: dict, skip=()) -> tuple:
    """(gap, leaf) of the worst leaf."""
    gaps = leaf_gaps(prog, ref, skip)
    k = max(gaps, key=gaps.get)
    return gaps[k], k


NUMBERS = ("loss", "grad", "change", "rows")


def _gap(a: float, b: float) -> float:
    return abs(a - b) if math.isfinite(a - b) else math.inf


def readings(prog: dict, ref: dict, rows_differ: int) -> dict:
    """The numbers a cell may compare: ``loss`` (the largest gap of a
    checked step's loss, in nats), ``grad`` and ``change`` (worst leaf),
    ``rows`` (ids that differ from the shard's). ``prog`` and ``ref``
    hold ``losses``, ``grad`` and ``change`` as
    :func:`bench.reference.common.train` returns them."""
    floor = statistics.median(ref["grad"].values())
    quiet = {k for k, g in ref["grad"].items() if g < QUIET * floor}
    loss = max(_gap(a, b) for a, b in zip(prog["losses"], ref["losses"]))
    grad, grad_leaf = worst_leaf_gap(prog["grad"], ref["grad"])
    change, change_leaf = worst_leaf_gap(prog["change"], ref["change"], quiet)
    return {"loss": loss, "grad": grad, "change": change,
            "rows": float(rows_differ),
            "_leaves": {"grad": grad_leaf, "change": change_leaf,
                        "quiet": sorted(quiet)}}


def judge(read: dict, limits: dict) -> tuple:
    """(correct, compared) over the numbers the cell's limits name: every
    one at or under its limit; ``compared`` maps each name to its value
    and limit."""
    compared = {k: {"value": read[k], "limit": limits[k]["limit"]}
                for k in NUMBERS if k in limits}
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return ok, compared
